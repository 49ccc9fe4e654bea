"""The ECSIM 12-slot layout per field component
(counterpart of ``xpic_tpu/ops/ecsim_blocks.py``, the slot tables and
their gather/scatter only; the assembled mass-block route is not part of
the port yet).

Slot layouts:
  component X: slot (k*2 + j)*3 + sx -> offset (z+k, y+j, x+sx-1)
  component Y: slot (k*3 + sy)*2 + i -> offset (z+k, y+sy-1, x+i)
  component Z: slot (sz*2 + j)*2 + i -> offset (z+sz-1, y+j, x+i)
"""

from __future__ import annotations

import torch

from ..config import Geometry
from .gather_scatter import _unroll_back, rolled_flat

# Static slot -> (dz, dy, dx) offset tables per component.
OFFSETS = (
    tuple((k, j, sx - 1) for k in (0, 1) for j in (0, 1) for sx in (0, 1, 2)),
    tuple((k, sy - 1, i) for k in (0, 1) for sy in (0, 1, 2) for i in (0, 1)),
    tuple((sz - 1, j, i) for sz in (0, 1, 2) for j in (0, 1) for i in (0, 1)),
)


def deposit_slot_sums(Islot, geom: Geometry):
    """Scatter slot-summed values [G, 3, 12] onto the grid
    [3, nz, ny, nx] as 36 shifted whole-grid adds in a fixed order."""
    comps = []
    for c in range(3):
        acc = None
        for s in range(12):
            contrib = _unroll_back(
                Islot[:, c, s].reshape(geom.shape), OFFSETS[c][s],
                geom.bounds)
            acc = contrib if acc is None else acc + contrib
        comps.append(acc)
    return torch.stack(comps)


def gather_slots(F, geom: Geometry):
    """Gather the 12 slot values per component per cell: [G, 3, 12]."""
    cols = []
    for c in range(3):
        cols.append(torch.stack(
            [rolled_flat(F[c], OFFSETS[c][s], geom.bounds)
             for s in range(12)], dim=-1))
    return torch.stack(cols, dim=-2)
