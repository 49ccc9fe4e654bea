"""Fixed-capacity structure-of-arrays particle storage
(counterpart of ``xpic_tpu/particles.py``).

A species is three tensors of static capacity: ``r`` [C, 3] positions,
``p`` [C, 3] velocities (non-relativistic, in units of c) and ``alive``
[C] bool.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import Geometry


@dataclasses.dataclass
class ParticleArrays:
    """One species' dynamic state."""

    r: torch.Tensor  # [C, 3] float
    p: torch.Tensor  # [C, 3] float
    alive: torch.Tensor  # [C] bool


def cell_coords(r: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """Integer cell coordinates [C, 3] (x, y, z) via floor(r / d)."""
    d = torch.tensor([geom.dx, geom.dy, geom.dz], dtype=r.dtype,
                     device=r.device)
    return torch.floor(r / d).to(torch.int32)


def cell_ids(sp: ParticleArrays, geom: Geometry) -> torch.Tensor:
    """Flat cell id (z * ny + y) * nx + x per particle; dead particles
    map to the overflow segment ``n_cells``."""
    c = cell_coords(sp.r, geom)
    cx = torch.clamp(c[:, 0], 0, geom.nx - 1)
    cy = torch.clamp(c[:, 1], 0, geom.ny - 1)
    cz = torch.clamp(c[:, 2], 0, geom.nz - 1)
    flat = (cz * geom.ny + cy) * geom.nx + cx
    return torch.where(sp.alive, flat,
                       torch.full_like(flat, geom.n_cells)).to(torch.int32)


def sort_by_cell(sp: ParticleArrays, geom: Geometry) -> ParticleArrays:
    """Stable sort of the species by flat cell id (dead slots sink to the
    end).  A stable sort on the id alone orders exactly as the JAX
    package's (id, index)-keyed sort."""
    ids = cell_ids(sp, geom)
    _, perm = torch.sort(ids, stable=True)
    return ParticleArrays(r=sp.r[perm], p=sp.p[perm], alive=sp.alive[perm])
