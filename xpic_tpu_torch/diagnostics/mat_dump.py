"""MatDump: binary dump/compare of the ECSIM mass-matrix blocks
(a copy of ``xpic_tpu/diagnostics/mat_dump.py``).

Counterpart of src/diagnostics/mat_dump.{h,cpp} (standalone in the
reference too).  The block layout [G, 3, 12, 3, 12] plus the static
offset tables (ops/ecsim_blocks.OFFSETS) fully determine the sparse
matrix, so dump/compare operates on the dense block array directly: the
assembled route's L (``parallel.step.fill_phase`` with ``mass="blocks"``),
a tensor on any device or a numpy array.
"""

from __future__ import annotations

import numpy as np


def _numpy(L) -> np.ndarray:
    if hasattr(L, "detach"):
        return L.detach().cpu().numpy()
    return np.asarray(L)


def dump(path: str, L) -> None:
    np.save(path, _numpy(L))


def load(path: str) -> np.ndarray:
    return np.load(path)


def compare(path: str, L, rtol: float = 1e-12, atol: float = 1e-12) -> bool:
    ref = load(path)
    cur = _numpy(L)
    return ref.shape == cur.shape and bool(
        np.allclose(ref, cur, rtol=rtol, atol=atol)
    )
