"""Carry state between numpy and the port's tensors.

Tests and scripts make their inputs with numpy from a seed, hand the
same arrays to the JAX package and to the port, and compare the outputs
as numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops.binning import BinnedState
from .particles import ParticleArrays


def state_from_numpy(E, B, B0, r, p, alive, *, device, dtype):
    """Fields [3, nz, ny, nx] and a flat species (r, p [N, 3], alive [N])
    as port tensors: ``(E, B, B0, ParticleArrays)``."""
    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    sp = ParticleArrays(
        r=t(r), p=t(p),
        alive=torch.tensor(np.asarray(alive, dtype=bool), device=device))
    return t(E), t(B), t(B0), sp


def binned_from_numpy(r, p, valid, *, device) -> BinnedState:
    """A binned state (r, p [G, K, 3] in grid units, valid [G, K]) in the
    dtype of ``r``."""
    r = np.asarray(r)
    return BinnedState(
        r=torch.tensor(r, device=device),
        p=torch.tensor(np.asarray(p, dtype=r.dtype), device=device),
        valid=torch.tensor(np.asarray(valid, dtype=bool), device=device),
    )


def to_numpy(x):
    """Tensors, port dataclasses and tuples/lists of them -> numpy."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return type(x)(**{f.name: to_numpy(getattr(x, f.name))
                          for f in dataclasses.fields(x)})
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    return x
