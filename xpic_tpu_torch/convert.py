"""Carry state between numpy and the port's tensors.

Tests and scripts make their inputs with numpy from a seed, hand the
same arrays to the JAX package and to the port, and compare the outputs
as numpy arrays.  :func:`split_state` and :func:`join_state` carry a
global state to and from the z slabs of a run over ranks
(``parallel/mesh.py``).
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


def split_state(world: int, *, fields=(), binned=None, flat=None,
                geom=None, dtype=None) -> list[dict]:
    """A global numpy state as ``world`` z slabs, one dict a rank:
    ``fields`` (arrays [..., nz, ny, nx]) split along z; ``binned``
    (r, p [G, K, 3], valid [G, K], z-major cells) split along G; ``flat``
    (r [N, 3] physical, p, alive [N]) split by each particle's cell under
    ``geom`` (the global geometry) in ``dtype``, order kept."""
    from .particles import in_slab

    parts = [{"fields": [np.split(np.asarray(F), world, axis=-3)[r]
                         for F in fields]} for r in range(world)]
    if binned is not None:
        pieces = [np.split(np.asarray(a), world, axis=0) for a in binned]
        for r in range(world):
            parts[r]["binned"] = tuple(p[r] for p in pieces)
    if flat is not None:
        r_all = np.asarray(flat[0])
        for r in range(world):
            g = dataclasses.replace(geom, nz=geom.nz // world,
                                    z0=r * (geom.nz // world),
                                    nz_global=geom.nz)
            keep = in_slab(r_all, g, dtype) & np.asarray(flat[2], bool)
            parts[r]["flat"] = tuple(np.asarray(a)[keep] for a in flat)
    return parts


def join_state(parts: list[dict]) -> dict:
    """The inverse of :func:`split_state` for fields and binned states:
    the slabs joined in rank order."""
    out = {"fields": [np.concatenate(fs, axis=-3)
                      for fs in zip(*(p["fields"] for p in parts))]}
    if "binned" in parts[0]:
        out["binned"] = tuple(np.concatenate(a, axis=0)
                              for a in zip(*(p["binned"] for p in parts)))
    return out
