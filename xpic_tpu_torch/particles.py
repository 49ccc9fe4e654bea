"""Fixed-capacity structure-of-arrays particle storage
(counterpart of ``xpic_tpu/particles.py``).

A species is three tensors of static capacity: ``r`` [C, 3] positions,
``p`` [C, 3] velocities (non-relativistic, in units of c) and ``alive``
[C] bool.  Capacity grows in buckets on the host, between steps
(:func:`append`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import PERIODIC, REFLECTIVE, Geometry, SortParameters
from .parallel.mesh import z0_of, nz_global_of


@dataclasses.dataclass
class ParticleArrays:
    """One species' dynamic state."""

    r: torch.Tensor  # [C, 3] float
    p: torch.Tensor  # [C, 3] float
    alive: torch.Tensor  # [C] bool

    @property
    def capacity(self) -> int:
        return self.r.shape[0]

    def count(self) -> torch.Tensor:
        return torch.sum(self.alive)


def make_empty(capacity: int, dtype=torch.float64, device=None
               ) -> ParticleArrays:
    return ParticleArrays(
        r=torch.zeros((capacity, 3), dtype=dtype, device=device),
        p=torch.zeros((capacity, 3), dtype=dtype, device=device),
        alive=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )


def round_capacity(n: int, bucket: int = 256) -> int:
    """Round a particle count up to a capacity bucket (>= 1 bucket)."""
    return max(bucket, ((n + bucket - 1) // bucket) * bucket)


def from_numpy(r: np.ndarray, p: np.ndarray, capacity: int | None = None,
               dtype=torch.float64, device=None) -> ParticleArrays:
    """Pack host-side particle data into a padded ParticleArrays."""
    n = r.shape[0]
    cap = capacity if capacity is not None else round_capacity(n)
    rj = np.zeros((cap, 3), dtype=np.float64)
    pj = np.zeros((cap, 3), dtype=np.float64)
    alive = np.zeros((cap,), dtype=bool)
    rj[:n] = r
    pj[:n] = p
    alive[:n] = True
    return ParticleArrays(
        r=torch.tensor(rj, dtype=dtype, device=device),
        p=torch.tensor(pj, dtype=dtype, device=device),
        alive=torch.tensor(alive, device=device),
    )


def append(sp: ParticleArrays, r: np.ndarray, p: np.ndarray,
           bucket: int = 256) -> ParticleArrays:
    """Host-side append of new particles (used by SetParticles).  Fills
    dead slots first; grows capacity by whole buckets only when needed."""
    alive = sp.alive.cpu().numpy().copy()
    r_old = sp.r.cpu().numpy().copy()
    p_old = sp.p.cpu().numpy().copy()
    n_new = r.shape[0]
    free = np.flatnonzero(~alive)
    use = min(len(free), n_new)
    if use:
        idx = free[:use]
        r_old[idx] = r[:use]
        p_old[idx] = p[:use]
        alive[idx] = True
    rest = n_new - use
    if rest > 0:
        old_cap = alive.shape[0]
        cap = round_capacity(old_cap + rest, bucket)
        grow = cap - old_cap
        r_old = np.concatenate([r_old, np.zeros((grow, 3))])
        p_old = np.concatenate([p_old, np.zeros((grow, 3))])
        alive = np.concatenate([alive, np.zeros((grow,), dtype=bool)])
        r_old[old_cap : old_cap + rest] = r[use:]
        p_old[old_cap : old_cap + rest] = p[use:]
        alive[old_cap : old_cap + rest] = True
    dtype, device = sp.r.dtype, sp.r.device
    return ParticleArrays(
        r=torch.tensor(r_old, dtype=dtype, device=device),
        p=torch.tensor(p_old, dtype=dtype, device=device),
        alive=torch.tensor(alive, device=device),
    )


def cell_coords(r: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """Integer cell coordinates [C, 3] (x, y, z) via floor(r / d)."""
    d = torch.tensor([geom.dx, geom.dy, geom.dz], dtype=r.dtype,
                     device=r.device)
    return torch.floor(r / d).to(torch.int32)


def cell_ids(sp: ParticleArrays, geom: Geometry) -> torch.Tensor:
    """Flat cell id (z * ny + y) * nx + x per particle; dead particles
    map to the overflow segment ``n_cells``.  On a z slab the id is the
    slab's, and a particle outside the slab counts as dead."""
    c = cell_coords(sp.r, geom)
    cx = torch.clamp(c[:, 0], 0, geom.nx - 1)
    cy = torch.clamp(c[:, 1], 0, geom.ny - 1)
    cz = torch.clamp(c[:, 2], 0, nz_global_of(geom) - 1) - z0_of(geom)
    alive = sp.alive & (cz >= 0) & (cz < geom.nz)
    flat = (cz * geom.ny + cy) * geom.nx + cx
    return torch.where(alive, flat,
                       torch.full_like(flat, geom.n_cells)).to(torch.int32)


def in_slab(r: np.ndarray, geom: Geometry, dtype) -> np.ndarray:
    """Host mask of the positions ``r`` [N, 3] (physical units) whose
    cell lies in the z slab of ``geom``, by :func:`cell_ids`'s rule in
    ``dtype``."""
    z = torch.as_tensor(np.ascontiguousarray(r[:, 2])).to(dtype)
    cz = torch.clamp(torch.floor(z / geom.dz).to(torch.int64), 0,
                     nz_global_of(geom) - 1) - z0_of(geom)
    return ((cz >= 0) & (cz < geom.nz)).numpy()


def sort_by_cell(sp: ParticleArrays, geom: Geometry) -> ParticleArrays:
    """Stable sort of the species by flat cell id (dead slots sink to the
    end).  A stable sort on the id alone orders exactly as the JAX
    package's (id, index)-keyed sort."""
    ids = cell_ids(sp, geom)
    _, perm = torch.sort(ids, stable=True)
    return ParticleArrays(r=sp.r[perm], p=sp.p[perm], alive=sp.alive[perm])


def apply_boundaries(sp: ParticleArrays, geom: Geometry) -> ParticleArrays:
    """Apply the global coordinate boundaries to all particles: periodic
    axes wrap by one period, reflective axes clamp to the wall and flip
    that momentum component, other kinds mark the particle dead."""
    dev, dtype = sp.r.device, sp.r.dtype
    L = torch.tensor(geom.L, dtype=dtype, device=dev)
    r = sp.r
    per = torch.tensor([b == PERIODIC for b in geom.bounds], device=dev)
    refl = torch.tensor([b == REFLECTIVE for b in geom.bounds], device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    r_wrapped = torch.where(r < 0.0, r + L, torch.where(r > L, r - L, r))
    r_wrapped = torch.minimum(torch.maximum(r_wrapped, zero), L)
    out = (r < 0.0) | (r > L)
    r_new = torch.where(per, r_wrapped, torch.minimum(torch.maximum(r, zero),
                                                      L))
    p_new = torch.where(refl & out, -sp.p, sp.p)
    dead = torch.any(out & ~per & ~refl, dim=1)
    return ParticleArrays(r=r_new, p=p_new, alive=sp.alive & ~dead)


def kinetic_energy(sp: ParticleArrays, params: SortParameters
                   ) -> torch.Tensor:
    """Total kinetic energy 0.5 * m * mpw * sum p^2 (0-d tensor)."""
    w = torch.where(sp.alive, torch.sum(sp.p * sp.p, dim=1),
                    torch.zeros((), dtype=sp.p.dtype, device=sp.p.device))
    return 0.5 * params.m * params.n_Np * torch.sum(w)
