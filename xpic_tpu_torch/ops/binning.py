"""Persistent cell-binned particle state and its per-step migration
(counterpart of ``xpic_tpu/ops/binning.py``).

A species lives in a padded ``[G, K]`` view (G cells, K slots per cell)
across steps.  Every gather and deposit then runs as dense arithmetic
over that view with cell-anchored stencil windows; no atomic scatter.

Migration: float32 states take the dimension-split neighbor exchange
(``ops/neighbor_rebin.py``), guarded by an exact check that routes a
step it cannot route losslessly to the global sort; other dtypes take
the global sort, as the JAX package's default does.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import PERIODIC, REFLECTIVE, Geometry
from ..particles import ParticleArrays, cell_ids, sort_by_cell


@dataclasses.dataclass
class BinnedState:
    """Persistent cell-binned species state.

    ``r`` is the position in grid units (x/dx, y/dy, z/dz), so that
    ``floor(r)`` is the cell and ``r - cell`` the spline offset;
    ``valid`` masks live slots.  Invalid slots hold the owning cell's
    center and zero velocity.
    """

    r: torch.Tensor  # [G, K, 3]
    p: torch.Tensor  # [G, K, 3]
    valid: torch.Tensor  # [G, K] bool


def _arange(n, like):
    return torch.arange(n, dtype=torch.int64, device=like.device)


def _cell_centers(geom: Geometry, dtype, device=None) -> torch.Tensor:
    g = torch.arange(geom.n_cells, dtype=torch.int64, device=device)
    return torch.stack(
        [
            (g % geom.nx).to(dtype) + 0.5,
            ((g // geom.nx) % geom.ny).to(dtype) + 0.5,
            (g // (geom.nx * geom.ny)).to(dtype) + 0.5,
        ],
        dim=-1,
    )[:, None, :]


def state_cell_ids(st: BinnedState, geom: Geometry) -> torch.Tensor:
    """Flat cell id per slot from the current positions (dead -> G)."""
    c = torch.floor(st.r).to(torch.int64)
    cx = torch.clamp(c[..., 0], 0, geom.nx - 1)
    cy = torch.clamp(c[..., 1], 0, geom.ny - 1)
    cz = torch.clamp(c[..., 2], 0, geom.nz - 1)
    flat = (cz * geom.ny + cy) * geom.nx + cx
    return torch.where(st.valid, flat, torch.full_like(flat, geom.n_cells))


def max_per_cell(sp: ParticleArrays, geom: Geometry) -> int:
    """Host-side: the maximum particle count of any cell (for choosing
    K); one device-to-host read."""
    ids = cell_ids(sp, geom).to(torch.int64)
    ids = ids[ids < geom.n_cells]
    if ids.numel() == 0:
        return 0
    return int(torch.bincount(ids, minlength=geom.n_cells).max())


def choose_slots(k_max: int, pad: int = 8) -> int:
    """Round the per-cell capacity up to a multiple of ``pad``."""
    return max(pad, ((k_max + pad - 1) // pad) * pad)


def bin_sorted(sp: ParticleArrays, geom: Geometry, slots: int
               ) -> BinnedState:
    """The padded view of a cell-sorted species: slot k of cell g holds
    the particle at flat index seg[g] + k when that is still in cell g."""
    n = sp.r.shape[0]
    ids = cell_ids(sp, geom).to(torch.int64)  # sorted; dead -> n_cells
    G = geom.n_cells
    seg = torch.searchsorted(ids, _arange(G + 1, ids))
    k = _arange(slots, ids)[None, :]
    pos = seg[:G, None] + k
    valid = pos < seg[1:, None]
    index = torch.clamp(pos, max=n - 1)

    d = torch.tensor([geom.dx, geom.dy, geom.dz], dtype=sp.r.dtype,
                     device=sp.r.device)
    rp = torch.cat([sp.r / d, sp.p], dim=1)[index]
    r, p = rp[..., :3], rp[..., 3:]
    center = _cell_centers(geom, sp.r.dtype, sp.r.device)
    r = torch.where(valid[..., None], r, center)
    p = torch.where(valid[..., None], p, torch.zeros_like(p))
    return BinnedState(r=r, p=p, valid=valid)


def bin_state(sp: ParticleArrays, geom: Geometry, slots: int
              ) -> BinnedState:
    """Initial conversion flat -> persistent binned."""
    return bin_sorted(sort_by_cell(sp, geom), geom, slots)


def unbin_state(st: BinnedState, geom: Geometry) -> ParticleArrays:
    """Flatten the binned state to a [G*K]-capacity flat species view in
    physical coordinates (dead padding masked by ``alive``)."""
    G, K = st.valid.shape
    d = torch.tensor(geom.cell_steps, dtype=st.r.dtype, device=st.r.device)
    return ParticleArrays(
        r=(st.r * d).reshape(G * K, 3),
        p=st.p.reshape(G * K, 3),
        alive=st.valid.reshape(G * K),
    )


def _drift_impl(st: BinnedState, geom: Geometry, dt: float | None = None
                ) -> BinnedState:
    """r += v dt in grid units, with the global coordinate boundaries
    applied (periodic wrap / reflective clamp + flip / open kill)."""
    dev, dtype = st.r.device, st.r.dtype
    d = torch.tensor(geom.cell_steps, dtype=dtype, device=dev)
    n = torch.tensor([geom.nx, geom.ny, geom.nz], dtype=dtype, device=dev)
    dt = geom.dt if dt is None else dt
    r = st.r + st.p * (dt / d)
    per = torch.tensor([b == PERIODIC for b in geom.bounds], device=dev)
    refl = torch.tensor([b == REFLECTIVE for b in geom.bounds], device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    r_wrap = torch.where(r < 0.0, r + n, torch.where(r > n, r - n, r))
    r_wrap = torch.minimum(torch.maximum(r_wrap, zero), n)
    out = (r < 0.0) | (r > n)
    r_new = torch.where(per, r_wrap, torch.minimum(torch.maximum(r, zero), n))
    p_new = torch.where(refl & out, -st.p, st.p)
    dead = torch.any(out & ~per & ~refl, dim=-1)
    return BinnedState(r=r_new, p=p_new, valid=st.valid & ~dead)


drift_state = _drift_impl


def _rebin_global(st: BinnedState, geom: Geometry):
    """Re-sort a drifted binned state into its new cells (global sort).

    A stable sort of the flat slot ids (the (id, slot) order of the JAX
    package) plus one packed 6-column gather.  Returns ``(state, load)``
    with ``load = [max_per_cell, dropped, moved]`` (int64 tensor).
    """
    G, K = st.valid.shape
    NK = G * K
    ids = state_cell_ids(st, geom).reshape(NK)
    tie = _arange(NK, ids)
    moved = torch.sum((ids != tie // K) & (ids < G))
    s_ids, perm = torch.sort(ids, stable=True)
    payload = torch.cat([st.r, st.p], dim=-1).reshape(NK, 6)[perm]

    seg = torch.searchsorted(s_ids, _arange(G + 1, ids))
    counts = seg[1:] - seg[:G]
    load = torch.stack([torch.max(counts),
                        torch.sum(torch.clamp(counts - K, min=0)), moved])

    k = _arange(K, ids)[None, :]
    pos = seg[:G, None] + k
    valid = pos < seg[1:, None]
    rp = payload[torch.clamp(pos, max=NK - 1)]
    r, p = rp[..., :3], rp[..., 3:]
    center = _cell_centers(geom, st.r.dtype, st.r.device)
    r = torch.where(valid[..., None], r, center)
    p = torch.where(valid[..., None], p, torch.zeros_like(p))
    return BinnedState(r=r, p=p, valid=valid), load


def _rebin_neighbor_guarded(st: BinnedState, geom: Geometry):
    """Neighbor exchange for float32 states, with the exact guard
    deciding on the host (one scalar read per step) whether the step
    must take the global sort instead: one slow step, never dropped
    particles.  Other dtypes take the global sort."""
    from .neighbor_rebin import neighbor_guard_stats, rebin_neighbor

    if st.r.dtype != torch.float32:
        return _rebin_global(st, geom)
    ok, moved, n_before = neighbor_guard_stats(st, geom)
    if bool(ok):
        return rebin_neighbor(st, geom, stats=(moved, n_before))
    return _rebin_global(st, geom)


def rebin(st: BinnedState, geom: Geometry) -> BinnedState:
    """Per-step migration; overflow beyond K slots in a cell is dropped
    (use :func:`rebin_checked` when capacity is in doubt)."""
    return _rebin_neighbor_guarded(st, geom)[0]


def rebin_checked(st: BinnedState, geom: Geometry):
    """:func:`rebin` plus ``load = [max_per_cell, dropped, moved]``."""
    return _rebin_neighbor_guarded(st, geom)


def wrap_state(st: BinnedState, geom: Geometry) -> BinnedState:
    """Apply the global coordinate boundaries (periodic wrap / open kill)
    to possibly out-of-domain positions without moving the particles."""
    return _drift_impl(st, geom, 0.0)


def migrate_checked(st: BinnedState, geom: Geometry):
    """Boundary map + checked rebin: the full per-step migration of a
    state whose positions moved in place (eccapfim's committed move)."""
    return rebin_checked(wrap_state(st, geom), geom)


def rebin_overflow(st: BinnedState, geom: Geometry) -> torch.Tensor:
    """Number of live particles that a :func:`rebin` would drop because
    their destination cell is already at slot capacity."""
    G, K = st.valid.shape
    ids = state_cell_ids(st, geom).reshape(-1)
    counts = torch.bincount(ids, minlength=G + 1)
    return torch.sum(torch.clamp(counts[:G] - K, min=0))


def kinetic_energy_state(st: BinnedState, m_mpw: float) -> torch.Tensor:
    """0.5 m mpw sum |p|^2 over the live slots (a 0-d tensor)."""
    w = torch.sum(st.p * st.p, dim=-1)
    return 0.5 * m_mpw * torch.sum(torch.where(st.valid, w,
                                               torch.zeros_like(w)))
