"""Scatter-free spline gather/deposit over the binned layout
(counterpart of ``xpic_tpu/ops/gather_scatter.py``).

Every window is anchored at the particle's cell, so a gather or deposit
is an unrolled loop over the ``width^3`` window offsets; each offset
touches one whole-grid shifted copy and the ``[G, K]`` per-slot weight
product.  Deposits are per-cell sums over the slot axis followed by
shifted whole-grid adds in a fixed order: no scatter and no atomics, so
the result is bitwise deterministic for a fixed particle order.

Anchors (offsets from the cell index ``c = floor(r/d)``): order-2 single
position anchor -1 width 4; order-2 position pair anchor -2 width 6;
order-1 (ECSIM s1) anchor -1 width 3.

On a z slab (``geom.mesh``) a gather pads the field once with the
window's ghost planes from the neighbour ranks and crops them away
(``rolled_flat`` with ``zpad``); a deposit adds into ghost-padded planes
and folds the ghost sums onto the ranks that own them (:class:`Placed`).
A gather reads the values of the whole grid's; a deposit adds the same
summands, those of a neighbour's particles after the rank's own.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..config import Geometry
from .splines import spline
from .stencil import shift
from ..parallel.mesh import mesh_of, z0_of

# Yee staggering tables: entry [c][axis] == 1 if component c is shifted
# half a step along that axis.
E_STAGGER = ((1, 0, 0), (0, 1, 0), (0, 0, 1))
B_STAGGER = ((0, 1, 1), (1, 0, 1), (1, 1, 0))


@lru_cache(maxsize=None)
def _cell_coords_cached(nx: int, ny: int, nz: int):
    g = np.arange(nx * ny * nz, dtype=np.int64)
    return np.stack([g % nx, (g // nx) % ny, g // (nx * ny)], axis=-1)


def cell_t(geom: Geometry, rg: torch.Tensor) -> torch.Tensor:
    """Per-axis position of each slot relative to its cell index:
    ``rg`` [G, K, 3] in grid units -> t = rg - cell, in [0, 1)."""
    coords = _cell_coords_cached(geom.nx, geom.ny, geom.nz)
    if z0_of(geom):
        coords = coords + np.array([0, 0, z0_of(geom)])
    cell = torch.as_tensor(coords, device=rg.device).to(rg.dtype)[:, None, :]
    return rg - cell


def z_halo(anchor: int, width: int) -> tuple[int, int]:
    """Ghost planes (below, above) a window of ``width`` offsets from
    ``anchor`` reads on a slab."""
    return max(0, -anchor), max(0, anchor + width - 1)


def pad_for(F: torch.Tensor, geom: Geometry, zpad):
    """``F`` with the ghost planes ``zpad = (lo, hi)`` on a slab (as is
    on one rank)."""
    mesh = mesh_of(geom)
    return F if mesh is None else mesh.halo_pad(F, *zpad)


def axis_weights(t: torch.Tensor, order: int, width: int, anchor: int,
                 stag: bool) -> torch.Tensor:
    """Spline weights [..., width] at window offsets
    ``anchor..anchor+width-1``: weight o = S(t - (anchor + o) - 0.5*stag)."""
    sf = spline(order)
    offs = (torch.arange(width, dtype=t.dtype, device=t.device)
            + (anchor + (0.5 if stag else 0.0)))
    return sf(t[..., None] - offs)


def rolled_flat(field: torch.Tensor, off: tuple[int, int, int],
                bounds: tuple[str, str, str], zpad=None) -> torch.Tensor:
    """The grid tensor [nz, ny, nx] sampled at cell+off (oz, oy, ox),
    flattened to [G].  ``zpad = (lo, hi)``: ``field`` is a slab padded
    with lo ghost planes below and hi above, read there without wrap."""
    out = field
    for axis, o in zip("zyx", off):
        if axis == "z" and zpad is not None:
            lo, hi = zpad
            out = out.narrow(-3, lo + o, out.shape[-3] - lo - hi)
        else:
            out = shift(out, axis, o, bounds["xyz".index(axis)])
    return out.reshape(-1)


def _unroll_back(dense, off, bounds):
    """Place per-cell sums at cell+off: the adjoint of :func:`rolled_flat`."""
    out = dense
    for axis, o in zip("zyx", off):
        out = shift(out, axis, -o, bounds["xyz".index(axis)])
    return out


class Placed:
    """Per-cell sums ``dense`` [..., nz, ny, nx] placed at cell+off and
    added in the order of the :meth:`add` calls.  On one rank each
    summand is a whole-grid shift (periodic roll or zero fill); on a
    slab it lands in planes padded with ``zpad = (lo, hi)`` ghost planes,
    which :meth:`result` folds onto the ranks that own them."""

    def __init__(self, geom: Geometry, zpad):
        self.geom, self.zpad = geom, zpad
        self.acc = None

    def add(self, dense, off) -> None:
        geom = self.geom
        if mesh_of(geom) is None:
            contrib = _unroll_back(dense, off, geom.bounds)
            self.acc = contrib if self.acc is None else self.acc + contrib
            return
        lo, hi = self.zpad
        if self.acc is None:
            shape = list(dense.shape)
            shape[-3] += lo + hi
            self.acc = torch.zeros(shape, dtype=dense.dtype,
                                   device=dense.device)
        contrib = _unroll_back(dense, (0,) + tuple(off[1:]), geom.bounds)
        self.acc.narrow(-3, lo + off[0], dense.shape[-3]).add_(contrib)

    def result(self):
        return _folded(self.acc, self.geom, self.zpad)


def _component_axis_weights(t, order, width, anchor, stag_row):
    sx, sy, sz = stag_row
    wx = axis_weights(t[..., 0], order, width, anchor, bool(sx))
    wy = axis_weights(t[..., 1], order, width, anchor, bool(sy))
    wz = axis_weights(t[..., 2], order, width, anchor, bool(sz))
    return wx, wy, wz


def gather_vector(F, t, valid, geom: Geometry, *, order: int, width: int,
                  anchor: int, stagger=E_STAGGER) -> torch.Tensor:
    """Interpolate a staggered vector field ``F`` [3, nz, ny, nx] to the
    binned slots; returns [G, K, 3] (zero on invalid slots)."""
    zpad = None if mesh_of(geom) is None else z_halo(anchor, width)
    F = pad_for(F, geom, zpad)
    out = []
    for c in range(3):
        wx, wy, wz = _component_axis_weights(t, order, width, anchor,
                                             stagger[c])
        acc = torch.zeros(t.shape[:-1], dtype=F.dtype, device=F.device)
        for oz in range(width):
            for oy in range(width):
                wzy = wz[..., oz] * wy[..., oy]
                for ox in range(width):
                    f = rolled_flat(F[c], (anchor + oz, anchor + oy,
                                           anchor + ox), geom.bounds, zpad)
                    acc = acc + (wzy * wx[..., ox]) * f[:, None]
        out.append(acc)
    res = torch.stack(out, dim=-1)
    return torch.where(valid[..., None], res, torch.zeros_like(res))


def _unrolled_deposit(geom: Geometry, width, anchor, weight_fn):
    """Shared deposit loop: weight_fn(c, oz, oy, ox) -> [G, K]
    contribution; returns the [3, nz, ny, nx] deposited field, summed in
    a fixed offset order."""
    comps = []
    for c in range(3):
        acc = Placed(geom, z_halo(anchor, width))
        for oz in range(width):
            for oy in range(width):
                for ox in range(width):
                    w = weight_fn(c, oz, oy, ox)
                    dense = torch.sum(w, dim=1).reshape(geom.shape)
                    acc.add(dense, (anchor + oz, anchor + oy, anchor + ox))
        comps.append(acc.acc)
    return _folded(torch.stack(comps), geom, z_halo(anchor, width))


def _folded(acc, geom: Geometry, zpad):
    """The stacked padded sums of several :class:`Placed` folded at once
    (one exchange); as is on one rank."""
    mesh = mesh_of(geom)
    return acc if mesh is None else mesh.halo_fold(acc, *zpad)


def deposit_vector(values, t, valid, geom: Geometry, *, order: int,
                   width: int, anchor: int, stagger=E_STAGGER):
    """Deposit per-slot vector values [G, K, 3] onto the staggered grid;
    returns [3, nz, ny, nx]."""
    masked = torch.where(valid[..., None], values, torch.zeros_like(values))
    w_cache = {}

    def weight_fn(c, oz, oy, ox):
        if c not in w_cache:
            w_cache[c] = _component_axis_weights(t, order, width, anchor,
                                                 stagger[c])
        wx, wy, wz = w_cache[c]
        return masked[..., c] * (wz[..., oz] * wy[..., oy] * wx[..., ox])

    return _unrolled_deposit(geom, width, anchor, weight_fn)


def deposit_scalar(values, t, valid, geom: Geometry, *, order: int,
                   width: int, anchor: int, stag: bool = False):
    """Deposit per-slot scalar values [G, K]; returns [nz, ny, nx].
    Node-centred with ``stag=False`` (the charge density of
    ChargeConservation), cell-centred with ``stag=True`` (weights at the
    half-shifted lattice on every axis: the DistributionMoment deposit)."""
    masked = torch.where(valid, values, torch.zeros_like(values))
    wx = axis_weights(t[..., 0], order, width, anchor, stag)
    wy = axis_weights(t[..., 1], order, width, anchor, stag)
    wz = axis_weights(t[..., 2], order, width, anchor, stag)
    acc = Placed(geom, z_halo(anchor, width))
    for oz in range(width):
        for oy in range(width):
            for ox in range(width):
                w = masked * (wz[..., oz] * wy[..., oy] * wx[..., ox])
                dense = torch.sum(w, dim=1).reshape(geom.shape)
                acc.add(dense, (anchor + oz, anchor + oy, anchor + ox))
    return acc.result()


def blocks_to_grid(blk, geom: Geometry, width: int, anchor: int):
    """Scatter per-cell window blocks [G, 3, w, w, w] (axes z, y, x,
    offsets anchor..anchor+w-1 from the cell) onto the grid
    [3, nz, ny, nx]: the adjoint of ``width**3`` :func:`rolled_flat`
    reads, every summand a whole-grid shift."""
    comps = []
    for c in range(3):
        acc = Placed(geom, z_halo(anchor, width))
        for oz in range(width):
            for oy in range(width):
                for ox in range(width):
                    dense = blk[:, c, oz, oy, ox].reshape(geom.shape)
                    acc.add(dense, (anchor + oz, anchor + oy, anchor + ox))
        comps.append(acc.acc)
    return _folded(torch.stack(comps), geom, z_halo(anchor, width))


def esirkepov_current(t_old, t_new, valid, alpha, geom: Geometry):
    """Charge-conserving Esirkepov current deposit of one move: ``t_old``
    and ``t_new`` are cell-relative positions [G, K, 3] before and after
    it (binned by the old cell), ``alpha`` the prefactor
    q n / Np / (6 dt).  Returns the [3, nz, ny, nx] current increment.

    Per-offset form over the width-6 order-2 window: with
    CS_x = cumsum(Sn_x - So_x), A = 2 Sn + So and B = 2 So + Sn, the Jx
    summand at offset (x, y, z) is
    -alpha dx CS_x[x] (Sn_y[y] A_z[z] + So_y[y] B_z[z]), and likewise for
    y and z: 648 shifted whole-grid adds."""
    order, width, anchor = 2, 6, -2

    def axes_w(t):
        return [axis_weights(t[..., a], order, width, anchor, False)
                for a in range(3)]

    So, Sn = axes_w(t_old), axes_w(t_new)
    mask = valid.to(t_old.dtype)
    CS = [torch.cumsum(Sn[a] - So[a], dim=-1) for a in range(3)]
    A = [2.0 * Sn[a] + So[a] for a in range(3)]
    Bw = [2.0 * So[a] + Sn[a] for a in range(3)]
    qx, qy, qz = alpha * geom.dx, alpha * geom.dy, alpha * geom.dz

    def weight_fn(c, oz, oy, ox):
        if c == 0:
            return (-qx * mask) * CS[0][..., ox] * (
                Sn[1][..., oy] * A[2][..., oz]
                + So[1][..., oy] * Bw[2][..., oz])
        if c == 1:
            return (-qy * mask) * CS[1][..., oy] * (
                Sn[0][..., ox] * A[2][..., oz]
                + So[0][..., ox] * Bw[2][..., oz])
        return (-qz * mask) * CS[2][..., oz] * (
            Sn[1][..., oy] * A[0][..., ox] + So[1][..., oy] * Bw[0][..., ox])

    return _unrolled_deposit(geom, width, anchor, weight_fn)
