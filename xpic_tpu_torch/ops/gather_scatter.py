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
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..config import Geometry
from .splines import spline
from .stencil import shift

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
    cell = torch.as_tensor(
        _cell_coords_cached(geom.nx, geom.ny, geom.nz), device=rg.device
    ).to(rg.dtype)[:, None, :]
    return rg - cell


def axis_weights(t: torch.Tensor, order: int, width: int, anchor: int,
                 stag: bool) -> torch.Tensor:
    """Spline weights [..., width] at window offsets
    ``anchor..anchor+width-1``: weight o = S(t - (anchor + o) - 0.5*stag)."""
    sf = spline(order)
    offs = (torch.arange(width, dtype=t.dtype, device=t.device)
            + (anchor + (0.5 if stag else 0.0)))
    return sf(t[..., None] - offs)


def rolled_flat(field: torch.Tensor, off: tuple[int, int, int],
                bounds: tuple[str, str, str]) -> torch.Tensor:
    """The grid tensor [nz, ny, nx] sampled at cell+off (oz, oy, ox),
    flattened to [G]."""
    out = field
    for axis, o in zip("zyx", off):
        out = shift(out, axis, o, bounds["xyz".index(axis)])
    return out.reshape(-1)


def _unroll_back(dense, off, bounds):
    """Place per-cell sums at cell+off: the adjoint of :func:`rolled_flat`."""
    out = dense
    for axis, o in zip("zyx", off):
        out = shift(out, axis, -o, bounds["xyz".index(axis)])
    return out


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
                                           anchor + ox), geom.bounds)
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
        acc = None
        for oz in range(width):
            for oy in range(width):
                for ox in range(width):
                    w = weight_fn(c, oz, oy, ox)
                    dense = torch.sum(w, dim=1).reshape(geom.shape)
                    off = (anchor + oz, anchor + oy, anchor + ox)
                    contrib = _unroll_back(dense, off, geom.bounds)
                    acc = contrib if acc is None else acc + contrib
        comps.append(acc)
    return torch.stack(comps)


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
    acc = None
    for oz in range(width):
        for oy in range(width):
            for ox in range(width):
                w = masked * (wz[..., oz] * wy[..., oy] * wx[..., ox])
                dense = torch.sum(w, dim=1).reshape(geom.shape)
                contrib = _unroll_back(
                    dense, (anchor + oz, anchor + oy, anchor + ox),
                    geom.bounds)
                acc = contrib if acc is None else acc + contrib
    return acc


def blocks_to_grid(blk, geom: Geometry, width: int, anchor: int):
    """Scatter per-cell window blocks [G, 3, w, w, w] (axes z, y, x,
    offsets anchor..anchor+w-1 from the cell) onto the grid
    [3, nz, ny, nx]: the adjoint of ``width**3`` :func:`rolled_flat`
    reads, every summand a whole-grid shift."""
    comps = []
    for c in range(3):
        acc = None
        for oz in range(width):
            for oy in range(width):
                for ox in range(width):
                    dense = blk[:, c, oz, oy, ox].reshape(geom.shape)
                    contrib = _unroll_back(
                        dense, (anchor + oz, anchor + oy, anchor + ox),
                        geom.bounds)
                    acc = contrib if acc is None else acc + contrib
        comps.append(acc)
    return torch.stack(comps)
