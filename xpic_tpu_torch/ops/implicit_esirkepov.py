"""Implicit (time-averaged) Esirkepov gather/deposit for eccapfim
(counterpart of ``xpic_tpu/ops/implicit_esirkepov.py``).

Reference: src/algorithms/implicit_esirkepov.cpp.  For a straight move
r0 -> rn, the electric field is gathered (and the current deposited)
with mixed-order weights per component cx, with cyclic transverse axes
cy = cx+1, cz = cx+2 (mod 3):

    w = (1/6) S1(g_stag - prh)[cx]
        * ( S2(g - prn)[cy] (2 S2(g - prn)[cz] + S2(g - pr0)[cz])
          + S2(g - pr0)[cy] (2 S2(g - pr0)[cz] + S2(g - prn)[cz]) )

where prh = (prn + pr0)/2 and g_stag = g + 1/2.  The magnetic field is
gathered with plain order-2 Yee (magnetic) products at prh.

Per residual evaluation the fields are gathered into per-cell window
blocks ``[G, 3, 6, 6, 6]`` (offsets -2..+3 from the cell, axes (z, y,
x)) once, by one index gather per field; every Picard iteration then
contracts per-axis weight vectors against the blocks.  The contractions
are staged products (a batched matrix product over one axis, then two
weighted sums), never a 4-operand einsum: evaluated left to right that
would build a ``[G, K, 6, 6, 6]`` intermediate.

The path split at node-cell faces replaces ``cell_traversal``
(src/impls/eccapfim/cell_traversal.cpp:3-77): with per-axis displacement
below one cell there is at most one face crossing per axis, so the
crossing parameters sort into at most 4 segments.

On a z slab (``geom.mesh``) the windows read a field padded with the
neighbour ranks' ghost planes, and the deposit's blocks fold their ghost
planes back (``blocks_to_grid``): a cell's window holds the whole grid's
values.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..config import PERIODIC, Geometry
from ..parallel.mesh import mesh_of
from .gather_scatter import blocks_to_grid, pad_for, z_halo
from .splines import spline_1, spline_2

WIDTH = 6
ANCHOR = -2
MAXSEG = 4


@lru_cache(maxsize=None)
def _window_index(nx: int, ny: int, nz: int, bounds, device,
                  zpad=None) -> torch.Tensor:
    """[G, 3, 216] indices into the [3, G' + 1] padded field, flattened:
    every window entry (axis order dz, dy, dx) of every cell, periodic
    axes wrapped; an entry outside a non-periodic domain points at the
    zero appended to its component.  With ``zpad = (lo, hi)`` the field
    is a z slab of ``nz`` planes padded with ``lo`` ghost planes below
    and ``hi`` above (G' counts them), read there with no wrap in z."""
    G = nx * ny * nz
    g = np.arange(G)
    cell = (g % nx, (g // nx) % ny, g // (nx * ny))  # (x, y, z)
    o = np.arange(WIDTH) + ANCHOR
    idx, inside = [], np.ones((G, 1, 1, 1), bool)
    for axis, n in enumerate((nx, ny, nz)):
        c = cell[axis][:, None] + o[None, :]  # [G, 6]
        if axis == 2 and zpad is not None:
            c = c + zpad[0]
        elif bounds[axis] == PERIODIC:
            c = c % n
        else:
            ok = (c >= 0) & (c < n)
            shape = [G, 1, 1, 1]
            shape[3 - axis] = WIDTH
            inside = inside & ok.reshape(shape)
            c = np.clip(c, 0, n - 1)
        idx.append(c)
    x, y, z = idx
    Gp = nx * ny * (nz if zpad is None else nz + zpad[0] + zpad[1])
    flat = ((z[:, :, None, None] * ny + y[:, None, :, None]) * nx
            + x[:, None, None, :])
    flat = np.where(inside, flat, Gp).reshape(G, 1, WIDTH ** 3)
    comp = np.arange(3)[None, :, None] * (Gp + 1)
    return torch.as_tensor(flat + comp, device=device)


def gather_window_blocks(F, geom: Geometry):
    """Per-cell windows out[G, 3, 6, 6, 6] with axes (component, dz, dy,
    dx), offsets ANCHOR..ANCHOR+5 from the cell: one gather.  On a z
    slab the field is padded first with the ghost planes the windows
    read (2 below, 3 above; zeros beyond a non-periodic global bound)."""
    G = geom.n_cells
    zpad = None if mesh_of(geom) is None else z_halo(ANCHOR, WIDTH)
    F = pad_for(F, geom, zpad)
    Gp = F[0].numel()
    padded = torch.cat([F.reshape(3, Gp), F.new_zeros(3, 1)], dim=1)
    idx = _window_index(geom.nx, geom.ny, geom.nz, tuple(geom.bounds),
                        F.device, zpad)
    out = padded.reshape(-1)[idx]
    return out.reshape(G, 3, WIDTH, WIDTH, WIDTH)


def _offsets(t):
    return torch.arange(WIDTH, dtype=t.dtype, device=t.device) + ANCHOR


def node_weights_s2(t):
    """S2(t - o) over the 6-offset window; t is cell-relative [G, K]."""
    return spline_2(t[..., None] - _offsets(t))


def stag_weights_s1(t):
    """S1(t - (o + 1/2)) over the window (hat at half-shifted points)."""
    return spline_1(t[..., None] - (_offsets(t) + 0.5))


def stag_weights_s2(t):
    return spline_2(t[..., None] - (_offsets(t) + 0.5))


def _axis_weights_E(t0, tn):
    """Per-axis weight factors of the implicit-Esirkepov E kernel:
    (sh[a], sn[a], s0[a]) each [G, K, 6], where sh is the (1/6)-scaled
    hat at staggered points of the midpoint, and sn/s0 the order-2 node
    weights of the new/old positions (implicit_esirkepov.cpp:31-66)."""
    th = 0.5 * (t0 + tn)
    sh = [stag_weights_s1(th[..., a]) / 6.0 for a in range(3)]
    sn = [node_weights_s2(tn[..., a]) for a in range(3)]
    s0 = [node_weights_s2(t0[..., a]) for a in range(3)]
    return sh, sn, s0


def _component_weights(cx, sh, sn, s0):
    """The cyclic pairing cy = cx+1, cz = cx+2 of component cx: the
    shared factor sh[cx] and the (axis cy, axis cz) factors of its two
    separable terms, sn_y (2 sn_z + s0_z) and s0_y (2 s0_z + sn_z)."""
    cy = (cx + 1) % 3
    cz = (cx + 2) % 3
    A = 2.0 * sn[cz] + s0[cz]
    Bc = 2.0 * s0[cz] + sn[cz]
    return cy, cz, sh[cx], (sn[cy], A), (s0[cy], Bc)


def _axis_map(cx, cy, cz, w_cx, w_cy, w_cz):
    out = [None, None, None]
    out[cx] = w_cx
    out[cy] = w_cy
    out[cz] = w_cz
    return tuple(out)  # (wx, wy, wz)


def _first_axis(block_c, w, axis):
    """Sum of block_c [G, 6, 6, 6] (z, y, x) over spatial ``axis`` (0 x,
    1 y, 2 z) against w [G, K, 6]: [G, K, 6, 6] over the two other axes,
    in (z, y, x) order."""
    G = block_c.shape[0]
    b = block_c.movedim(3 - axis, -1).reshape(G, WIDTH * WIDTH, WIDTH)
    out = torch.bmm(w, b.transpose(1, 2))
    return out.reshape(G, w.shape[1], WIDTH, WIDTH)


def _last_axes(part, w_outer, w_inner):
    """[G, K, 6 outer, 6 inner] against the two remaining weights."""
    return torch.sum(torch.sum(part * w_inner[:, :, None, :], dim=-1)
                     * w_outer, dim=-1)


def _rest(axis):
    """The two axes other than ``axis``, outer first in (z, y, x) order."""
    outer, inner = (a for a in (2, 1, 0) if a != axis)
    return outer, inner


def _contract(block_c, wmap, first: int = 0):
    """sum_{z,y,x} wz wy wx block_c: [G, K] from per-axis [G, K, 6]
    weights against [G, 6, 6, 6] (z, y, x); axis ``first`` is summed
    first."""
    outer, inner = _rest(first)
    part = _first_axis(block_c, wmap[first], first)
    return _last_axes(part, wmap[outer], wmap[inner])


def _contract_pair(block_c, cx, w_sh, term1, term2):
    """Both E terms of component cx: the shared sh factor on axis cx is
    summed once, then each term's (cy, cz) factors."""
    cy, cz = (cx + 1) % 3, (cx + 2) % 3
    outer, inner = _rest(cx)
    part = _first_axis(block_c, w_sh, cx)
    total = 0.0
    for wy_, wz_ in (term1, term2):
        w = {cy: wy_, cz: wz_}
        total = total + _last_axes(part, w[outer], w[inner])
    return total


def gather_E_implicit(Eblk, t0, tn):
    """E_p[G, K, 3] for the move t0 -> tn against pre-gathered blocks."""
    sh, sn, s0 = _axis_weights_E(t0, tn)
    comps = []
    for cx in range(3):
        _, _, w_sh, term1, term2 = _component_weights(cx, sh, sn, s0)
        comps.append(_contract_pair(Eblk[:, cx], cx, w_sh, term1, term2))
    return torch.stack(comps, dim=-1)


def deposit_J_implicit(t0, tn, v, scale):
    """Per-cell current window blocks Jblk[G, 3, 6, 6, 6] for the move
    t0 -> tn carrying velocity v, scaled by ``scale`` [G, K]
    (implicit_esirkepov.cpp:95-117, the adjoint of gather_E_implicit):
    per term the outer product [G, K, 36] of (scale v wz, wy), then a
    batched product with wx over the slots."""
    sh, sn, s0 = _axis_weights_E(t0, tn)
    G, K = scale.shape
    comps = []
    for cx in range(3):
        cy, cz, w_sh, term1, term2 = _component_weights(cx, sh, sn, s0)
        val = scale * v[..., cx]  # [G, K]
        blk = 0.0
        for wy_, wz_ in (term1, term2):
            wx, wy, wz = _axis_map(cx, cy, cz, w_sh, wy_, wz_)
            zy = ((val[..., None] * wz)[..., :, None] * wy[..., None, :])
            blk = blk + torch.bmm(zy.reshape(G, K, WIDTH * WIDTH)
                                  .transpose(1, 2), wx)
        comps.append(blk.reshape(G, WIDTH, WIDTH, WIDTH))
    return torch.stack(comps, dim=1)


def scatter_blocks(Jblk, geom: Geometry):
    """Scatter per-cell window blocks onto the grid: [3, nz, ny, nx]."""
    return blocks_to_grid(Jblk, geom, WIDTH, ANCHOR)


def gather_B_implicit(Bblk, th):
    """B_p[G, K, 3]: plain order-2 magnetic Yee products at the midpoint
    ``th`` (cell-relative), against pre-gathered blocks
    (implicit_esirkepov.cpp:70-76 via SimpleInterpolation)."""
    wn = [node_weights_s2(th[..., a]) for a in range(3)]
    ws = [stag_weights_s2(th[..., a]) for a in range(3)]
    # B staggering: component X -> (node x, stag y, stag z) etc.
    maps = (
        (wn[0], ws[1], ws[2]),
        (ws[0], wn[1], ws[2]),
        (ws[0], ws[1], wn[2]),
    )
    comps = [_contract(Bblk[:, c], maps[c]) for c in range(3)]
    return torch.stack(comps, dim=-1)


def gather_dk_fields(Eblk, Bblk, gradBblk, t0, tn):
    """Drift-kinetic variant (src/algorithms/drift_kinetic_implicit.cpp):
    path-averaged E via the implicit-Esirkepov kernel plus B and a
    precomputed |B|-gradient field gathered with magnetic staggering at
    the new position ``tn``."""
    E_p = gather_E_implicit(Eblk, t0, tn)
    B_p = gather_B_implicit(Bblk, tn)
    gradB_p = gather_B_implicit(gradBblk, tn)
    return E_p, B_p, gradB_p


def crossing_params(t0, tn):
    """Per-axis node-cell face crossing parameter of the move t0 -> tn
    in [0, 1]; 1 where the move crosses no face on that axis."""
    d = tn - t0
    curr = torch.round(t0)  # half to even, as jnp.round
    last = torch.round(tn)
    sign = torch.where(d > 0, 1.0, -1.0).to(d.dtype)
    bnd = curr + 0.5 * sign
    safe_d = torch.where(d == 0, torch.ones_like(d), d)
    tc = torch.where((curr != last) & (d != 0), (bnd - t0) / safe_d,
                     torch.full_like(d, 2.0))  # 2.0 = "no crossing"
    tc = torch.clamp(tc, 0.0, 1.0 + 1e-30)
    return torch.where(tc > 1.0, torch.ones_like(tc), tc)


def split_segments(t0, tn):
    """Split the straight move t0 -> tn (cell-relative, grid units) at
    node-cell faces (half-integer planes).

    Returns taus[G, K, MAXSEG+1] with taus[..., 0] = 0, taus[..., -1] = 1
    and the sorted face-crossing parameters in between.  Degenerate
    segments have zero length and deposit nothing.
    """
    ts = torch.sort(crossing_params(t0, tn), dim=-1).values
    zero = torch.zeros_like(ts[..., :1])
    return torch.cat([zero, ts, torch.ones_like(zero)], dim=-1)
