"""The ECSIM 12-slot layout per field component and the assembled mass
matrix as dense per-cell blocks (counterpart of
``xpic_tpu/ops/ecsim_blocks.py``).

Every particle's 12 slots per component sit at fixed offsets from its
cell, so matL is a block array ``L[G, 3, 12, 3, 12]`` with one static
offset table per component:
``L[g, c, i, d, j] = sum_k W[g,k,c,i] (A_p matB)[g,k,c,d] W[g,k,d,j]``.
``y = matL x`` gathers x at the 12 slots per component, multiplies by
each cell's 36 x 36 block and scatters back with 36 shifted adds.  The
contractions run in the operands' full precision (the JAX package asks
for bf16x3 on its float32 path; the port does not).

Slot layouts:
  component X: slot (k*2 + j)*3 + sx -> offset (z+k, y+j, x+sx-1)
  component Y: slot (k*3 + sy)*2 + i -> offset (z+k, y+sy-1, x+i)
  component Z: slot (sz*2 + j)*2 + i -> offset (z+sz-1, y+j, x+i)
"""

from __future__ import annotations

import torch

from ..config import Geometry
from .gather_scatter import Placed, _folded, axis_weights, pad_for, \
    rolled_flat
from ..parallel.mesh import mesh_of

# Ghost z planes (below, above) the slot offsets read on a slab.
ZPAD = (1, 1)

# Static slot -> (dz, dy, dx) offset tables per component.
OFFSETS = (
    tuple((k, j, sx - 1) for k in (0, 1) for j in (0, 1) for sx in (0, 1, 2)),
    tuple((k, sy - 1, i) for k in (0, 1) for sy in (0, 1, 2) for i in (0, 1)),
    tuple((sz - 1, j, i) for sz in (0, 1, 2) for j in (0, 1) for i in (0, 1)),
)


def s1_slot_weights(t):
    """Per-slot linear Yee weights W[G, K, 3, 12] at the cell-relative
    positions ``t`` [G, K, 3] (in [0, 1)): node weights are the 2-point
    hats, staggered weights the 3-point hats around the half-shifted
    lattice."""
    wnx, wny, wnz = (axis_weights(t[..., a], 1, 2, 0, False) for a in range(3))
    wsx, wsy, wsz = (axis_weights(t[..., a], 1, 3, -1, True) for a in range(3))
    lead = t.shape[:-1]
    WX = (wnz[..., :, None, None] * wny[..., None, :, None]
          * wsx[..., None, None, :]).reshape(lead + (12,))
    WY = (wnz[..., :, None, None] * wsy[..., None, :, None]
          * wnx[..., None, None, :]).reshape(lead + (12,))
    WZ = (wsz[..., :, None, None] * wny[..., None, :, None]
          * wnx[..., None, None, :]).reshape(lead + (12,))
    return torch.stack([WX, WY, WZ], dim=-2)


def rotation_tensor(b):
    """The 3x3 tensor matB = I + b b^T + the antisymmetric part of b,
    for b = (dt/2)(q/m) B_p: [..., 3 (row), 3 (column)]."""
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    one = torch.ones_like(bx)
    row0 = torch.stack([one + bx * bx, +bz + bx * by, -by + bx * bz], dim=-1)
    row1 = torch.stack([-bz + by * bx, one + by * by, +bx + by * bz], dim=-1)
    row2 = torch.stack([+by + bz * bx, -bx + bz * by, one + bz * bz], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def ecsim_particle_terms(B_p, v, valid, *, q, m, mpw, dt):
    """Per-slot implicit current and weighted rotation tensor:
    I_p = q mpw / (1 + b^2) (v + v x b + (v.b) b) [G, K, 3] and
    M = A_p matB [G, K, 3, 3] with A_p = dt^2/2 mpw q^2 / m / (1 + b^2);
    both zero on invalid slots."""
    b = B_p * (0.5 * dt * q / m)
    b2 = torch.sum(b * b, dim=-1, keepdim=True)
    I_p = (q * mpw / (1.0 + b2)) * (
        v + torch.linalg.cross(v, b)
        + torch.sum(v * b, dim=-1, keepdim=True) * b)
    A_p = (0.5 * dt * dt * mpw * q * q / m) / (1.0 + b2)
    M = A_p[..., None] * rotation_tensor(b)
    mask = valid[..., None]
    return (torch.where(mask, I_p, torch.zeros_like(I_p)),
            torch.where(mask[..., None], M, torch.zeros_like(M)))


def assemble_blocks(W, M):
    """L[G, 3, 12, 3, 12] = sum_k W[g,k,c,i] M[g,k,c,d] W[g,k,d,j]: one
    batched [12, K] x [K, 36] product per row component c."""
    G, K = W.shape[:2]
    outs = []
    for c in range(3):
        T = (M[:, :, c, :, None] * W).reshape(G, K, 36)  # [G, K, (d, j)]
        outs.append(torch.bmm(W[:, :, c].transpose(1, 2), T)
                    .reshape(G, 12, 3, 12))
    return torch.stack(outs, dim=1)


def deposit_slot_sums(Islot, geom: Geometry):
    """Scatter slot-summed values [G, 3, 12] onto the grid
    [3, nz, ny, nx] as 36 shifted whole-grid adds in a fixed order."""
    comps = []
    for c in range(3):
        acc = Placed(geom, ZPAD)
        for s in range(12):
            acc.add(Islot[:, c, s].reshape(geom.shape), OFFSETS[c][s])
        comps.append(acc.acc)
    return _folded(torch.stack(comps), geom, ZPAD)


def gather_slots(F, geom: Geometry):
    """Gather the 12 slot values per component per cell: [G, 3, 12]."""
    zpad = None if mesh_of(geom) is None else ZPAD
    F = pad_for(F, geom, zpad)
    cols = []
    for c in range(3):
        cols.append(torch.stack(
            [rolled_flat(F[c], OFFSETS[c][s], geom.bounds, zpad)
             for s in range(12)], dim=-1))
    return torch.stack(cols, dim=-2)


def apply_blocks(L, x, geom: Geometry):
    """y = matL x: gather x at the slots, one [36, 36] x [36] product per
    cell, scatter back."""
    G = L.shape[0]
    xg = gather_slots(x, geom).reshape(G, 36, 1)
    yg = torch.bmm(L.reshape(G, 36, 36), xg).reshape(G, 3, 12)
    return deposit_slot_sums(yg, geom)


def blocks_trace(L):
    """tr(matL) of dense blocks (a 0-d tensor): sum over g, c, i of
    L[g, c, i, c, i]."""
    G = L.shape[0]
    return torch.sum(torch.diagonal(L.reshape(G, 36, 36), dim1=1, dim2=2))
