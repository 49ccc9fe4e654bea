"""Matrix-free ECSIM mass-matrix application
(counterpart of ``xpic_tpu/ops/mass_free.py``, the plain-tensor chain).

matL is never assembled: every solver iteration gathers x at the 12
slots per component, rotates it per particle slot, and deposits it back
through the same factored s1 weights.  The per-slot operator is
M_p v = coef * (v + (b.v) b + v x b) with b = (dt q / 2m) B_p and
coef = (dt^2/2) (q^2/m) mpw / (1 + b^2).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import Geometry
from .ecsim_blocks import deposit_slot_sums, gather_slots


@dataclasses.dataclass
class MassOp:
    """Per-species operands of the matrix-free mass apply, packed once
    per step into one [G, 8, K] tensor with channel rows
    (tx, ty, tz, bx, by, bz, coef, 0); coef is zero on invalid slots."""

    packed: torch.Tensor  # [G, 8, K]


def mass_operands(t, B_p, valid, *, q: float, m: float, mpw: float,
                  dt: float) -> MassOp:
    b = B_p * (0.5 * dt * q / m)
    b2 = torch.sum(b * b, dim=-1)
    coef = (0.5 * dt * dt * mpw * q * q / m) / (1.0 + b2)
    coef = torch.where(valid, coef, torch.zeros_like(coef))
    packed = torch.stack(
        [t[..., 0], t[..., 1], t[..., 2],
         b[..., 0], b[..., 1], b[..., 2],
         coef, torch.zeros_like(coef)],
        dim=1,
    )
    return MassOp(packed=packed)


def _axis_hats_planes(t_planes):
    """Separable per-axis s1 factors over three [G, K] t planes: the node
    pair (S1(t), S1(t-1)) and the staggered triple around the
    half-shifted lattice."""
    wn, ws = [], []
    for ta in t_planes:
        wn.append((1.0 - ta, ta))
        ws.append((
            torch.clamp(0.5 - ta, min=0.0),
            1.0 - torch.abs(ta - 0.5),
            torch.clamp(ta - 0.5, min=0.0),
        ))
    return wn, ws


def _axis_hats(t):
    return _axis_hats_planes(tuple(t[..., a] for a in range(3)))


# Per component c: the (outer, mid, inner) axis factor sets in slot
# order, slot s = (o * len(mid) + m) * len(inner) + i, matching
# ecsim_blocks.OFFSETS.
def _component_factors(wn, ws):
    return (
        (wn[2], wn[1], ws[0]),  # X
        (wn[2], ws[1], wn[0]),  # Y
        (ws[2], wn[1], wn[0]),  # Z
    )


def _gather_component(xc, fo, fm, fi):
    """e[g, k] = sum_s W_c[g, k, s] * xc[g, s] in factored form."""
    no, nm, ni = len(fo), len(fm), len(fi)
    e = None
    for o in range(no):
        t2 = None
        for mth in range(nm):
            t1 = None
            for i in range(ni):
                s = (o * nm + mth) * ni + i
                term = fi[i] * xc[:, s][:, None]
                t1 = term if t1 is None else t1 + term
            t1 = fm[mth] * t1
            t2 = t1 if t2 is None else t2 + t1
        t2 = fo[o] * t2
        e = t2 if e is None else e + t2
    return e


def _deposit_component(yc, fo, fm, fi):
    """Y[g, s] = sum_k W_c[g, k, s] * yc[g, k] in factored form; [G, 12]."""
    cols = []
    for o in range(len(fo)):
        u = fo[o] * yc
        for mth in range(len(fm)):
            v = fm[mth] * u
            for i in range(len(fi)):
                cols.append(torch.sum(fi[i] * v, dim=1))
    return torch.stack(cols, dim=-1)


def _rotate(u, b_planes, coef):
    """M v per slot: coef * (u + (b.u) b + u x b)."""
    ux, uy, uz = u
    bx, by, bz = b_planes
    ub = ux * bx + uy * by + uz * bz
    return (
        coef * (ux + ub * bx + (uy * bz - uz * by)),
        coef * (uy + ub * by + (uz * bx - ux * bz)),
        coef * (uz + ub * bz + (ux * by - uy * bx)),
    )


def mass_apply(x, masses, geom: Geometry):
    """y = (sum_species matL_s) @ x without materializing any L;
    ``masses`` is a sequence of :class:`MassOp`."""
    xg = gather_slots(x, geom)  # [G, 3, 12]
    Y = None
    for op in masses:
        P = op.packed
        wn, ws = _axis_hats_planes((P[:, 0], P[:, 1], P[:, 2]))
        comps = _component_factors(wn, ws)
        u = tuple(_gather_component(xg[:, c], *comps[c]) for c in range(3))
        y = _rotate(u, (P[:, 3], P[:, 4], P[:, 5]), P[:, 6])
        Ys = torch.stack(
            [_deposit_component(y[c], *comps[c]) for c in range(3)], dim=1)
        Y = Ys if Y is None else Y + Ys
    return deposit_slot_sums(Y, geom)


def deposit_vector_slots(vals, t, geom: Geometry):
    """Deposit a per-slot vector [G, K, 3] through the factored s1
    weights; returns [3, nz, ny, nx]."""
    wn, ws = _axis_hats(t)
    comps = _component_factors(wn, ws)
    Y = torch.stack(
        [_deposit_component(vals[..., c], *comps[c]) for c in range(3)],
        dim=1)
    return deposit_slot_sums(Y, geom)


def gather_vector_slots(F, t, geom: Geometry):
    """Interpolate an E-staggered field at the slots through the factored
    s1 weights; returns [G, K, 3]."""
    Fg = gather_slots(F, geom)
    wn, ws = _axis_hats(t)
    comps = _component_factors(wn, ws)
    return torch.stack(
        [_gather_component(Fg[:, c], *comps[c]) for c in range(3)], dim=-1)


def implicit_current(B_p, v, valid, *, q: float, m: float, mpw: float,
                     dt: float):
    """Per-slot implicit current I_p = q mpw/(1+b^2) (v + v x b + (v.b) b)."""
    b = B_p * (0.5 * dt * q / m)
    b2 = torch.sum(b * b, dim=-1, keepdim=True)
    I_p = (q * mpw / (1.0 + b2)) * (
        v + torch.linalg.cross(v, b)
        + torch.sum(v * b, dim=-1, keepdim=True) * b
    )
    return torch.where(valid[..., None], I_p, torch.zeros_like(I_p))


def mass_trace(op: MassOp) -> torch.Tensor:
    """tr(matL) for one species without assembling (a 0-d tensor on the
    operands' device): per slot sum_c M_cc * sum_i W_c[i]^2."""
    P = op.packed
    wn, ws = _axis_hats_planes((P[:, 0], P[:, 1], P[:, 2]))
    comps = _component_factors(wn, ws)
    bx, by, bz = P[:, 3], P[:, 4], P[:, 5]
    rot_cc = (1.0 + bx * bx, 1.0 + by * by, 1.0 + bz * bz)
    total = None
    for c in range(3):
        fo, fm, fi = comps[c]
        w2 = (sum(f * f for f in fo) * sum(f * f for f in fm)
              * sum(f * f for f in fi))
        term = P[:, 6] * rot_cc[c] * w2
        total = term if total is None else total + term
    return torch.sum(total)
