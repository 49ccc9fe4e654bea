"""The ECSIM slot kernels and their plain PyTorch twins (counterpart of
``xpic_tpu/ops/pallas_ecsim.py``): the ``slot_gather`` kernel (the push's
E gather on both mass routes) and the ``ecsim_fill`` kernel (the fill of
the assembled route).

``ecsim_gather`` interpolates an E-staggered field at the particle slots
through the factored s1 slot weights: E_p[g, k, c] = sum_s W_cs(t_gk)
Fg[g, c, s], with t [G, K, 3] the cell-relative positions and Fg
[G, 3, 12] the slot values (``ecsim_blocks.gather_slots``).

``ecsim_fill`` computes, per cell, the mass blocks L [G, 3, 12, 3, 12]
and the slot sums of the implicit current Islot [G, 3, 12] =
sum_k I_p[g, k, c] W[g, k, c, s] from (t, v, B_p, valid).
"""

from __future__ import annotations

import torch

from .. import kernels
from .ecsim_blocks import assemble_blocks, ecsim_particle_terms, \
    s1_slot_weights
from .mass_free import _axis_hats, _component_factors, _gather_component

# Float operations of one fill a live slot: 9 [12] x [12] outer products of
# multiply-adds, and ~40 for the weights and the particle terms
# (``pallas_ecsim.ecsim_fill_pallas``'s cost estimate).
FILL_FLOPS_PER_SLOT = 2 * 9 * 12 * 12 + 40
# Slots the wrapper takes: every K that ``choose_slots`` gives the schemes.
FILL_MAX_K = 512


def ecsim_gather_plain(t, Fg):
    """E_p [G, K, 3] through the factored weights in plain PyTorch."""
    wn, ws = _axis_hats(t)
    comps = _component_factors(wn, ws)
    return torch.stack(
        [_gather_component(Fg[:, c], *comps[c]) for c in range(3)], dim=-1)


def ecsim_gather(t, Fg):
    """E_p [G, K, 3]: the ``slot_gather`` kernel for CUDA float32
    tensors, the plain twin for CPU tensors; raises otherwise."""
    if t.device.type == "cpu":
        return ecsim_gather_plain(t, Fg)
    if t.device.type != "cuda":
        raise RuntimeError(f"slot_gather: unsupported device {t.device}")
    if t.ndim != 3 or t.shape[2] != 3 or t.shape[1] < 1:
        raise ValueError(f"slot_gather: t must be [G, K, 3], got "
                         f"{tuple(t.shape)}")
    G, K, _ = t.shape
    kernels.check_operand("slot_gather t", t, (G, K, 3))
    kernels.check_operand("slot_gather Fg", Fg, (G, 3, 12))
    if Fg.device != t.device:
        raise ValueError("slot_gather: tensors on different devices")
    out = torch.empty((G, K, 3), dtype=torch.float32, device=t.device)
    kernels.call("slot_gather", t.data_ptr(), Fg.data_ptr(), out.data_ptr(),
                 G, K, device=t.device)
    return out


def ecsim_fill_plain(t, v, B_p, valid, *, q, m, mpw, dt):
    """(L [G, 3, 12, 3, 12], Islot [G, 3, 12]) in plain PyTorch, in the
    inputs' dtype."""
    W = s1_slot_weights(t)
    I_p, M = ecsim_particle_terms(B_p, v, valid, q=q, m=m, mpw=mpw, dt=dt)
    Islot = torch.einsum("gkc,gkcs->gcs", I_p, W)
    return assemble_blocks(W, M), Islot


def ecsim_fill(t, v, B_p, valid, *, q, m, mpw, dt):
    """(L, Islot): the ``ecsim_fill`` kernel for CUDA float32 tensors, the
    plain twin for CPU tensors; raises otherwise."""
    if t.device.type == "cpu":
        return ecsim_fill_plain(t, v, B_p, valid, q=q, m=m, mpw=mpw, dt=dt)
    if t.device.type != "cuda":
        raise RuntimeError(f"ecsim_fill: unsupported device {t.device}")
    if t.ndim != 3 or t.shape[2] != 3 or not 1 <= t.shape[1] <= FILL_MAX_K:
        raise ValueError(f"ecsim_fill: t must be [G, K, 3] with 1 <= K <= "
                         f"{FILL_MAX_K}, got {tuple(t.shape)}")
    G, K, _ = t.shape
    for name, T in (("t", t), ("v", v), ("B_p", B_p)):
        kernels.check_operand(f"ecsim_fill {name}", T, (G, K, 3))
    if valid.dtype != torch.bool or tuple(valid.shape) != (G, K) \
            or not valid.is_contiguous():
        raise ValueError(f"ecsim_fill: valid must be a contiguous bool "
                         f"[G, K] tensor, got {valid.dtype} "
                         f"{tuple(valid.shape)}")
    if any(T.device != t.device for T in (v, B_p, valid)):
        raise ValueError("ecsim_fill: tensors on different devices")
    L = torch.empty((G, 3, 12, 3, 12), dtype=torch.float32, device=t.device)
    Islot = torch.empty((G, 3, 12), dtype=torch.float32, device=t.device)
    kernels.call("ecsim_fill", t.data_ptr(), v.data_ptr(), B_p.data_ptr(),
                 valid.data_ptr(), L.data_ptr(), Islot.data_ptr(), G, K,
                 0.5 * dt * q / m, 0.5 * dt * dt * mpw * q * q / m, q * mpw,
                 device=t.device)
    return L, Islot
