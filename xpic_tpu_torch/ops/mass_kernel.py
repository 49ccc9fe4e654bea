"""The per-cell matrix-free mass apply: the ``mass_apply`` CUDA kernel
and its plain PyTorch twin (counterpart of ``xpic_tpu/ops/pallas_mass.py``).

For one species' packed operands [G, 8, K] (channel rows tx, ty, tz, bx,
by, bz, coef, 0; ``mass_free.mass_operands``) and the slot values of x
[G, 3, 12] (``ecsim_blocks.gather_slots``), both compute
Y[g, c, s] = sum_k W_cs(t_gk) (M_gk u_gk)_c with u_c = sum_s W_cs xg[g, c, s]
and M v = coef (v + (b.v) b + v x b): the bilinear form W^T M W per cell.
The gather of x before it and the deposit of Y after it stay PyTorch ops
(``mass_free.mass_apply``), as they stay XLA ops around the TPU kernel.
"""

from __future__ import annotations

import torch

from .. import kernels
from .mass_free import (
    _axis_hats_planes,
    _component_factors,
    _deposit_component,
    _gather_component,
    _rotate,
)


def mass_apply_slots_plain(xg, packed):
    """The factored gather / rotate / deposit chain in plain PyTorch:
    Y [G, 3, 12] in the dtype of the operands."""
    P = packed
    wn, ws = _axis_hats_planes((P[:, 0], P[:, 1], P[:, 2]))
    comps = _component_factors(wn, ws)
    u = tuple(_gather_component(xg[:, c], *comps[c]) for c in range(3))
    y = _rotate(u, (P[:, 3], P[:, 4], P[:, 5]), P[:, 6])
    return torch.stack(
        [_deposit_component(y[c], *comps[c]) for c in range(3)], dim=1)


def mass_apply_slots(xg, packed):
    """Y = W^T M W xg per cell: the ``mass_apply`` kernel for CUDA
    float32 tensors, the plain twin for CPU tensors; raises otherwise."""
    if packed.device.type == "cpu":
        return mass_apply_slots_plain(xg, packed)
    if packed.device.type != "cuda":
        raise RuntimeError(f"mass_apply: unsupported device {packed.device}")
    if packed.ndim != 3 or packed.shape[1] != 8 or packed.shape[2] < 1:
        raise ValueError(f"mass_apply: packed must be [G, 8, K], got "
                         f"{tuple(packed.shape)}")
    G, _, K = packed.shape
    kernels.check_operand("mass_apply packed", packed, (G, 8, K))
    kernels.check_operand("mass_apply xg", xg, (G, 3, 12))
    if xg.device != packed.device:
        raise ValueError("mass_apply: tensors on different devices")
    Y = torch.empty((G, 3, 12), dtype=torch.float32, device=packed.device)
    kernels.call("mass_apply", xg.data_ptr(), packed.data_ptr(),
                 Y.data_ptr(), G, K, device=packed.device)
    return Y
