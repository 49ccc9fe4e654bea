"""The ECSIM slot gather: the ``slot_gather`` CUDA kernel and its plain
PyTorch twin (counterpart of ``xpic_tpu/ops/pallas_ecsim.py``'s gather;
the fused fill kernel of that module belongs to the assembled mass route,
which the port does not have yet).

Both interpolate an E-staggered field at the particle slots through the
factored s1 slot weights: E_p[g, k, c] = sum_s W_cs(t_gk) Fg[g, c, s],
with t [G, K, 3] the cell-relative positions and Fg [G, 3, 12] the slot
values (``ecsim_blocks.gather_slots``).
"""

from __future__ import annotations

import torch

from .. import kernels
from .mass_free import _axis_hats, _component_factors, _gather_component


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
