"""eccapfim's segment-field gather: the ``segment_fields`` CUDA kernel and
its plain PyTorch twin (counterpart of ``xpic_tpu/ops/pallas_implicit.py``
and of the einsum route of ``xpic_tpu/schemes/eccapfim._segment_fields``).

Both return the path-averaged (E_p, B_p) [G, K, 3] over the <= 4-segment
split of each move t0 -> tn (cell-relative [G, K, 3]) against the window
blocks [G, 3, 6, 6, 6] (eccapfim/particles.cpp:104-124): the sum over
segments of the segment's length fraction times its implicit-Esirkepov
E gather and its magnetic Yee B gather at the midpoint.
"""

from __future__ import annotations

import torch

from .. import kernels
from .implicit_esirkepov import (
    MAXSEG,
    WIDTH,
    gather_B_implicit,
    gather_E_implicit,
    split_segments,
)

# Floating-point operations of one segment of non-zero length in the kernel,
# which sums only over the window offsets of the nonzero weights:
# positions 18; the first offset of 15 supports, 7 each; per axis 2 S1
# weights of 4 and 14 S2 weights of 10; E 3 x (8 FMAs for the
# (2 sn + s0) / (2 s0 + sn) combinations, 32 + 32 + 8 FMAs, 1 add);
# B 3 x 39 FMAs; the slot's sum 2 + 6 FMAs.  (The full 6^3 loops take
# 3,904.)
FLOPS_PER_SEGMENT = (18 + 15 * 7 + 3 * (2 * 4 + 14 * 10)
                     + 3 * (2 * (8 + 72) + 1) + 3 * 2 * 39 + 2 + 2 * 6)


def segment_fields_plain(Eblk, Bblk, t0, tn):
    """The path-averaged (E_p, B_p) through the staged products of
    ``ops/implicit_esirkepov``, in the dtype of the inputs."""
    taus = split_segments(t0, tn)  # [G, K, MAXSEG+1]
    d = tn - t0
    E_p = 0.0
    B_p = 0.0
    for s in range(MAXSEG):
        a = taus[..., s][..., None]
        b = taus[..., s + 1][..., None]
        seg0 = t0 + a * d
        seg1 = t0 + b * d
        bs = b - a  # = ds/|d| for a straight path
        E_p = E_p + bs * gather_E_implicit(Eblk, seg0, seg1)
        B_p = B_p + bs * gather_B_implicit(Bblk, 0.5 * (seg0 + seg1))
    return E_p, B_p


def live_segments(t0, tn) -> int:
    """Segments of non-zero length over all slots: the kernel's work."""
    taus = split_segments(t0, tn)
    return int(torch.sum(taus[..., 1:] != taus[..., :-1]))


def segment_fields(Eblk, Bblk, t0, tn):
    """(E_p, B_p) [G, K', 3]: the ``segment_fields`` kernel for CUDA
    float32 or float64 tensors (``segment_fields_f64``), the plain twin
    for CPU tensors; raises otherwise.
    ``t0`` and ``tn`` may be column slices ``[:, :kc]`` of [G, K, 3]
    tensors: the kernel reads them in place through their row stride."""
    if t0.device.type == "cpu":
        return segment_fields_plain(Eblk, Bblk, t0, tn)
    if t0.device.type != "cuda":
        raise RuntimeError(f"segment_fields: unsupported device {t0.device}")
    if t0.ndim != 3 or t0.shape[2] != 3 or t0.shape[1] < 1:
        raise ValueError(f"segment_fields: t0 must be [G, K, 3], got "
                         f"{tuple(t0.shape)}")
    G, K, _ = t0.shape
    win = (G, 3, WIDTH, WIDTH, WIDTH)
    kname = kernels.entry("segment_fields", Eblk)
    kernels.check_operand("segment_fields Eblk", Eblk, win, Eblk.dtype)
    kernels.check_operand("segment_fields Bblk", Bblk, win, Eblk.dtype)
    for name, T in (("t0", t0), ("tn", tn)):
        if T.dtype != Eblk.dtype:
            raise TypeError(f"segment_fields {name}: {Eblk.dtype} required "
                            f"(the windows' dtype), got {T.dtype}")
        if (tuple(T.shape) != (G, K, 3) or T.stride()[1:] != (3, 1)
                or T.stride(0) != t0.stride(0)):
            raise ValueError(
                f"segment_fields {name}: expected [G, K, 3] rows of "
                f"contiguous slots sharing t0's row stride, got shape "
                f"{tuple(T.shape)} strides {T.stride()}")
    if not (Eblk.device == Bblk.device == tn.device == t0.device):
        raise ValueError("segment_fields: tensors on different devices")
    if Eblk.data_ptr() % 16 or Bblk.data_ptr() % 16:
        raise ValueError("segment_fields: the windows must start on a "
                         "16-byte boundary (the kernel reads them 16 bytes "
                         "at a time)")
    E_p = torch.empty((G, K, 3), dtype=t0.dtype, device=t0.device)
    B_p = torch.empty_like(E_p)
    kernels.call(kname, Eblk.data_ptr(), Bblk.data_ptr(),
                 t0.data_ptr(), tn.data_ptr(), E_p.data_ptr(),
                 B_p.data_ptr(), G, K, t0.stride(0),
                 device=t0.device)
    return E_p, B_p
