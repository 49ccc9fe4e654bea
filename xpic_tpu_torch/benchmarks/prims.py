"""The primitive-rate probes: the ``prims`` CUDA kernel and its plain
PyTorch twins (counterparts of the Pallas kernels ``k_copy`` ...
``k_reduce16`` of the JAX package's ``benchmarks/profile_pallas_prims.py``).

Each probe maps x [G, 8, 128] float32 to an array of the same shape:
``copy``; ``fma16`` and ``fma64``, chains of 16 and 64 steps
acc = acc * 1.0001 + x; ``roll8``, x plus eight rolls of x along the 128
columns; ``select16``, 16 conditional adds on row 0 of the cell;
``reduce16``, 16 row sums of x * (j + 1), broadcast to the columns.  The
twins repeat the JAX bodies op for op.
"""

from __future__ import annotations

import torch

from .. import kernels

PRIMS = ("copy", "fma16", "fma64", "roll8", "select16", "reduce16")
ROLL_SHIFTS = (1, 2, 4, 8, 16, 32, 64, 1)
ROWS, COLS = 8, 128
# float32 operations an element: a multiply and an add a chain step, an
# add a roll, a compare and an add a select, a multiply and an add a
# reduced element.
FLOPS_PER_ELEMENT = {"copy": 0, "fma16": 32, "fma64": 128, "roll8": 8,
                     "select16": 32, "reduce16": 32}
# The probes the kernel computes bit for bit like its twin: adds in the
# twin's order and selects.  The others differ by FMA contraction
# (fma16, fma64) or another summation order (reduce16).
BITWISE = ("copy", "roll8", "select16")


def _fma(x, steps):
    acc = x
    for _ in range(steps):
        acc = acc * 1.0001 + x
    return acc


def _roll8(x):
    acc = x
    for s in ROLL_SHIFTS:
        acc = acc + torch.roll(x, s, dims=2)
    return acc


def _select16(x):
    m = x[:, 0:1, :]
    acc = x
    for j in range(16):
        acc = torch.where(m > float(j), acc + x, acc)
    return acc


def _reduce16(x):
    acc = torch.zeros(x.shape[:2] + (1,), dtype=x.dtype, device=x.device)
    for j in range(16):
        acc = acc + (x * float(j + 1)).sum(2, keepdim=True)
    return acc.expand(x.shape).contiguous()


_TWINS = {
    "copy": torch.clone,
    "fma16": lambda x: _fma(x, 16),
    "fma64": lambda x: _fma(x, 64),
    "roll8": _roll8,
    "select16": _select16,
    "reduce16": _reduce16,
}


def _probe_index(name: str) -> int:
    if name not in PRIMS:
        raise ValueError(f"prims: unknown probe {name!r}; one of {PRIMS}")
    return PRIMS.index(name)


def prim_plain(x, name: str):
    """Probe ``name`` on x [G, 8, 128] in plain PyTorch."""
    _probe_index(name)
    return _TWINS[name](x)


def prim(x, name: str):
    """Probe ``name``: the ``prims`` kernel for CUDA float32 tensors, the
    plain twin for CPU tensors; raises otherwise."""
    op = _probe_index(name)
    if x.device.type == "cpu":
        return prim_plain(x, name)
    if x.device.type != "cuda":
        raise RuntimeError(f"prims: unsupported device {x.device}")
    if x.ndim != 3 or x.shape[0] < 1:
        raise ValueError(f"prims: x must be [G, {ROWS}, {COLS}] with "
                         f"G >= 1, got {tuple(x.shape)}")
    G = x.shape[0]
    kernels.check_operand("prims x", x, (G, ROWS, COLS))
    if x.data_ptr() % 16:
        raise ValueError("prims: x must be 16-byte aligned (float4 loads)")
    out = torch.empty_like(x)
    kernels.call("prims", x.data_ptr(), out.data_ptr(), G, op,
                 device=x.device)
    return out
