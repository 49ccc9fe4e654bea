"""One of this tree's kernels against another checkout's, in turns on one
CUDA card.

    python -m xpic_tpu_torch.benchmarks.turns OTHER_ROOT [--kernel NAME]
        [--side N] [--turns T]

OTHER_ROOT is the root of another checkout of the repository, for
example an earlier commit unpacked by ``git archive`` into a directory
that ``.gitignore`` lists.  Each tree builds its kernels from its own
sources; the other tree's library goes under this tree's
``build/turns_other/``, so nothing is written into OTHER_ROOT.  NAME is a
key of ``CASES`` (default ``cheb_step``): the kernel's wrapper at the
main paths' shape, on the same inputs in both trees, made from a numpy
seed.  Each turn times the other tree, this tree, this tree, the other
tree: ``ms`` back to back (``benchmarks.device_ms``, no host launch gap)
and ``call_ms`` (one call between two CUDA events, the host's gap in).
Prints one JSON line: the turns, each tree's launches a call, the
largest difference between the two trees' results and the card's name
and power limit.  Without CUDA it exits non-zero.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

import numpy as np
import torch

from . import call_ms, card_label, device_ms, resolve_device

_PKG = __package__.split(".")[0]


def _own_modules() -> dict:
    return {k: m for k, m in sys.modules.items()
            if k == _PKG or k.startswith(_PKG + ".")}


def load_other(root: str, names) -> dict:
    """The other checkout's modules ``names`` (dotted, under the package)
    and its ``kernels``, imported from ``root`` and then taken out of
    ``sys.modules``, so that this tree's package stays the one imported
    by name.  The functions keep their own modules' globals; the other
    ``kernels`` builds under this tree's ``build/turns_other/``."""
    from .. import kernels

    root = os.path.abspath(root)
    if not os.path.isdir(os.path.join(root, _PKG)):
        raise SystemExit(f"{root} holds no {_PKG} package")
    own = _own_modules()
    for name in own:
        del sys.modules[name]
    sys.path.insert(0, root)
    bytecode = sys.dont_write_bytecode
    sys.dont_write_bytecode = True
    try:
        mods = {m: importlib.import_module(f"{_PKG}.{m}")
                for m in (*names, "kernels")}
    finally:
        sys.dont_write_bytecode = bytecode
        sys.path.remove(root)
        for name in _own_modules():
            del sys.modules[name]
        sys.modules.update(own)
    mods["kernels"].BUILD_DIR = kernels.BUILD_DIR.parent / "turns_other"
    return mods


def _cheb_case(mods, device, side):
    """K1: one degree-12 Chebyshev apply on rhs [3, side, side, side]
    float32, shift 0.37 (a device scalar), periodic, dx = 0.5, dt = 1.5."""
    geom = mods["config"].Geometry(dx=0.5, dy=0.5, dz=0.5, dt=1.5, nx=side,
                                   ny=side, nz=side, nt=1)
    rng = np.random.default_rng(2)
    rhs = torch.tensor(rng.standard_normal((3, side, side, side)),
                       dtype=torch.float32, device=device)
    shift = torch.tensor(0.37, dtype=torch.float32, device=device)
    cheb = mods["ops.stencil_kernel"].cheb_matM_inv
    return lambda: cheb(rhs, shift, geom=geom, degree=12, dt=geom.dt)


# kernel -> (the modules its case calls, the case: (modules, device,
# side) -> one call of the kernel's wrapper)
CASES = {"cheb_step": (("ops.stencil_kernel", "config"), _cheb_case)}


def run(other_root: str, kernel: str, side: int, turns: int,
        device) -> dict:
    names, case = CASES[kernel]
    trees = {"this": {m: importlib.import_module(f"{_PKG}.{m}")
                      for m in (*names, "kernels")},
             "other": load_other(other_root, names)}
    calls, results, launches = {}, {}, {}
    for tree, mods in trees.items():
        calls[tree] = case(mods, device, side)
        counts = mods["kernels"]
        counts.load()
        before = counts.LAUNCHES[kernel]
        results[tree] = calls[tree]()
        launches[tree] = counts.LAUNCHES[kernel] - before
    torch.cuda.synchronize(device)
    rows = []
    for _ in range(turns):
        for tree in ("other", "this", "this", "other"):
            rows.append(dict(tree=tree, ms=device_ms(calls[tree], device),
                             call_ms=call_ms(calls[tree], device)))
    return dict(
        kernel=kernel, side=side, turns=rows, launches_per_call=launches,
        max_abs_diff=float((results["this"] - results["other"]).abs().max()),
        other_root=os.path.abspath(other_root), device=card_label(device))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="xpic_tpu_torch.benchmarks.turns")
    parser.add_argument("other_root",
                        help="root of the other checkout to time against")
    parser.add_argument("--kernel", choices=sorted(CASES),
                        default="cheb_step", help="the kernel to time")
    parser.add_argument("--side", type=int, default=32,
                        help="cells a side of the field (default 32)")
    parser.add_argument("--turns", type=int, default=2,
                        help="turns of other, this, this, other (default 2)")
    args = parser.parse_args(argv)
    device = resolve_device("cuda:0")
    print(json.dumps(run(args.other_root, args.kernel, args.side, args.turns,
                         device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
