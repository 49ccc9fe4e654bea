"""Static SASS instruction counts of the port's kernels, from the built
library, to read what a kernel's loop body issues.

    python -m xpic_tpu_torch.benchmarks.sass_counts [--kernel NAME ...]
        [--other-root DIR]

Builds the kernels (``kernels.load``) when needed, or another
checkout's (``--other-root``, built under ``build/turns_other/`` as
``benchmarks.turns`` does), disassembles the library with the toolkit's
``cuobjdump -sass`` and counts each kernel function's instructions by
opcode (modifiers kept, predicates dropped).
Prints one JSON line: for each function whose name holds one of the
NAMEs (default: every kernel of ``kernels.SIGNATURES``), its counts and
the summary classes ``lds`` (shared loads), ``lds_vec`` (of them 64- and
128-bit), ``ffma``, ``fp32`` (FFMA, FMUL, FADD), ``shfl`` and ``total``.
A static count is what the code holds, not what a launch runs: a loop
body counts once.  Needs ``cuobjdump`` (beside ``nvcc``); no card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from collections import Counter

from .. import kernels

_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
# an instruction line: /*offset*/, an optional predicate, the opcode
_INSN = re.compile(
    r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")


def disassemble(kern=kernels) -> str:
    """The SASS listing of ``kern``'s library (a ``kernels`` module)."""
    kern.load()
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(kernels._find_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(kern.BUILD_DIR / kern.LIB_NAME)],
                         capture_output=True, text=True, check=True)
    return out.stdout


def count(sass: str) -> dict:
    """{function name: Counter of opcodes} over a ``cuobjdump -sass``
    listing."""
    funcs, current = {}, None
    for line in sass.splitlines():
        m = _FUNC.match(line)
        if m:
            current = funcs.setdefault(m.group(1), Counter())
            continue
        m = _INSN.search(line)
        if m and current is not None:
            current[m.group(1)] += 1
    return funcs


def summary(ops: Counter) -> dict:
    def total(pred):
        return sum(n for op, n in ops.items() if pred(op))

    lds = total(lambda op: op.split(".")[0] == "LDS")
    return dict(
        lds=lds,
        lds_vec=total(lambda op: op.split(".")[0] == "LDS"
                      and (".64" in op or ".128" in op)),
        ffma=total(lambda op: op.split(".")[0] == "FFMA"),
        fp32=total(lambda op: op.split(".")[0] in ("FFMA", "FMUL", "FADD")),
        shfl=total(lambda op: op.split(".")[0] == "SHFL"),
        total=sum(ops.values()))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="xpic_tpu_torch.benchmarks.sass_counts")
    parser.add_argument("--kernel", action="append", default=None,
                        help="a kernel name (repeatable; default all)")
    parser.add_argument("--other-root", default=None,
                        help="count another checkout's kernels instead")
    args = parser.parse_args(argv)
    names = args.kernel or sorted(kernels.SIGNATURES)
    kern = kernels
    if args.other_root is not None:
        from .turns import load_other

        kern = load_other(args.other_root, ())["kernels"]
    funcs = count(disassemble(kern))
    rows = {f: dict(summary(ops), opcodes=dict(sorted(ops.items())))
            for f, ops in funcs.items() if any(n in f for n in names)}
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
