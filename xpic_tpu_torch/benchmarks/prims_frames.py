"""Candidate load/store frames of the ``prims`` kernel (K8) against its
kept frame and ``copy_``, in turns, on one CUDA card.

    python -m xpic_tpu_torch.benchmarks.prims_frames [--cells G]
        [--turns T]

Builds ``prims_frames.cu`` (beside this file; it includes
``csrc/prims.cu`` for the probes' arithmetic) with ``nvcc`` into
``build/prims_frames/`` and checks every frame's output against the
probe's twin (copy, roll8 and select16 bitwise, the others within 1e-5
of max |out|).  Then it times each frame back to back
(``benchmarks.device_ms``) on x [G, 8, 128] float32 (G = 32768 by
default, as ``profile_prims``) in two states of the L2 cache, set just
before each timing:

- ``own``: the kept frame has just written the same output buffer with
  plain stores;
- ``other``: ``copy_`` has just written another buffer of the same size
  with normal-priority lines, as in ``chip_smoke.py`` phase 12's turns.

The copy probe and ``copy_`` are timed in both states, the other probes
in ``other``.  Each turn runs the list forward, the next backward.
Prints one line a reading and last one JSON line: the medians by frame,
probe and state, each frame's largest error, and the card's name and
power limit.  Without CUDA it exits non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from .. import kernels
from . import card_label, device_ms, resolve_device
from .prims import BITWISE, PRIMS, prim_plain
from .profile_prims import CELLS, make_input

SOURCE = Path(__file__).resolve().with_suffix(".cu")
LIB = kernels.BUILD_DIR.parent / "prims_frames" / "libprims_frames.so"
# Frame index -> name (prims_frames.cu's header); the last two run the
# copy probe only.
FRAMES = ("kept", "cs/cs", "cs/plain", "ldg/cs", "ldg/cg", "cs/cg",
          "noalloc/plain", "noalloc/cs", "ef/plain", "ef/ef", "w8",
          "two", "two cs/cs", "persist", "persist cs/cs", "tma4", "tma8")
COPY_ONLY = ("tma4", "tma8")
TOL = 1e-5


def build():
    """Compile the frames into their own library and bind it."""
    LIB.parent.mkdir(parents=True, exist_ok=True)
    cmd = [kernels._find_nvcc(), *kernels.NVCC_FLAGS, "-shared",
           "-I", str(kernels._CSRC), "-o", str(LIB), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(LIB))
    fn = lib.xpic_prims_frame
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def run(cells: int, turns: int, device) -> dict:
    frame_fn = build()
    x = make_input(cells, device)
    out = torch.empty_like(x)
    other = torch.empty_like(x)

    def launch(frame: int, name: str):
        def call():
            stream = torch.cuda.current_stream(device).cuda_stream
            err = frame_fn(frame, PRIMS.index(name), x.data_ptr(),
                           out.data_ptr(), cells, stream)
            if err != 0:
                raise RuntimeError(f"frame {FRAMES[frame]} {name}: CUDA "
                                   f"error {err}")
        return call

    cases = [(f, name) for f, frame in enumerate(FRAMES) for name in PRIMS
             if name == "copy" or frame not in COPY_ONLY]
    errors = {}
    for f, name in cases:
        out.fill_(float("nan"))
        launch(f, name)()
        ref = prim_plain(x, name)
        err = float((out - ref).abs().max())
        ok = (torch.equal(out, ref) if name in BITWISE
              else err <= TOL * float(ref.abs().max()))
        if not ok:
            raise SystemExit(f"prims_frames: frame {FRAMES[f]} {name} "
                             f"differs from the twin by {err:.3e}")
        errors[FRAMES[f]] = max(errors.get(FRAMES[f], 0.0), err)
        del ref

    def own():
        launch(0, "copy")()

    def dirty():
        other.copy_(x)

    timings = [(FRAMES[f], name, state, launch(f, name), prep)
               for f, name in cases
               for state, prep in (("own", own), ("other", dirty))
               if name == "copy" or state == "other"]
    timings += [("copy_", "copy", state, lambda: out.copy_(x), prep)
                for state, prep in (("own", own), ("other", dirty))]
    readings = {}
    for turn in range(turns):
        for frame, name, state, fn, prep in (timings if turn % 2 == 0
                                             else timings[::-1]):
            prep()
            ms = device_ms(fn, device)
            readings.setdefault(f"{frame} {name} {state}", []).append(ms)
    label = card_label(device)
    for key, values in readings.items():
        print(f"[prims_frames] {key}: {values} median "
              f"{statistics.median(values)} | {label}", flush=True)
    return dict(cells=cells, turns=turns,
                median_ms={k: statistics.median(v)
                           for k, v in readings.items()},
                max_abs_err=errors, device=label)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="xpic_tpu_torch.benchmarks.prims_frames")
    parser.add_argument("--cells", type=int, default=CELLS,
                        help=f"cells G of x [G, 8, 128] (default {CELLS})")
    parser.add_argument("--turns", type=int, default=4,
                        help="turns, alternately forward and backward "
                             "(default 4)")
    args = parser.parse_args(argv)
    device = resolve_device("cuda:0")
    print(json.dumps(run(args.cells, args.turns, device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
