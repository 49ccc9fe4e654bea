"""Primitive rates on one CUDA card: a pure copy, FMA chains, lane rolls,
selects and row reductions through the port's ``prims`` kernel
(counterpart of the JAX package's ``benchmarks/profile_pallas_prims.py``).

    python -m xpic_tpu_torch.benchmarks.profile_prims [--device cuda:0|cpu]
        [--cells G]

x [G, 8, 128] float32 (G = 32768 by default: 134.2 MB, more than the
card's 50 MB L2 cache, so every launch streams from device memory) is
uniform on [0, 16) from a numpy seed, so that ``select16`` takes both
branches.  Each probe is timed by CUDA events around back-to-back
launches, divided by their count, after a warm-up
(``benchmarks.device_ms``).  Prints one JSON line with the JAX script's
keys (``<probe>_ms``, ``copy_gbps``, ``fma64_tops``, ``note``) and
``device``, the card's name and power limit.  Without CUDA it exits
non-zero unless ``--device cpu`` asks for the twins on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import card_label, device_ms, resolve_device
from .prims import COLS, PRIMS, ROWS, prim

CELLS = 32768


def make_input(cells: int, device, seed: int = 0):
    """x [cells, 8, 128] float32, uniform on [0, 16)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 16.0, (cells, ROWS, COLS)).astype(np.float32)
    return torch.from_numpy(x).to(device)


def run(cells: int, device) -> dict:
    x = make_input(cells, device)
    res = {}
    for name in PRIMS:
        res[name + "_ms"] = device_ms(lambda: prim(x, name), device)
    n = x.numel()
    res["copy_gbps"] = 2 * n * 4 / res["copy_ms"] / 1e6
    res["fma64_tops"] = 128 * n / res["fma64_ms"] / 1e9
    res["note"] = ("CUDA events around back-to-back launches queued behind "
                   "a sleep kernel, divided by their count: no host "
                   "dispatch included" if device.type == "cuda" else
                   "CPU twins, host clock: not a device number")
    res["device"] = card_label(device)
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="xpic_tpu_torch.benchmarks.profile_prims")
    parser.add_argument("--device", default="cuda:0",
                        help="torch device (default cuda:0; cpu runs the "
                             "plain twins)")
    parser.add_argument("--cells", type=int, default=CELLS,
                        help=f"G, the cells of x [G, 8, 128] (default "
                             f"{CELLS})")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    print(json.dumps(run(args.cells, device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
