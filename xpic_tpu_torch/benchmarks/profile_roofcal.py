"""Calibrate one CUDA card with PyTorch library calls: the host's dispatch
floor, streaming and reduction rates, a relayout, rolls, the float32
matmul rate and the batched tiny matmul at the assemble shape
(counterpart of the JAX package's ``benchmarks/profile_roofcal.py``).

    python -m xpic_tpu_torch.benchmarks.profile_roofcal [--device cuda:0|cpu]
        [--cells G]

The port's yardstick: it has no kernel of its own, and separates "the
port's kernels are slow" from "the card reaches less than its data
sheet".  The shapes are the JAX script's at the default G = 32768 and
scale with G:

* ``dispatch_ms``: the host clock around ``x + 1`` on [8, 128] and a
  synchronize, averaged over many calls: the floor that a
  host-synchronised loop (the port's GMRES) pays each time;
* ``stream``: ``x + 1`` on [G/64, 1024, 128] (256 MB), read and written;
  ``reduce``: its ``sum`` over the last two axes, read once;
* ``swap``: ``swapaxes(1, 2).contiguous()`` of [G, 8, 96];
* ``roll``: ``roll(V, 1, 0) + roll(V, -1, 1)`` on [G/1024, 32, 32, 128]
  (16.8 MB, inside the 50 MB L2 cache), four passes of V counted;
* ``matmul``: [G/8, G/8] @ [G/8, G/8] (4096^2);
* ``bmm``: [G, 12, 80] x [G, 80, 36];
* ``lanered``: ``(x * x).sum(-1)`` of [12 G, 80], read once.

The float32 products run in IEEE float32: the package pins TF32 off, and
``note`` says so.  Every time but ``dispatch_ms`` comes from CUDA events
around back-to-back calls (``benchmarks.device_ms``).  Prints one JSON
line with the JAX script's keys and ``device``; without CUDA it exits
non-zero unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import card_label, device_ms, host_sync_ms, resolve_device

CELLS = 32768


def run(cells: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(0)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    res = {}
    tiny = rand(8, 128)
    res["dispatch_ms"] = host_sync_ms(lambda: tiny + 1.0, device)

    big = rand(max(1, cells // 64), 1024, 128)
    ms = device_ms(lambda: big + 1.0, device)
    res["stream_ms"] = ms
    res["stream_gbps"] = 2 * big.numel() * 4 / ms / 1e6
    ms = device_ms(lambda: big.sum(dim=(1, 2)), device)
    res["reduce_ms"] = ms
    res["reduce_gbps"] = big.numel() * 4 / ms / 1e6
    del big

    P = rand(cells, 8, 96)
    ms = device_ms(lambda: torch.swapaxes(P, 1, 2).contiguous(), device)
    res["swap_ms"] = ms
    res["swap_gbps"] = 2 * P.numel() * 4 / ms / 1e6
    del P

    V = rand(max(1, cells // 1024), 32, 32, 128)
    ms = device_ms(lambda: torch.roll(V, 1, 0) + torch.roll(V, -1, 1),
                   device)
    res["roll_ms"] = ms
    res["roll_gbps"] = 4 * V.numel() * 4 / ms / 1e6

    n = max(8, cells // 8)
    a = rand(n, n)
    ms = device_ms(lambda: a @ a, device)
    res["matmul_ms"] = ms
    res["matmul_tflops"] = 2 * n ** 3 / ms / 1e9
    del a

    K = 80
    w, t2 = rand(cells, 12, K), rand(cells, K, 36)
    ms = device_ms(lambda: torch.bmm(w, t2), device)
    res["bmm_ms"] = ms
    res["bmm_tflops"] = 2 * cells * 12 * K * 36 / ms / 1e9
    del w, t2

    x = rand(cells * 12, K)
    ms = device_ms(lambda: (x * x).sum(-1), device)
    res["lanered_ms"] = ms
    res["lanered_gbps"] = x.numel() * 4 / ms / 1e6

    res["note"] = (
        f"float32 products in IEEE float32 (matmul allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}, float32 matmul "
        f"precision {torch.get_float32_matmul_precision()!r}); "
        + ("CUDA events around back-to-back calls, dispatch_ms by the host "
           "clock" if device.type == "cuda" else
           "CPU, host clock: not a device number"))
    res["device"] = card_label(device)
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="xpic_tpu_torch.benchmarks.profile_roofcal")
    parser.add_argument("--device", default="cuda:0",
                        help="torch device (default cuda:0)")
    parser.add_argument("--cells", type=int, default=CELLS,
                        help=f"G, which every shape scales with (default "
                             f"{CELLS}: the JAX script's shapes)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    print(json.dumps(run(args.cells, device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
