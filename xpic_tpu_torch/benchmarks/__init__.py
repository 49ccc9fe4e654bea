"""The port's chip-calibration path: what one CUDA card attains, measured
by the port's own probe kernel and by PyTorch library calls.

    python -m xpic_tpu_torch.benchmarks.profile_prims [--device D] [--cells G]
    python -m xpic_tpu_torch.benchmarks.profile_roofcal [--device D] [--cells G]

Counterparts of the JAX package's ``benchmarks/profile_pallas_prims.py``
(``profile_prims``, with the ``prims`` CUDA kernel of ``prims.py``) and
``benchmarks/profile_roofcal.py`` (``profile_roofcal``).  Both print one
JSON line with the JAX scripts' keys, plus ``device``.  They run on
``cuda:0`` unless asked for the CPU; without CUDA they exit non-zero
rather than fall back.  A CPU run times PyTorch's CPU kernels with the
host clock and is never a device number.

    python -m xpic_tpu_torch.benchmarks.turns OTHER_ROOT [--kernel NAME]

times one of this tree's kernels against another checkout's, in turns;

    python -m xpic_tpu_torch.benchmarks.prims_frames [--cells G]

times candidate load/store frames of the ``prims`` kernel against its
kept frame and ``copy_``.  Both run on the card only.  This module
holds what the scripts and ``chip_smoke.py`` share: the timers and the
card's name.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

# Cycles a millisecond of the H100 SXM's highest SM clock (1.98 GHz),
# rounded up: a sleep of n of them lasts at least n / 2e6 ms.
_SLEEP_CYCLES_PER_MS = 2.0e6


def resolve_device(name: str) -> torch.device:
    """The device an entry point runs on; exits non-zero when it asks
    for CUDA and there is none (no fallback to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"no CUDA device for {name}: this measures the "
                         "card; pass --device cpu for a CPU run")
    if dev.type not in ("cuda", "cpu"):
        raise SystemExit(f"unsupported device {name}")
    return dev


def card_label(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them
    (``--query-gpu=name,power.limit``), or ``"cpu"``."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_ms(fn, device: torch.device) -> float:
    """The time of one call of ``fn`` in ms: R calls back to back between
    two CUDA events, divided by R, after a warm-up call.

    R fits about 50 ms of calls, 3 to 32 of them (a call may be several
    launches, and the stream's queue holds about a thousand).  Before the
    start event the stream spins in a sleep kernel for four times the
    host's enqueue time of R calls, so the host has queued them all when
    the device reaches them: the time has no host launch gap in it.  A
    call that waits for the device inside (a host read) still puts its
    gap in; the result is then an upper bound.  On the CPU: the host
    clock over R calls.
    """
    fn()
    _sync(device)
    t0 = time.perf_counter()
    fn()
    enqueue = time.perf_counter() - t0
    _sync(device)
    whole = time.perf_counter() - t0
    reps = int(min(32, max(3, 50.0 / max(whole * 1e3, 1e-3))))
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(device):
        torch.cuda._sleep(int((4 * reps * enqueue * 1e3 + 2.0)
                              * _SLEEP_CYCLES_PER_MS))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def call_ms(fn, device: torch.device, reps: int = 20) -> float:
    """The median of ``reps`` CUDA-event timings of one call of ``fn``
    after a warm-up: the host's launch gap is in it."""
    fn()
    _sync(device)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_sync_ms(fn, device: torch.device, reps: int = 200) -> float:
    """The host clock around ``fn`` and a synchronize, averaged over
    ``reps`` calls after a warm-up: the floor a host-synchronised loop
    pays each time."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        _sync(device)
    return (time.perf_counter() - t0) / reps * 1e3
