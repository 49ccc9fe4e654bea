"""Where the time of the config-driven run goes on one CUDA card.

    python -m xpic_tpu_torch.runtime.step_profile cfg.json [--device D]

Runs the config like ``python -m xpic_tpu_torch cfg.json`` (float32:
``XPIC_X64=0``; ``cuda:0`` unless ``--device`` says otherwise) and prints
one JSON object:

* ``phases_ms``: the median time of each ECSIM phase over the steps before
  the window, every phase closed by ``torch.cuda.synchronize()``
  (``first_push`` includes ``fill_ecsim_current``; ecsimcorr adds
  ``correct_fields``); ``step_ms`` their sum;
* ``parts_ms``: the median time a step of the functions inside those
  phases that ``ECSIM_PARTS`` names (each call closed by a
  synchronisation): ecsimcorr's Esirkepov deposits, and the assembled
  route's fill (the ``ecsim_fill`` kernel on the card);
* ``diagnostics_ms``: the median time of each diagnostic's ``diagnose``
  per diagnose step, synchronised the same way;
* ``window``: the last two steps, each under ``torch.profiler``
  without the extra synchronisations (the diagnostics run between them,
  outside it): their wall time, the device time (the sum of the
  device-side events), the device's idle share, and the device time of
  the busiest kernels by name.

For an eccapfim config the phases are the parts of the nonlinear solve
(``ECCAPFIM_PHASES``), each summed over the step's calls and closed by a
synchronisation: the window-block build, the ``segment_fields`` kernel
(K6), the one-segment and zero-displacement gathers, the current deposit
with its scatter onto the grid, the Anderson mixing, the migration, and
the rest of ``calc_iteration`` (the Picard updates, the Maxwell residual
and its preconditioner).  It adds ``outer_iters_per_step``,
``cn_iters_per_sweep``, ``fast_path_fallback_steps``, K6's share of
``calc_iteration``, and on the card
``eccapfim_particle_push_throughput`` in particle-steps/s.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from collections import defaultdict

import torch

PHASES = ("clear_sources", "first_push", "fill_ecsim_current",
          "advance_fields", "second_push", "final_update")
ECSIMCORR_PHASES = PHASES + ("correct_fields",)
# ECSIM-family part -> (module, function names) timed for it inside the
# phases.
ECSIM_PARTS = {
    "esirkepov_current": ("schemes.ecsimcorr", ("esirkepov_current",)),
    "ecsim_fill": ("parallel.step", ("ecsim_fill",)),
}
ECCAPFIM_PHASES = ("window_blocks", "segment_fields", "one_segment",
                   "deposit", "anderson", "migration", "calc_other")
# eccapfim phase -> (module, function names) timed for it; the module
# names are those the scheme's code looks up when it calls them.
_ECCAPFIM_HOOKS = {
    "window_blocks": ("schemes.eccapfim", ("gather_window_blocks",)),
    "segment_fields": ("schemes.eccapfim", ("segment_fields",)),
    "one_segment": ("schemes.eccapfim", ("_one_segment_fields",
                                         "_rest_fields")),
    "deposit": ("schemes.eccapfim", ("deposit_J_implicit",
                                     "scatter_blocks")),
    "anderson": ("solvers.anderson", ("_push_window", "_mix")),
    "migration": ("schemes.eccapfim", ("_commit_state",)),
}
WINDOW, TOP_KERNELS = 2, 12


def _sync(device: torch.device):
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def _timed(fn, sync, times: list):
    def run(*args, **kwargs):
        sync()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        return out
    return run


def _diag_name(diag) -> str:
    what = getattr(diag, "field_name", None) or getattr(diag, "moment", None)
    return type(diag).__name__ + (f"[{what}]" if what else "")


def _kernel_name(name: str) -> str:
    """A device event's name without its argument list."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0] or name


def device_window(fns, device: torch.device, after=None) -> dict:
    """Run each of ``fns`` under its own ``torch.profiler`` window (and
    ``after(i)`` outside it) and sum: host wall time (closed by a
    synchronisation), device time (the device-side events), the idle
    share, and the busiest kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    sync = _sync(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    wall_ms, by_name = 0.0, defaultdict(lambda: [0.0, 0])
    for i, fn in enumerate(fns):
        sync()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn()
            sync()
            wall_ms += (time.perf_counter() - t0) * 1e3
        for evt in prof.events():
            if evt.device_type != torch.autograd.DeviceType.CPU:
                row = by_name[_kernel_name(evt.name)]
                row[0] += evt.time_range.elapsed_us() / 1e3
                row[1] += 1
        if after is not None:
            after(i)
    busy_ms = sum(ms for ms, _ in by_name.values())
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]
    return {
        "runs": len(fns),
        "wall_ms": wall_ms,
        "device_ms": busy_ms if by_name else None,
        "idle_share": (1.0 - busy_ms / wall_ms) if by_name else None,
        "kernels_ms": {n: {"ms": ms, "calls": c} for n, (ms, c) in kernels},
    }


def profile_run(sim) -> dict:
    """Run ``sim`` (built, not initialized) to its end; the last
    ``WINDOW`` steps under ``torch.profiler``."""
    if sim.scheme_name == "eccapfim":
        return _profile_eccapfim(sim)
    sync = _sync(sim.device)
    nt = sim.geom.nt
    if nt <= WINDOW:
        raise ValueError(f"{nt} steps leave none before a {WINDOW}-step "
                         f"window")
    sim.initialize()
    phase_names = (ECSIMCORR_PHASES if sim.scheme_name == "ecsimcorr"
                   else PHASES)
    phase_t = defaultdict(list)
    diag_t = defaultdict(list)
    for name in phase_names:
        setattr(sim, name, _timed(getattr(sim, name), sync, phase_t[name]))
    for diag in sim.diagnostics:
        diag.diagnose = _timed(diag.diagnose, sync, diag_t[_diag_name(diag)])
    acc: dict = {}
    parts_t = defaultdict(list)
    patched = _patch(ECSIM_PARTS, sync, acc)

    def step(t):  # one iteration of Simulation.calculate's loop
        for command in sim.step_presets:
            command.execute(t)
        sim.timestep_implementation(t)

    def diagnose(t):
        for diag in sim.diagnostics:
            diag.diagnose(t)

    try:
        for t in range(1, nt - WINDOW + 1):
            acc.clear()
            step(t)
            for part in ECSIM_PARTS:
                parts_t[part].append(acc.get(part, 0.0))
            diagnose(t)
    finally:
        _unpatch(patched)
    for name in phase_names:
        delattr(sim, name)

    steps = range(nt - WINDOW + 1, nt + 1)
    win = device_window([lambda t=t: step(t) for t in steps], sim.device,
                        after=lambda i: diagnose(steps[i]))
    sim.finalize()

    phases = {n: statistics.median(v) for n, v in phase_t.items()}
    extra = {}
    if sim.scheme_name == "ecsimcorr":
        extra = {"correct_ksp_iters": sim.correct_ksp_iters,
                 "consistency_norm": sim.current_consistency_norm}
    return {
        **extra,
        "steps_timed": nt - WINDOW,
        "phases_ms": phases,
        "step_ms": sum(v for n, v in phases.items()
                       if n != "fill_ecsim_current"),
        "parts_ms": {n: statistics.median(v) for n, v in parts_t.items()},
        "mass": sim.mass,
        "diagnostics_ms": {n: statistics.median(v)
                           for n, v in diag_t.items()},
        "window": win,
        "ksp_history": list(sim.ksp_history),
    }


def _summed(fn, sync, acc: dict, key: str):
    """``fn`` closed by synchronisations, its time added to acc[key]."""
    def run(*args, **kwargs):
        sync()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync()
        acc[key] = acc.get(key, 0.0) + (time.perf_counter() - t0) * 1e3
        return out
    return run


def _patch(hooks: dict, sync, acc: dict) -> list:
    """Replace each function that ``hooks`` names (key -> (module, names))
    in its module by a :func:`_summed` version adding to acc[key];
    returns what :func:`_unpatch` restores."""
    import importlib

    patched = []
    for key, (mod, names) in hooks.items():
        module = importlib.import_module(f"{__package__.rsplit('.', 1)[0]}"
                                         f".{mod}")
        for name in names:
            fn = getattr(module, name)
            patched.append((module, name, fn))
            setattr(module, name, _summed(fn, sync, acc, key))
    return patched


def _unpatch(patched: list) -> None:
    for module, name, fn in patched:
        setattr(module, name, fn)


def _profile_eccapfim(sim) -> dict:
    sync = _sync(sim.device)
    nt = sim.geom.nt
    if nt <= WINDOW:
        raise ValueError(f"{nt} steps leave none before a {WINDOW}-step "
                         f"window")
    sim.initialize()
    acc: dict = {}
    patched = _patch(_ECCAPFIM_HOOKS, sync, acc)
    phase_t, step_t, diag_t = defaultdict(list), [], defaultdict(list)

    def step(t):  # one iteration of Simulation.calculate's loop
        for command in sim.step_presets:
            command.execute(t)
        sim.timestep_implementation(t)

    try:
        for t in range(1, nt - WINDOW + 1):
            acc.clear()
            sync()
            t0 = time.perf_counter()
            step(t)
            sync()
            step_t.append((time.perf_counter() - t0) * 1e3)
            calc = sim.phase_timings["calc_iteration"] * 1e3
            acc["calc_other"] = calc - sum(
                v for k, v in acc.items() if k != "migration")
            for phase in ECCAPFIM_PHASES:
                phase_t[phase].append(acc.get(phase, 0.0))
            for diag in sim.diagnostics:
                _timed(diag.diagnose, sync, diag_t[_diag_name(diag)])(t)
    finally:
        _unpatch(patched)

    steps = range(nt - WINDOW + 1, nt + 1)
    win = device_window(
        [lambda t=t: step(t) for t in steps], sim.device,
        after=lambda i: [d.diagnose(steps[i]) for d in sim.diagnostics])
    sim.finalize()

    timed = nt - WINDOW
    phases = {n: statistics.median(v) for n, v in phase_t.items()}
    step_ms = statistics.median(step_t)
    n_particles = sum(sp.count() for sp in sim.species)
    sweeps = [c for counts in sim.cn_history[:timed] for c in counts]
    calc_ms = sum(phases[n] for n in ECCAPFIM_PHASES if n != "migration")
    return {
        "steps_timed": timed,
        "phases_ms": phases,
        "step_ms": step_ms,
        "segment_fields_share_of_calc_iteration":
            phases["segment_fields"] / calc_ms if calc_ms > 0 else None,
        "outer_iters_per_step": statistics.mean(sim.outer_history[:timed]),
        "cn_iters_per_sweep": statistics.mean(sweeps) if sweeps else 0.0,
        "fast_path_fallback_steps": sum(sim.fallback_history),
        "eccapfim_particle_push_throughput":
            (n_particles / step_ms * 1e3 if sim.device.type == "cuda"
             else None),
        "diagnostics_ms": {n: statistics.median(v)
                           for n, v in diag_t.items()},
        "window": win,
        "outer_history": list(sim.outer_history),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="xpic_tpu_torch.runtime.step_profile")
    parser.add_argument("config", help="path to the JSON configuration file")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda:0)")
    args = parser.parse_args(argv)

    os.environ.setdefault("XPIC_X64", "0")
    from ..config import Config
    from ..schemes import build_simulation

    with open(args.config) as fh:
        cfg = Config.from_json(json.load(fh))
    sim = build_simulation(cfg, device=args.device)
    out = profile_run(sim)
    out["device"] = (torch.cuda.get_device_name(sim.device)
                     if sim.device.type == "cuda" else str(sim.device))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
