"""Command-line entry point: ``python -m xpic_tpu_torch config.json``
(counterpart of ``xpic_tpu/runtime/cli.py``).

Parse config -> build simulation -> initialize -> calculate -> finalize,
with the dimensionless-units banner of ``Simulation::log_information``
(src/interfaces/simulation.cpp:114-131).  The run goes to ``cuda:0``
unless ``--device`` says otherwise; the dtype is float64 unless
``XPIC_X64=0`` (float32), on the card as on the CPU.

``"Mesh": N`` runs over N ranks (``runtime/distributed.py``).  A process
started as a rank of a group (``torchrun``, or the ``XPIC_*`` variables)
joins it.  A single process starts the N ranks itself
(``torch.multiprocessing``, ``spawn``), after building the kernels once,
so that the ranks do not race on ``build/``; a rank that fails fails
the run.  Rank r runs on ``cuda:(r % device_count)`` (``--device cpu``:
the CPU, gloo), and only rank 0 writes.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import sys

log = logging.getLogger("xpic")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="xpic_tpu_torch",
        description="particle-in-cell framework, PyTorch/CUDA port",
    )
    parser.add_argument("config", help="path to the JSON configuration file")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument(
        "--trace", metavar="DIR", default=None,
        help="capture a torch.profiler trace of the main loop into DIR "
             "(a Chrome trace, viewable with Perfetto)",
    )
    parser.add_argument(
        "--verbose", action="store_true",
        help="debug-level log: per-step migration statistics and the "
             "initial velocity-distribution histograms",
    )
    parser.add_argument(
        "--set", action="append", default=[], metavar="PATH=JSON",
        help="override a config entry, e.g. --set Geometry.t=30",
    )
    parser.add_argument(
        "--report", metavar="PATH", default=None,
        help="write a JSON summary of the run to PATH (PATH.rank<r> for "
             "each rank of a multi-rank run): the solvers' iterations, step "
             "times, particle count, kernel launches and the mesh's traffic",
    )
    parser.add_argument(
        "--device", default=None,
        help="torch device to run on (default cuda:0; 'cpu' for the "
             "plain PyTorch path of the parity tests)",
    )
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=(logging.WARNING if args.quiet
               else logging.DEBUG if args.verbose else logging.INFO),
        format="%(message)s",
    )

    import torch.distributed as dist

    from .. import kernels
    from ..config import Config
    from ..diagnostics.tables import is_writer
    from ..schemes import build_simulation
    from . import distributed

    with open(args.config) as fh:
        doc = json.load(fh)
    for override in args.set:
        path, _, raw = override.partition("=")
        try:
            value = json.loads(raw)
        except json.JSONDecodeError:
            value = raw
        node = doc
        keys = path.split(".")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = value
    cfg = Config.from_json(doc)
    if cfg.n_devices > 1 and not dist.is_initialized():
        group = distributed.launched_group()
        if group is None:
            return _spawn_ranks(cfg.n_devices, argv, args.device)
        distributed.join(*group, device=args.device)
        try:
            return main(argv)
        finally:
            distributed.leave()
    device = args.device
    if dist.is_initialized():
        device, _ = distributed.rank_device(dist.get_rank(),
                                            dist.get_world_size(), device)
        if not is_writer():
            log.setLevel(logging.WARNING)
    kernels.reset_counts()
    simulation = build_simulation(cfg, device=device)
    if os.environ.get("XPIC_RNG") == "reference":
        from ..commands.particles_load import use_reference_rng

        use_reference_rng()
        log.info("Using the reference's exact mt19937 random stream")
    if is_writer():
        os.makedirs(cfg.out_dir, exist_ok=True)
        shutil.copy(args.config, os.path.join(cfg.out_dir, "config.json"))

    g = cfg.geometry
    log.info("Note: Dimensionless units are used.")
    log.info("Geometric constants for the current setup:")
    log.info("  Lx = %.2f [c/w_pe], Nx = %d [dx], dx = %.2f", g.Lx, g.nx, g.dx)
    log.info("  Ly = %.2f [c/w_pe], Ny = %d [dy], dy = %.2f", g.Ly, g.ny, g.dy)
    log.info("  Lz = %.2f [c/w_pe], Nz = %d [dz], dz = %.2f", g.Lz, g.nz, g.dz)
    log.info("  Lt = %.2f [1/w_pe], Nt = %d [dt], dt = %.2f", g.Lt, g.nt, g.dt)
    log.info("Device %s, %s", simulation.device, simulation.dtype)

    try:
        simulation.initialize()
        if args.trace:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if simulation.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            with profile(activities=activities) as prof:
                simulation.calculate()
            os.makedirs(args.trace, exist_ok=True)
            path = os.path.join(args.trace, "trace.json")
            prof.export_chrome_trace(path)
            log.info("Profiler trace written to %s", path)
        else:
            simulation.calculate()
    finally:
        simulation.finalize()
    if args.report:
        write_report(args.report, simulation)
    return 0


def write_report(path: str, sim) -> None:
    """The run's summary as one JSON object (``--report``)."""
    import torch
    import torch.distributed as dist

    from .. import kernels
    from . import distributed

    mesh = sim.mesh
    if sim.device.type == "cuda":
        torch.cuda.synchronize(sim.device)
    doc = {
        "rank": mesh.rank, "world": mesh.world, "device": str(sim.device),
        "dtype": str(sim.dtype).removeprefix("torch."),
        "backend": dist.get_backend() if dist.is_initialized() else None,
        "shared_card": distributed.rank_device(mesh.rank, mesh.world,
                                               sim.device)[1],
        "ksp_history": list(getattr(sim, "ksp_history", [])),
        "step_s": list(sim.step_seconds),
        "count": [sp.count() for sp in sim.species],
        "launches": {k: v for k, v in kernels.LAUNCHES.items() if v},
        "mesh": {"bytes_sent": mesh.bytes_sent, "seconds": mesh.seconds,
                 "calls": dict(mesh.calls)},
    }
    # The scheme's other solver histories: ecsimcorr's correct solve and
    # consistency norm, eccapfim's outer iterations, its fast path's
    # fallbacks and each step's Crank-Nicolson loop counts (the rank's
    # own on a slab).
    for key in ("correct_ksp_history", "consistency_history", "outer_history",
                "fallback_history", "cn_history"):
        if hasattr(sim, key):
            doc[key] = list(getattr(sim, key))
    if mesh.world > 1:
        path = f"{path}.rank{mesh.rank}"
    with open(path, "w") as fh:
        json.dump(doc, fh)


def _rank_main(rank: int, world: int, init_method: str, argv, device):
    """One rank of a run that :func:`_spawn_ranks` started."""
    from . import distributed

    logging.basicConfig(
        level=logging.WARNING if "--quiet" in argv else logging.INFO,
        format="%(message)s")
    distributed.join(init_method, rank, world, device=device)
    try:
        main(argv)
    finally:
        distributed.leave()


def _spawn_ranks(world: int, argv, device) -> int:
    """Start the ``world`` ranks of a ``"Mesh"`` run from this process and
    wait for them; raises when a rank fails."""
    import torch
    import torch.multiprocessing as mp

    from . import distributed

    if device is None or torch.device(device).type == "cuda":
        from .. import kernels

        distributed.rank_device(0, world, device)  # raises without a card
        kernels.load()
    init = f"tcp://127.0.0.1:{distributed.free_port()}"
    log.info("Starting %d ranks (%s)", world, init)
    mp.spawn(_rank_main, args=(world, init, argv, device), nprocs=world,
             join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
