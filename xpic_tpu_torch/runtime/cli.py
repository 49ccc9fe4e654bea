"""Command-line entry point: ``python -m xpic_tpu_torch config.json``
(counterpart of ``xpic_tpu/runtime/cli.py``).

Parse config -> build simulation -> initialize -> calculate -> finalize,
with the dimensionless-units banner of ``Simulation::log_information``
(src/interfaces/simulation.cpp:114-131).  The run goes to ``cuda:0``
unless ``--device`` says otherwise; the dtype is float64 unless
``XPIC_X64=0`` (float32, the card's dtype).
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
        "--device", default=None,
        help="torch device to run on (default cuda:0; 'cpu' for the "
             "float64 parity path)",
    )
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=(logging.WARNING if args.quiet
               else logging.DEBUG if args.verbose else logging.INFO),
        format="%(message)s",
    )

    from ..config import Config
    from ..schemes import build_simulation

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
    simulation = build_simulation(cfg, device=args.device)
    if os.environ.get("XPIC_RNG") == "reference":
        from ..commands.particles_load import use_reference_rng

        use_reference_rng()
        log.info("Using the reference's exact mt19937 random stream")
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
