"""Drive the PyTorch port's main paths once on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``xpic_tpu_torch/csrc`` (into
``build/``), holds each against its plain PyTorch twin at the shapes of
the main paths, runs 10 fused ECSIM steps at 32^3 cells x 50 particles
per cell in float32 (the flagship workload of ``bench.py``), runs the
config-driven path (``python -m xpic_tpu_torch cfg.json``) at the same
size for an ECSIM, an eccapfim and an ecsimcorr config (the last on both
mass routes), and checks the card's results against the CPU's at a
smaller size.  Phases:

1. device: card name and power limit, the IEEE float32 pins;
2. build: one nvcc per source for sm_90a, with ptxas's register and
   spill lines;
3. kernels against twins: the rebin exchange bitwise at AT = 8, 16, 32,
   64 and 128; the Chebyshev apply to 1e-5 relative; the mass apply at
   K = 80 and 96 to 1e-5 of max |Y|; the slot gather at K = 80 to 2e-6
   of max |E_p|; times by CUDA events beside each kernel's bound;
4. fused path: 10 steps through the kernels (every launch count grows;
   the migration loses no particle beyond genuine K overflow);
5. card against CPU: 2 fused steps at 16^3 x 50 ppc;
6. config-driven path: ``runtime.cli.main`` on a 32^3 x 50 ppc ECSIM
   config (uniform B0 = 0.2 z, field and density dumps, 5 steps, float32)
   through all five kernels: finite tables, 0 < KSP < 100, the energy
   identity within 1e-4 of the total energy, no particle dropped;
7. the same config at 16^3 x 20 ppc, 2 steps, on the card and on the
   CPU: tables within 1e-4 (``diagnostics.compare``), equal KSP;
8. the eccapfim path: ``runtime.cli.main`` on bench.py's eccapfim config
   (32^3 x 50 ppc, dt 1.5, float32, the default diagnostics and the
   ConvergenceHistory table), 1 warm-up step + 3 timed steps: the
   segment-field kernel and the Chebyshev and rebin kernels all launch,
   finite tables, the energy identity within 1e-4 of the total energy;
9. the eccapfim config at 8^3 x 20 ppc, 2 steps, on the card and on the
   CPU: tables within 1e-4, outer iteration counts within 1 a step;
10. the ecsimcorr path: ``runtime.cli.main`` on bench.py's ecsimcorr
    config (32^3 x 50 ppc, dt 1.5, float32, the default diagnostics every
    step), 1 warm-up step + 3 timed steps, once on each mass route
    (``XPIC_MASS=free``: the mass-apply kernel and no fill;
    ``XPIC_MASS=blocks``: the fill kernel and no mass apply; the slot
    gather, Chebyshev and rebin kernels on both): finite tables,
    0 < predict and correct KSP < 100, the current-consistency norm
    < 0.1, the charge-continuity norms within 1e-5 of rho / dt, and the
    two routes' tables within 1e-4 of each other;
11. the ecsimcorr config at 8^3 x 20 ppc, 2 steps, on the ``blocks``
    route, on the card and on the CPU: tables within 1e-4, equal predict
    and correct KSP.

Phase 3 also holds the segment-field kernel against its twin on the
drifted 32^3 x 50 ppc state (K = 96) with moves of up to 0.9 cell a
axis, at K' = 32 (the fast path's crosser columns, read in place) and
K' = 96, within 1e-5 of max |E_p| and of max |B_p|, and the ECSIM fill
kernel against its twin on the drifted 32^3 x 50 ppc state at K = 96
and 112, within 1e-5 of max |L| and of max |Islot|.

``python3 chip_smoke.py --profile`` adds, after phase 11, two fused steps
under ``torch.profiler``, the phase-6 config for 8 steps, the phase-8
config for 6 steps and the phase-10 config for 6 steps on each mass
route through ``xpic_tpu_torch.runtime.step_profile``.

Exits non-zero on any failure, and without CUDA.  The last line is
``{"ok": true, "device": {...}}``; the line before it lists each kernel
with its launches on the fused path, the ECSIM config-driven path, the
eccapfim path and the two ecsimcorr runs, its error against its twin,
its time, its twin's and its bound.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SIDE, PPC, VTH, STEPS = 32, 50, 0.014, 10
KW = dict(q=-1.0, m=1.0, mpw=1.0 / PPC, maxit=100)
CHEB_TOL, FIELD_TOL, PARTICLE_TOL = 1e-5, 1e-4, 1e-5
MASS_TOL, GATHER_TOL, TABLE_TOL, ENERGY_TOL = 1e-5, 2e-6, 1e-4, 1e-4
SEGMENT_TOL, FILL_TOL, CHARGE_TOL = 1e-5, 1e-5, 1e-5
CLI_STEPS = 5
FIM_STEPS = CORR_STEPS = 3  # timed, after one warm-up step
MASS_ROUTES = ("free", "blocks")
# H100 SXM peaks (vendor datasheet): HBM bytes/s, float32
# FLOP/s outside the tensor cores.
HBM_BPS, F32_FLOPS = 3.35e12, 67e12
KERNELS = {
    # name: (source, replaces)
    "cheb_step": ("xpic_tpu_torch/csrc/cheb_step.cu",
                  "xpic_tpu/ops/pallas_stencil.py:120"),
    "rebin_extract": ("xpic_tpu_torch/csrc/rebin_extract.cu",
                      "xpic_tpu/ops/neighbor_rebin.py:279"),
    "rebin_place": ("xpic_tpu_torch/csrc/rebin_place.cu",
                    "xpic_tpu/ops/neighbor_rebin.py:348"),
    "mass_apply": ("xpic_tpu_torch/csrc/mass_apply.cu",
                   "xpic_tpu/ops/pallas_mass.py:44"),
    "slot_gather": ("xpic_tpu_torch/csrc/slot_gather.cu",
                    "xpic_tpu/ops/pallas_ecsim.py:133"),
    "segment_fields": ("xpic_tpu_torch/csrc/segment_fields.cu",
                       "xpic_tpu/ops/pallas_implicit.py:115"),
    "ecsim_fill": ("xpic_tpu_torch/csrc/ecsim_fill.cu",
                   "xpic_tpu/ops/pallas_ecsim.py:72"),
}
# The kernels each path runs.
ECCAPFIM_KERNELS = ("cheb_step", "rebin_extract", "rebin_place",
                    "segment_fields")
ECSIM_KERNELS = ("cheb_step", "rebin_extract", "rebin_place", "mass_apply",
                 "slot_gather")
# ecsimcorr's kernels on each mass route; the other route's mass kernel
# must not launch.
CORR_KERNELS = {
    "free": ECSIM_KERNELS,
    "blocks": ("cheb_step", "rebin_extract", "rebin_place", "ecsim_fill",
               "slot_gather"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after a warm-up."""
    fn()
    torch.cuda.synchronize()
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


def bound(n_bytes: float, n_flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the float32 operations over the float32 peak."""
    t_bytes = n_bytes / HBM_BPS * 1e3
    t_ops = n_flops / F32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def bench_state(geom, ppc, vth, seed=0):
    """The numpy state of bench.py: uniform positions, thermal velocities."""
    rng = np.random.default_rng(seed)
    n = geom.n_cells * ppc
    r = rng.random((n, 3)) * np.array(geom.L)
    p = rng.standard_normal((n, 3)) * vth
    z = np.zeros((3,) + geom.shape)
    return z, z, z, r, p, np.ones(n, bool)


def main() -> None:
    # -- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        sys.exit(2)
    try:
        from xpic_tpu_torch import kernels
    except ImportError as exc:
        print(f"chip_smoke: the xpic_tpu_torch package is missing ({exc})",
              file=sys.stderr)
        sys.exit(2)
    from xpic_tpu_torch.config import Geometry
    from xpic_tpu_torch.convert import state_from_numpy, to_numpy
    from xpic_tpu_torch.ops import neighbor_rebin as NR
    from xpic_tpu_torch.ops.binning import bin_state, drift_state
    from xpic_tpu_torch.ops.stencil_kernel import (
        cheb_matM_inv,
        cheb_matM_inv_plain,
    )
    from xpic_tpu_torch.parallel.step import ecsim_multi_step

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[1 device] {name} | nvidia-smi: {card} | torch {torch.__version__}"
        f" cuda {torch.version.cuda}")
    check(torch.backends.cuda.matmul.allow_tf32 is False, "matmul TF32 on")
    check(torch.backends.cudnn.allow_tf32 is False, "cuDNN TF32 on")
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision is not 'highest'")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    kernels.load()
    build_s = time.perf_counter() - t0
    regs = [ln.strip() for ln in kernels.BUILD_LOG.splitlines()
            if "registers" in ln or "Compiling entry" in ln
            or "spill" in ln]
    log(f"[2 build] nvcc sm_90a in {build_s:.1f} s "
        f"({'cached' if not kernels.BUILD_LOG else 'built'})")
    for ln in regs:
        log(f"    {ln}")

    # -- 3. kernels against their twins at the slice's shapes --------------
    geom = Geometry(dx=0.5, dy=0.5, dz=0.5, dt=1.5, nx=SIDE, ny=SIDE,
                    nz=SIDE, nt=1)
    report = {}
    for ppc, slots, vth in ((3, 8, 0.05), (20, 40, 0.05), (PPC, 80, VTH),
                            (100, 160, 0.05), (130, 200, 0.05)):
        *_, r, p, alive = bench_state(geom, ppc, vth, seed=1)
        _, _, _, sp = state_from_numpy(np.zeros(1), np.zeros(1),
                                       np.zeros(1), r, p, alive,
                                       device=dev, dtype=torch.float32)
        st = drift_state(bin_state(sp, geom, slots), geom)
        AT = NR._buffer_cols(slots)
        s_k, l_k = NR.rebin_neighbor(st, geom)
        s_p, l_p = NR.rebin_neighbor(st, geom, plain=True)
        torch.cuda.synchronize()
        same = (torch.equal(s_k.valid, s_p.valid)
                and torch.equal(s_k.r, s_p.r) and torch.equal(s_k.p, s_p.p)
                and torch.equal(l_k, l_p))
        err = max(float((s_k.r - s_p.r).abs().max()),
                  float((s_k.p - s_p.p).abs().max()))
        log(f"[3 kernels] rebin_neighbor K={slots} AT={AT} ppc={ppc}: "
            f"load={l_k.tolist()} bitwise={same} max|d|={err}")
        check(same, f"rebin kernels differ from their twins at AT={AT}")
        if slots != 80:
            continue
        # The slice's own shapes: times of each pass against its twin.
        _, _, buf, _ = NR.partition_movers(st, geom)
        o_k, u_k, d_k = NR.rebin_extract(buf, geom, 0)
        o_p, u_p, d_p = NR.extract_plain(buf, geom, 0)
        pl_k = NR.rebin_place(o_k, u_k, d_k, geom, 0)
        pl_p = NR.place_plain(o_p, u_p, d_p, geom, 0)
        torch.cuda.synchronize()
        check(torch.equal(o_k, o_p) and torch.equal(u_k, u_p)
              and torch.equal(d_k, d_p) and torch.equal(pl_k, pl_p),
              "a single extract/place pass differs from its twin")
        # Each pass reads its inputs and writes its outputs once: the
        # [G, 8, AT] buffer in and out, the two [G, 8, A] direction
        # buffers out (extract) or in (place).
        pass_bytes = 4 * (2 * buf.numel() + u_k.numel() + d_k.numel())
        report["rebin_extract"] = dict(
            max_abs_err=max(float((o_k - o_p).abs().max()),
                            float((u_k - u_p).abs().max()),
                            float((d_k - d_p).abs().max())),
            ms=time_ms(lambda: NR.rebin_extract(buf, geom, 0)),
            plain_ms=time_ms(lambda: NR.extract_plain(buf, geom, 0)),
            **bound(pass_bytes, 0))
        report["rebin_place"] = dict(
            max_abs_err=float((pl_k - pl_p).abs().max()),
            ms=time_ms(lambda: NR.rebin_place(o_k, u_k, d_k, geom, 0)),
            plain_ms=time_ms(lambda: NR.place_plain(o_k, u_k, d_k, geom, 0)),
            **bound(pass_bytes, 0))
        whole_ms = time_ms(lambda: NR.rebin_neighbor(st, geom))
        whole_plain = time_ms(lambda: NR.rebin_neighbor(st, geom,
                                                        plain=True))
        log(f"[3 kernels] buffer {tuple(buf.shape)}: extract "
            f"{report['rebin_extract']['ms']:.4f} ms vs twin "
            f"{report['rebin_extract']['plain_ms']:.4f} ms; place "
            f"{report['rebin_place']['ms']:.4f} ms vs twin "
            f"{report['rebin_place']['plain_ms']:.4f} ms; whole exchange "
            f"{whole_ms:.4f} ms vs twins {whole_plain:.4f} ms | {card}")

    rng = np.random.default_rng(2)
    rhs = torch.tensor(rng.standard_normal((3,) + geom.shape),
                       dtype=torch.float32, device=dev)
    shift = torch.tensor(0.37, dtype=torch.float32, device=dev)
    cheb = dict(geom=geom, degree=12, dt=geom.dt)
    x_k = cheb_matM_inv(rhs, shift, **cheb)
    x_p = cheb_matM_inv_plain(rhs, shift, **cheb)
    torch.cuda.synchronize()
    cheb_err = float((x_k - x_p).abs().max())
    rel = cheb_err / float(x_p.abs().max())
    # One apply reads rhs and writes x once; each of its 12 iterations
    # does ~40 float32 operations per field element (cheb_step.cu).
    report["cheb_step"] = dict(
        max_abs_err=cheb_err,
        ms=time_ms(lambda: cheb_matM_inv(rhs, shift, **cheb)),
        plain_ms=time_ms(lambda: cheb_matM_inv_plain(rhs, shift, **cheb)),
        **bound(8 * rhs.numel(), 12 * 40 * rhs.numel()))
    log(f"[3 kernels] cheb degree 12 on {tuple(rhs.shape)}: max|d|/max|x| "
        f"= {rel:.3e} (tol {CHEB_TOL}; nvcc contracts multiply-adds into "
        f"FMAs, which round once) | apply {report['cheb_step']['ms']:.4f} "
        f"ms vs twin {report['cheb_step']['plain_ms']:.4f} ms | {card}")
    check(np.isfinite(rel) and rel <= CHEB_TOL,
          f"cheb_step differs from its twin by {rel:.3e}")
    report.update(slot_kernels(geom, dev, card))
    report.update(segment_kernel(geom, dev, card))
    fill_rows = fill_kernel(geom, dev, card)

    # -- 4. the main path --------------------------------------------------
    E, B, B0, r, p, alive = bench_state(geom, PPC, VTH)
    n = len(r)
    slots = max(8, int(PPC * 1.6) // 8 * 8)
    E, B, B0, sp = state_from_numpy(E, B, B0, r, p, alive, device=dev,
                                    dtype=torch.float32)
    n_binned = int(bin_state(sp, geom, slots).valid.sum())
    warm = ecsim_multi_step(E, B, B0, sp, geom, slots, n_steps=1, **KW)
    torch.cuda.synchronize()
    check(all(torch.isfinite(t).all() for t in warm[:2]), "warm-up diverged")
    kernels.reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    E1, B1, sp1, iters = ecsim_multi_step(E, B, B0, sp, geom, slots,
                                          n_steps=STEPS, **KW)
    end.record()
    end.synchronize()
    launches = dict(kernels.LAUNCHES)
    step_ms = start.elapsed_time(end) / STEPS
    lost = n_binned - int(sp1.alive.sum())
    log(f"[4 main path] {SIDE}^3 x {PPC} ppc f32, {STEPS} steps: "
        f"step_ms={step_ms:.3f} particle_steps_per_s={n / step_ms * 1e3:.4e}"
        f" ksp_iters_per_step={float(iters.float().mean()):.2f} "
        f"(per step {iters.tolist()}) launches {launches} | {name} | {card}")
    check(all(launches[k] > 0 for k in ECSIM_KERNELS),
          f"a kernel of the main path never launched: {launches}")
    check(bool(torch.isfinite(E1).all() and torch.isfinite(B1).all()),
          "non-finite field")
    check(bool(torch.isfinite(sp1.r).all() and torch.isfinite(sp1.p).all()),
          "non-finite particle")
    check(bool((iters < KW["maxit"]).all()) and bool((iters > 0).all()),
          f"KSP iterations {iters.tolist()}")
    # bench.py's K = 80 = 1.6 ppc leaves Poisson-tail cells at capacity:
    # binning the initial state drops the excess, and a step can fill a
    # cell past K.  Such genuine capacity overflow drops the same count
    # on every route.  Replay the run's migrations and require that the
    # exchange loses nothing beyond it: its load equals the global sort's.
    dropped, fallbacks = replay_loads(E, B, B0, sp, geom, slots)
    log(f"[4 main path] dropped by migration {dropped} (run lost {lost}), "
        f"all genuine K={slots} overflow equal to the global sort's; "
        f"initial binning overflow {n - n_binned}; steps on the global-sort "
        f"fallback: {fallbacks}")
    check(sum(dropped) == lost, "the replay lost another count than the run")

    # -- 5. the card against the CPU ----------------------------------------
    g16 = Geometry(dx=0.5, dy=0.5, dz=0.5, dt=1.5, nx=16, ny=16, nz=16,
                   nt=1)
    state = bench_state(g16, PPC, VTH, seed=3)
    outs = []
    for device in (dev, torch.device("cpu")):
        kernels.reset_counts()
        args = state_from_numpy(*state, device=device, dtype=torch.float32)
        out = ecsim_multi_step(*args, g16, slots, n_steps=2, **KW)
        outs.append((to_numpy(out), dict(kernels.LAUNCHES)))
    (Eg, Bg, spg, itg), lg = outs[0]
    (Ec, Bc, spc, itc), lc = outs[1]
    check(all(lg[k] > 0 for k in ECSIM_KERNELS) and not any(lc.values()),
          f"routing: card launches {lg}, CPU launches {lc}")
    ferr = max(np.abs(Eg - Ec).max() / np.abs(Ec).max(),
               np.abs(Bg - Bc).max() / max(np.abs(Bc).max(), 1e-30))
    cg_, rows_g = cell_multisets(spg, g16)
    cc_, rows_c = cell_multisets(spc, g16)
    same_cells = np.array_equal(cg_, cc_)
    perr = (np.abs(rows_g - rows_c).max(axis=0) / np.abs(rows_c).max(axis=0)
            ).max() if same_cells else float("inf")
    log(f"[5 card vs cpu] 16^3 x {PPC} ppc, 2 steps: fields max rel "
        f"{ferr:.3e} (tol {FIELD_TOL}), particles per-cell multisets "
        f"{'equal' if same_cells else 'DIFFER'} max rel {perr:.3e} "
        f"(tol {PARTICLE_TOL}), KSP card {itg.tolist()} cpu {itc.tolist()}")
    check(ferr <= FIELD_TOL, "card fields differ from CPU")
    check(same_cells and perr <= PARTICLE_TOL,
          "card particles differ from CPU")
    check(itg.tolist() == itc.tolist(), "KSP iterations differ")

    # -- 6. the config-driven path on the card -----------------------------
    os.environ["XPIC_X64"] = "0"
    with tempfile.TemporaryDirectory(prefix="xpic_smoke_") as work:
        out, sim, step_times, cli_launches = run_cli(
            work, SIDE, PPC, CLI_STEPS, "cuda:0")
        check_cli_run(out, sim, cli_launches, name, card, step_times)

    # -- 7. the config-driven path, card against CPU -------------------------
    with tempfile.TemporaryDirectory(prefix="xpic_smoke_") as work:
        runs = {}
        for device in ("cuda:0", "cpu"):
            runs[device] = run_cli(os.path.join(work, device.split(":")[0]),
                                   16, 20, 2, device)
        (out_g, sim_g, _, lg), (out_c, sim_c, _, lc) = (runs["cuda:0"],
                                                        runs["cpu"])
        from xpic_tpu_torch.diagnostics.compare import table_errors

        worst = {}
        for table in ("energy.txt", "energy_conservation.txt",
                      "momentum_conservation.txt"):
            errs = table_errors(table, out_c, out_g, n_cells=16 ** 3)
            worst[table] = max(errs.items(), key=lambda kv: kv[1])
            log(f"    {table}: {errs}")
        log(f"[7 card vs cpu, cli] 16^3 x 20 ppc f32, 2 steps: worst column "
            f"per table {worst} (tol {TABLE_TOL}); KSP card "
            f"{sim_g.ksp_history} cpu {sim_c.ksp_history}")
        check(all(lg[k] > 0 for k in ECSIM_KERNELS) and not any(lc.values()),
              f"routing: card launches {lg}, CPU launches {lc}")
        check(all(e <= TABLE_TOL for _, e in worst.values()),
              "card tables differ from the CPU's")
        check(sim_g.ksp_history == sim_c.ksp_history,
              "KSP iterations differ between card and CPU")

    # -- 8. the eccapfim path on the card ------------------------------------
    with tempfile.TemporaryDirectory(prefix="xpic_smoke_") as work:
        out, sim, step_times, fim_launches = run_cli(
            work, SIDE, PPC, FIM_STEPS + 1, "cuda:0", doc=eccapfim_config)
        check_eccapfim_run(out, sim, fim_launches, name, card, step_times)

    # -- 9. the eccapfim path, card against CPU -------------------------------
    with tempfile.TemporaryDirectory(prefix="xpic_smoke_") as work:
        runs = {}
        for device in ("cuda:0", "cpu"):
            runs[device] = run_cli(os.path.join(work, device.split(":")[0]),
                                   8, 20, 2, device, doc=eccapfim_config)
        (out_g, sim_g, _, lg), (out_c, sim_c, _, lc) = (runs["cuda:0"],
                                                        runs["cpu"])
        from xpic_tpu_torch.diagnostics.compare import TABLES, table_errors

        worst = {}
        for table in TABLES:
            # charge is conserved to rounding: its norms against rho / dt
            errs = table_errors(table, out_c, out_g, n_cells=8 ** 3,
                                charge_scale=np.sqrt(8 ** 3) / 1.5)
            worst[table] = max(errs.items(), key=lambda kv: kv[1])
            log(f"    {table}: {errs}")
        log(f"[9 card vs cpu, eccapfim] 8^3 x 20 ppc f32, 2 steps: worst "
            f"column per table {worst} (tol {TABLE_TOL}); outer iterations "
            f"card {sim_g.outer_history} cpu {sim_c.outer_history}; CN "
            f"sweeps card {sim_g.cn_history} cpu {sim_c.cn_history}")
        check(all(lg[k] > 0 for k in ECCAPFIM_KERNELS)
              and not any(lc.values()),
              f"routing: card launches {lg}, CPU launches {lc}")
        check(all(e <= TABLE_TOL for _, e in worst.values()),
              "eccapfim card tables differ from the CPU's")
        check(len(sim_g.outer_history) == len(sim_c.outer_history) == 2
              and all(abs(a - b) <= 1 for a, b in zip(sim_g.outer_history,
                                                      sim_c.outer_history)),
              "eccapfim outer iterations differ by more than 1 a step")

    # -- 10. the ecsimcorr path on both mass routes ------------------------
    corr_launches = {}
    with tempfile.TemporaryDirectory(prefix="xpic_smoke_") as work:
        outs = {}
        for mass in MASS_ROUTES:
            os.environ["XPIC_MASS"] = mass
            out, sim, step_times, corr_launches[mass] = run_cli(
                os.path.join(work, mass), SIDE, PPC, CORR_STEPS + 1, "cuda:0",
                doc=ecsimcorr_config)
            check_ecsimcorr_run(mass, out, sim, corr_launches[mass], name,
                                card, step_times)
            outs[mass] = out
            corr_k = sim.species[0].slots
        from xpic_tpu_torch.diagnostics.compare import TABLES, table_errors

        worst = {}
        for table in TABLES:
            errs = table_errors(table, outs["free"], outs["blocks"],
                                n_cells=SIDE ** 3,
                                charge_scale=np.sqrt(SIDE ** 3) / 1.5)
            worst[table] = max(errs.items(), key=lambda kv: kv[1])
        log(f"[10 ecsimcorr routes] blocks against free, worst column per "
            f"table {worst} (tol {TABLE_TOL})")
        check(all(e <= TABLE_TOL for _, e in worst.values()),
              "the two mass routes' ecsimcorr tables differ")
    # The fill kernel's row is the one at the K the blocks run ended with;
    # a K that phase 3 did not measure is measured now.
    if corr_k not in fill_rows:
        fill_rows.update(fill_kernel(geom, dev, card, (corr_k,)))
    report["ecsim_fill"] = fill_rows[corr_k]

    # -- 11. the ecsimcorr path on the blocks route, card against CPU --------
    os.environ["XPIC_MASS"] = "blocks"
    with tempfile.TemporaryDirectory(prefix="xpic_smoke_") as work:
        runs = {}
        for device in ("cuda:0", "cpu"):
            runs[device] = run_cli(os.path.join(work, device.split(":")[0]),
                                   8, 20, 2, device, doc=ecsimcorr_config)
        (out_g, sim_g, _, lg), (out_c, sim_c, _, lc) = (runs["cuda:0"],
                                                        runs["cpu"])
        from xpic_tpu_torch.diagnostics.compare import TABLES, table_errors

        worst = {}
        for table in TABLES:
            errs = table_errors(table, out_c, out_g, n_cells=8 ** 3,
                                charge_scale=np.sqrt(8 ** 3) / 1.5)
            worst[table] = max(errs.items(), key=lambda kv: kv[1])
            log(f"    {table}: {errs}")
        log(f"[11 card vs cpu, ecsimcorr blocks] 8^3 x 20 ppc f32, 2 steps: "
            f"worst column per table {worst} (tol {TABLE_TOL}); predict KSP "
            f"card {sim_g.ksp_history} cpu {sim_c.ksp_history}; correct KSP "
            f"card {sim_g.correct_history} cpu {sim_c.correct_history}")
        check(all(lg[k] > 0 for k in CORR_KERNELS["blocks"])
              and not any(lc.values()),
              f"routing: card launches {lg}, CPU launches {lc}")
        check(all(e <= TABLE_TOL for _, e in worst.values()),
              "ecsimcorr card tables differ from the CPU's")
        check(sim_g.ksp_history == sim_c.ksp_history
              and sim_g.correct_history == sim_c.correct_history,
              "ecsimcorr KSP iterations differ between card and CPU")
    del os.environ["XPIC_MASS"]

    if "--profile" in sys.argv[1:]:
        profile_paths(name, card, dev, lambda: ecsim_multi_step(
            E, B, B0, sp, geom, slots, n_steps=2, **KW))

    rows = []
    for kname, (src, repl) in KERNELS.items():
        own = {"segment_fields": fim_launches,
               "ecsim_fill": corr_launches["blocks"]}.get(kname, launches)
        row = dict(name=kname, route="cuda", source=src, replaces=repl,
                   launches=own[kname], launches_fused=launches[kname],
                   launches_cli=cli_launches[kname],
                   launches_eccapfim=fim_launches[kname],
                   launches_ecsimcorr_free=corr_launches["free"][kname],
                   launches_ecsimcorr_blocks=corr_launches["blocks"][kname],
                   library_ms=None, **report[kname])
        if kname == "rebin_place":
            row["also_replaces"] = ["xpic_tpu/ops/neighbor_rebin.py:496",
                                    "xpic_tpu/ops/neighbor_rebin.py:525"]
        rows.append(row)
    log(f"card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


def slot_kernels(geom, dev, card):
    """Phase 3 for the mass apply (K = 80, the fused path, and 96, the
    config-driven path's K at 50 ppc) and the slot gather (K = 80), on the
    drifted and migrated 32^3 x 50 ppc state with B at the slots ~0.2."""
    from xpic_tpu_torch.convert import state_from_numpy
    from xpic_tpu_torch.ops.binning import bin_state, drift_state, rebin
    from xpic_tpu_torch.ops.ecsim_blocks import gather_slots
    from xpic_tpu_torch.ops.ecsim_kernel import (
        ecsim_gather,
        ecsim_gather_plain,
    )
    from xpic_tpu_torch.ops.gather_scatter import (
        B_STAGGER,
        cell_t,
        gather_vector,
    )
    from xpic_tpu_torch.ops.mass_free import mass_operands
    from xpic_tpu_torch.ops.mass_kernel import (
        mass_apply_slots,
        mass_apply_slots_plain,
    )

    rng = np.random.default_rng(7)
    shape = (3,) + geom.shape
    Bf = np.zeros(shape)
    Bf[2] = 0.2
    Bf += 0.05 * rng.standard_normal(shape)
    x = rng.standard_normal(shape)
    report = {}
    for slots in (80, 96):
        *_, r, p, alive = bench_state(geom, PPC, VTH, seed=1)
        Bt, xt, _, sp = state_from_numpy(Bf, x, np.zeros(1), r, p, alive,
                                         device=dev, dtype=torch.float32)
        st = rebin(drift_state(bin_state(sp, geom, slots), geom), geom)
        t = cell_t(geom, st.r)
        B_p = gather_vector(Bt, t, st.valid, geom, order=1, width=3,
                            anchor=-1, stagger=B_STAGGER)
        packed = mass_operands(t, B_p, st.valid, dt=geom.dt, **{
            k: KW[k] for k in ("q", "m", "mpw")}).packed
        xg = gather_slots(xt, geom)
        Y_k = mass_apply_slots(xg, packed)
        Y_p = mass_apply_slots_plain(xg, packed)
        torch.cuda.synchronize()
        err = float((Y_k - Y_p).abs().max())
        rel = err / float(Y_p.abs().max())
        n_valid = int(st.valid.sum())
        G = geom.n_cells
        # Read: 7 operand channels (the 8th is zero and never read) and
        # xg; written: Y.  ~140 float32 operations per live slot.
        row = dict(max_abs_err=err,
                   ms=time_ms(lambda: mass_apply_slots(xg, packed)),
                   plain_ms=time_ms(lambda: mass_apply_slots_plain(xg,
                                                                   packed)),
                   **bound(4 * G * (7 * slots + 2 * 36), 140 * n_valid))
        log(f"[3 kernels] mass_apply K={slots} |B_p| max "
            f"{float(B_p.norm(dim=-1).max()):.3f}: max|d|/max|Y| = "
            f"{rel:.3e} (tol {MASS_TOL}) | {row['ms']:.4f} ms vs twin "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}) | {card}")
        check(np.isfinite(rel) and rel <= MASS_TOL,
              f"mass_apply differs from its twin by {rel:.3e} at K={slots}")
        if slots != 80:
            continue
        report["mass_apply"] = row
        Fg = gather_slots(xt, geom)
        E_k = ecsim_gather(t, Fg)
        E_p = ecsim_gather_plain(t, Fg)
        torch.cuda.synchronize()
        err = float((E_k - E_p).abs().max())
        rel = err / float(E_p.abs().max())
        # Read t and Fg, write E_p; ~75 float32 operations per live slot.
        report["slot_gather"] = row = dict(
            max_abs_err=err, ms=time_ms(lambda: ecsim_gather(t, Fg)),
            plain_ms=time_ms(lambda: ecsim_gather_plain(t, Fg)),
            **bound(4 * (2 * t.numel() + Fg.numel()), 75 * n_valid))
        log(f"[3 kernels] slot_gather K={slots}: max|d|/max|E_p| = "
            f"{rel:.3e} (tol {GATHER_TOL}) | {row['ms']:.4f} ms vs twin "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}) | {card}")
        check(np.isfinite(rel) and rel <= GATHER_TOL,
              f"slot_gather differs from its twin by {rel:.3e}")
    return report


def cli_config(out_dir, side, ppc, steps):
    """The config-driven run: ``side``^3 cells of 0.5, dt 1.5, periodic,
    one electron species at ``ppc`` and T = 0.1 keV (the bench's
    v_th = 0.014 c), a uniform B0 = 0.2 along z, E, B and the density
    dumped every step."""
    L = side * 0.5
    return {
        "Simulation": "ecsim",
        "OutputDirectory": out_dir,
        "Geometry": {"x": L, "y": L, "z": L, "t": steps * 1.5,
                     "dx": 0.5, "dy": 0.5, "dz": 0.5, "dt": 1.5,
                     "diagnose_period": 1.5},
        "Particles": [{"sort_name": "electrons", "Np": ppc, "n": 1.0,
                       "q": -1.0, "m": 1.0, "T": 0.1}],
        "Presets": [
            {"command": "SetParticles", "particles": "electrons",
             "coordinate": {"name": "CoordinateInBox"},
             "momentum": {"name": "MaxwellianMomentum"}},
            {"command": "SetMagneticField",
             "field": {"name": "SetUniformField", "value": [0.0, 0.0, 0.2]}},
        ],
        "Diagnostics": [
            {"diagnostic": "FieldView", "field": "E"},
            {"diagnostic": "FieldView", "field": "B"},
            {"diagnostic": "DistributionMoment", "particles": "electrons",
             "moment": "density"},
        ],
    }


def run_cli(work, side, ppc, steps, device, doc=None):
    """``runtime.cli.main`` on ``doc`` (default :func:`cli_config`) in
    ``work``.  Returns the output directory, the simulation it built,
    each step's time in ms (closed by a device synchronisation) and the
    kernel launches of the run (counts set to 0 just before it).  An
    ecsimcorr simulation also records each step's correct-solve
    iterations and consistency norm (``correct_history``,
    ``norm_history``)."""
    from xpic_tpu_torch import kernels
    from xpic_tpu_torch import schemes
    from xpic_tpu_torch.commands import particles_load
    from xpic_tpu_torch.runtime import cli

    os.makedirs(work, exist_ok=True)
    out = os.path.join(work, "out")
    cfg = os.path.join(work, "cfg.json")
    with open(cfg, "w") as fh:
        json.dump((doc or cli_config)(out, side, ppc, steps), fh)
    built, step_ms = [], []
    build = schemes.build_simulation
    sync = (torch.cuda.synchronize if device.startswith("cuda")
            else lambda: None)

    def timed_build(*args, **kwargs):
        sim = build(*args, **kwargs)
        step = sim.timestep_implementation

        def timed_step(t):
            sync()
            t0 = time.perf_counter()
            step(t)
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if sim.scheme_name == "ecsimcorr":
                sim.correct_history.append(sim.correct_ksp_iters)
                sim.norm_history.append(sim.current_consistency_norm)

        sim.correct_history, sim.norm_history = [], []
        sim.timestep_implementation = timed_step
        built.append(sim)
        return sim

    schemes.build_simulation = timed_build
    # Every run loads the particles of the loader's import-time stream.
    particles_load.seed(5489)
    try:
        kernels.reset_counts()
        rc = cli.main([cfg, "--quiet", "--device", device])
        sync()
        launches = dict(kernels.LAUNCHES)
    finally:
        schemes.build_simulation = build
    check(rc == 0, f"cli.main returned {rc}")
    return out, built[0], step_ms, launches


def check_cli_run(out, sim, launches, name, card, step_ms):
    from xpic_tpu_torch.diagnostics.compare import TABLES, read_table

    tables = {t: read_table(os.path.join(out, "temporal", t))
              for t in TABLES}
    h_en, en = tables["energy.txt"]
    h_ec, ec = tables["energy_conservation.txt"]
    n_en = (len(h_en) - 1) // 2
    total = en[:, 1:1 + n_en].sum(axis=1)
    closure = np.abs(ec[:, h_ec.index("dE+dB+dK")]) / total
    hist = sim.ksp_history
    dumps = {d: len(os.listdir(os.path.join(out, d)))
             for d in ("E", "B", os.path.join("electrons", "density"))}
    sp = sim.species[0]
    log(f"[6 cli path] python -m xpic_tpu_torch cfg.json: {SIDE}^3 x {PPC} "
        f"ppc f32, {CLI_STEPS} steps, K={sp.slots}, {sp.count()} particles: "
        f"ms/step median {statistics.median(step_ms):.3f} (per step "
        f"{[round(v, 3) for v in step_ms]}), KSP {hist}, "
        f"max |dE+dB+dK|/(wE+wB+wK) = {closure.max():.3e} (tol "
        f"{ENERGY_TOL}), dumps {dumps}, launches {launches} | {name} | "
        f"{card}")
    check(all(launches[k] > 0 for k in ECSIM_KERNELS),
          f"a kernel of the config-driven path never launched: {launches}")
    check(all(np.isfinite(rows).all() and rows.shape[0] == CLI_STEPS + 1
              for _, rows in tables.values()), "a table row is not finite")
    check(len(hist) == CLI_STEPS and all(0 < it < KW["maxit"]
                                         for it in hist),
          f"KSP iterations {hist}")
    check(closure.max() <= ENERGY_TOL, "the ECSIM energy identity fails")
    check(all(v == CLI_STEPS + 1 for v in dumps.values()),
          f"dumps {dumps}")


def eccapfim_config(out_dir, side, ppc, steps):
    """bench.py's eccapfim workload: ``side``^3 cells of 0.5, dt 1.5,
    periodic, one electron species at ``ppc`` and T = 0.1 keV, no field;
    the default diagnostics (and ConvergenceHistory) every step."""
    L = side * 0.5
    periodic = "DM_BOUNDARY_PERIODIC"
    return {
        "Simulation": "eccapfim",
        "OutputDirectory": out_dir,
        "Geometry": {"x": L, "y": L, "z": L, "t": steps * 1.5,
                     "dx": 0.5, "dy": 0.5, "dz": 0.5, "dt": 1.5,
                     "diagnose_period": 1.5, "da_boundary_x": periodic,
                     "da_boundary_y": periodic, "da_boundary_z": periodic},
        "Particles": [{"sort_name": "electrons", "Np": ppc, "n": 1.0,
                       "q": -1.0, "m": 1.0, "T": 0.1}],
        "Presets": [
            {"command": "SetParticles", "particles": "electrons",
             "coordinate": {"name": "CoordinateInBox"},
             "momentum": {"name": "MaxwellianMomentum", "tov": True}},
        ],
        "Diagnostics": [],
    }


def check_eccapfim_run(out, sim, launches, name, card, step_ms):
    """Phase 8's gates and line: the first step is the warm-up."""
    from xpic_tpu_torch.diagnostics.compare import TABLES, read_table

    tables = {t: read_table(os.path.join(out, "temporal", t))
              for t in TABLES}
    # ConvergenceHistory: one row a step from step 1, as long as the
    # step's residual history
    with open(os.path.join(out, "temporal", "convergence_history.txt")) as fh:
        conv = [np.array(ln.split(), float) for ln in fh.read().splitlines()[1:]]
    h_en, en = tables["energy.txt"]
    h_ec, ec = tables["energy_conservation.txt"]
    n_en = (len(h_en) - 1) // 2
    total = en[:, 1:1 + n_en].sum(axis=1)
    closure = np.abs(ec[:, h_ec.index("dE+dB+dK")]) / total
    sp = sim.species[0]
    n = sp.count()
    timed = step_ms[1:]
    ms = statistics.median(timed)
    sweeps = [c for counts in sim.cn_history[1:] for c in counts]
    log(f"[8 eccapfim path] python -m xpic_tpu_torch cfg.json: {SIDE}^3 x "
        f"{PPC} ppc f32, 1 + {FIM_STEPS} steps, K={sp.slots}, {n} "
        f"particles: ms/step median {ms:.3f} (per step "
        f"{[round(v, 3) for v in step_ms]}, the first a warm-up), "
        f"particle_steps_per_s={n / ms * 1e3:.4e}, outer iterations per "
        f"step {sim.outer_history}, CN iterations per sweep "
        f"{statistics.mean(sweeps):.2f} (sweeps of the timed steps "
        f"{sim.cn_history[1:]}), fallback steps {sum(sim.fallback_history)}"
        f", max |dE+dB+dK|/(wE+wB+wK) = {closure.max():.3e} (tol "
        f"{ENERGY_TOL}), launches {launches} | {name} | {card}")
    check(all(launches[k] > 0 for k in ECCAPFIM_KERNELS),
          f"a kernel of the eccapfim path never launched: {launches}")
    check(all(np.isfinite(rows).all() and rows.shape[0] == FIM_STEPS + 2
              for _, rows in tables.values())
          and len(conv) == FIM_STEPS + 1
          and all(np.isfinite(row).all() for row in conv),
          "a table row is not finite")
    check(closure.max() <= ENERGY_TOL, "the eccapfim energy identity fails")


def ecsimcorr_config(out_dir, side, ppc, steps):
    """bench.py's ecsimcorr workload: ``side``^3 cells of 0.5, dt 1.5,
    periodic, one electron species at ``ppc`` and T = 0.1 keV, no field;
    the default diagnostics every step."""
    doc = eccapfim_config(out_dir, side, ppc, steps)
    doc["Simulation"] = "ecsimcorr"
    return doc


def check_ecsimcorr_run(mass, out, sim, launches, name, card, step_ms):
    """Phase 10's gates and line for one mass route: the first step is
    the warm-up."""
    from xpic_tpu_torch.diagnostics.compare import TABLES, read_table

    tables = {t: read_table(os.path.join(out, "temporal", t))
              for t in TABLES}
    h_ch, ch = tables["charge_conservation.txt"]
    n_cells = SIDE ** 3
    # The continuity norms against those of rho / dt (|q n| = 1 a cell).
    charge = max(float(np.abs(ch[:, c]).max())
                 / ((n_cells if h.startswith("N1") else np.sqrt(n_cells))
                    / 1.5)
                 for c, h in enumerate(h_ch) if h != "Time")
    sp = sim.species[0]
    n = sp.count()
    ms = statistics.median(step_ms[1:])
    log(f"[10 ecsimcorr path, {mass}] python -m xpic_tpu_torch cfg.json: "
        f"{SIDE}^3 x {PPC} ppc f32, 1 + {CORR_STEPS} steps, K={sp.slots}, "
        f"{n} particles: ms/step median {ms:.3f} (per step "
        f"{[round(v, 3) for v in step_ms]}, the first a warm-up), "
        f"particle_steps_per_s={n / ms * 1e3:.4e}, predict KSP "
        f"{sim.ksp_history}, correct KSP {sim.correct_history}, consistency "
        f"norm {sim.norm_history} (tol 0.1), charge continuity / (rho/dt) "
        f"{charge:.3e} (tol {CHARGE_TOL}), launches {launches} | {name} | "
        f"{card}")
    other = "mass_apply" if mass == "blocks" else "ecsim_fill"
    check(all(launches[k] > 0 for k in CORR_KERNELS[mass])
          and launches[other] == 0,
          f"the ecsimcorr {mass} route's launches {launches}")
    check(all(np.isfinite(rows).all() and rows.shape[0] == CORR_STEPS + 2
              for _, rows in tables.values()), "a table row is not finite")
    check(all(0 < it < KW["maxit"]
              for it in sim.ksp_history + sim.correct_history)
          and len(sim.correct_history) == CORR_STEPS + 1,
          f"KSP iterations {sim.ksp_history} {sim.correct_history}")
    check(all(0.0 <= v < 0.1 for v in sim.norm_history),
          f"current-consistency norms {sim.norm_history}")
    check(charge <= CHARGE_TOL, "ecsimcorr does not conserve charge")


def fill_kernel(geom, dev, card, ks=(96, 112)):
    """Phase 3 for the ECSIM fill kernel: the drifted and migrated
    32^3 x 50 ppc state at each K of ``ks`` with B at the slots ~0.2.
    Returns the rows by K."""
    from xpic_tpu_torch.convert import state_from_numpy
    from xpic_tpu_torch.ops.binning import bin_state, drift_state, rebin
    from xpic_tpu_torch.ops.ecsim_kernel import (
        FILL_FLOPS_PER_SLOT,
        ecsim_fill,
        ecsim_fill_plain,
    )
    from xpic_tpu_torch.ops.gather_scatter import (
        B_STAGGER,
        cell_t,
        gather_vector,
    )

    rng = np.random.default_rng(13)
    shape = (3,) + geom.shape
    Bf = np.zeros(shape)
    Bf[2] = 0.2
    Bf += 0.05 * rng.standard_normal(shape)
    kw = dict(dt=geom.dt, **{k: KW[k] for k in ("q", "m", "mpw")})
    rows = {}
    for slots in ks:
        *_, r, p, alive = bench_state(geom, PPC, VTH, seed=1)
        Bt, _, _, sp = state_from_numpy(Bf, np.zeros(1), np.zeros(1), r, p,
                                        alive, device=dev,
                                        dtype=torch.float32)
        st = rebin(drift_state(bin_state(sp, geom, slots), geom), geom)
        t = cell_t(geom, st.r)
        B_p = gather_vector(Bt, t, st.valid, geom, order=1, width=3,
                            anchor=-1, stagger=B_STAGGER)
        args = (t, st.p, B_p, st.valid)
        L_k, I_k = ecsim_fill(*args, **kw)
        L_p, I_p = ecsim_fill_plain(*args, **kw)
        torch.cuda.synchronize()
        errs = [float((k - q).abs().max()) for k, q in ((L_k, L_p),
                                                        (I_k, I_p))]
        rel = max(errs[0] / float(L_p.abs().max()),
                  errs[1] / float(I_p.abs().max()))
        G = geom.n_cells
        n_valid = int(st.valid.sum())
        # Read t, v, B_p (float32) and valid (a byte) once, write L and
        # Islot once; the operations per live slot (an invalid slot adds
        # nothing).
        row = dict(max_abs_err=max(errs),
                   ms=time_ms(lambda: ecsim_fill(*args, **kw)),
                   plain_ms=time_ms(lambda: ecsim_fill_plain(*args, **kw)),
                   **bound(4 * 9 * G * slots + G * slots
                           + 4 * G * (1296 + 36),
                           FILL_FLOPS_PER_SLOT * n_valid))
        rows[slots] = row
        log(f"[3 kernels] ecsim_fill K={slots} ({n_valid} live "
            f"slots): max|d|/max |L|, |Islot| = {rel:.3e} (tol {FILL_TOL}) "
            f"| {row['ms']:.4f} ms vs twin {row['plain_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}) | {card}")
        check(np.isfinite(rel) and rel <= FILL_TOL,
              f"ecsim_fill differs from its twin by {rel:.3e} at K={slots}")
    return rows


def segment_kernel(geom, dev, card):
    """Phase 3 for the segment-field kernel: the drifted 32^3 x 50 ppc
    state at K = 96 (the eccapfim run's K), random E and B, moves of up
    to +-0.9 cell a axis (1 to 4 segments) and rows with tn == t0; the
    fast path's K' = 32 crosser columns read in place, and K' = 96."""
    from xpic_tpu_torch.convert import state_from_numpy
    from xpic_tpu_torch.ops.binning import bin_state, drift_state
    from xpic_tpu_torch.ops.gather_scatter import cell_t
    from xpic_tpu_torch.ops.implicit_esirkepov import gather_window_blocks
    from xpic_tpu_torch.ops.segment_kernel import (
        FLOPS_PER_SEGMENT,
        live_segments,
        segment_fields,
        segment_fields_plain,
    )

    rng = np.random.default_rng(11)
    shape = (3,) + geom.shape
    *_, r, p, alive = bench_state(geom, PPC, VTH, seed=1)
    Et, Bt, _, sp = state_from_numpy(
        0.1 * rng.standard_normal(shape), 0.1 * rng.standard_normal(shape),
        np.zeros(1), r, p, alive, device=dev, dtype=torch.float32)
    st = drift_state(bin_state(sp, geom, 96), geom)
    t0 = cell_t(geom, st.r)
    move = torch.tensor(rng.uniform(-0.9, 0.9, tuple(t0.shape)),
                        dtype=torch.float32, device=dev)
    move[:, :4] = 0.0  # rows of slots that stay put
    tn = t0 + move
    Eblk = gather_window_blocks(Et, geom)
    Bblk = gather_window_blocks(Bt, geom)
    report = {}
    for kp in (32, 96):
        a, b = t0[:, :kp], tn[:, :kp]
        E_k, B_k = segment_fields(Eblk, Bblk, a, b)
        E_p, B_p = segment_fields_plain(Eblk, Bblk, a, b)
        torch.cuda.synchronize()
        errs = [float((k - q).abs().max()) for k, q in ((E_k, E_p),
                                                        (B_k, B_p))]
        rel = max(errs[0] / float(E_p.abs().max()),
                  errs[1] / float(B_p.abs().max()))
        G = a.shape[0]
        segs = live_segments(a, b)
        # Read the two windows and t0, tn once; write E_p and B_p.
        row = dict(max_abs_err=max(errs),
                   ms=time_ms(lambda: segment_fields(Eblk, Bblk, a, b)),
                   plain_ms=time_ms(lambda: segment_fields_plain(
                       Eblk, Bblk, a, b)),
                   **bound(4 * (2 * G * 648 + 4 * G * kp * 3),
                           FLOPS_PER_SEGMENT * segs))
        log(f"[3 kernels] segment_fields K'={kp} of K=96 ({segs} live "
            f"segments, {segs / (G * kp):.2f} a slot): max|d|/max = "
            f"{rel:.3e} (tol {SEGMENT_TOL}) | {row['ms']:.4f} ms vs twin "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}) | {card}")
        check(np.isfinite(rel) and rel <= SEGMENT_TOL,
              f"segment_fields differs from its twin by {rel:.3e} at "
              f"K'={kp}")
        if kp == 32:
            report["segment_fields"] = row
    return report


def profile_paths(name, card, dev, fused_run):
    """``--profile``: two fused steps (phase 4's state) under
    ``torch.profiler``, the phase-6 config for 8 steps, the phase-8
    config for 6 steps and the phase-10 config for 6 steps on each mass
    route through ``runtime.step_profile`` (per-phase and per-diagnostic
    times, and a 2-step ``torch.profiler`` window)."""
    from xpic_tpu_torch.config import Config
    from xpic_tpu_torch.runtime.step_profile import device_window, profile_run
    from xpic_tpu_torch.schemes import build_simulation

    fused = device_window([fused_run], dev)
    log(f"[profile] fused path {SIDE}^3 x {PPC} ppc f32, 2 steps | {name} "
        f"| {card}")
    log(f"[profile] {json.dumps(fused)}")

    with tempfile.TemporaryDirectory(prefix="xpic_smoke_") as work:
        doc = cli_config(os.path.join(work, "out"), SIDE, PPC, 8)
        sim = build_simulation(Config.from_json(doc), device="cuda:0")
        prof = profile_run(sim)
    log(f"[profile] {SIDE}^3 x {PPC} ppc f32, config-driven path | {name} "
        f"| {card}")
    log(f"[profile] {json.dumps(prof)}")

    with tempfile.TemporaryDirectory(prefix="xpic_smoke_") as work:
        doc = eccapfim_config(os.path.join(work, "out"), SIDE, PPC, 6)
        sim = build_simulation(Config.from_json(doc), device="cuda:0")
        prof = profile_run(sim)
    log(f"[profile] {SIDE}^3 x {PPC} ppc f32, eccapfim path | {name} "
        f"| {card}")
    log(f"[profile] {json.dumps(prof)}")

    for mass in MASS_ROUTES:
        with tempfile.TemporaryDirectory(prefix="xpic_smoke_") as work:
            doc = ecsimcorr_config(os.path.join(work, "out"), SIDE, PPC, 6)
            sim = build_simulation(Config.from_json(doc), device="cuda:0",
                                   mass=mass)
            prof = profile_run(sim)
        log(f"[profile] {SIDE}^3 x {PPC} ppc f32, ecsimcorr path, {mass} "
            f"route | {name} | {card}")
        log(f"[profile] {json.dumps(prof)}")


def replay_loads(E, B, B0, sp, geom, slots):
    """Re-run the main path's steps and hold each step's migration counts
    (dropped, moved) against the global sort's on the same drifted
    state.  Returns the per-step dropped counts and the
    steps the exact guard sent to the global sort."""
    from xpic_tpu_torch.ops.binning import (
        _rebin_global,
        bin_state,
        drift_state,
        rebin_checked,
    )
    from xpic_tpu_torch.ops.neighbor_rebin import neighbor_guard_stats
    from xpic_tpu_torch.parallel.step import ecsim_step_binned

    st = bin_state(sp, geom, slots)
    dropped, fallbacks = [], []
    for step in range(STEPS):
        drifted = drift_state(st, geom)
        if not bool(neighbor_guard_stats(drifted, geom)[0]):
            fallbacks.append(step)
        # [dropped, moved]; max_per_cell differs under overflow (the
        # global sort reports the occupancy before capping at K)
        load = rebin_checked(drifted, geom)[1].tolist()[1:]
        ref = _rebin_global(drifted, geom)[1].tolist()[1:]
        check(load == ref, f"step {step}: exchange [dropped, moved] {load}"
              f" != global sort {ref}")
        dropped.append(load[0])
        E, B, st, _, _ = ecsim_step_binned(E, B, B0, st, geom, **KW)
    return dropped, fallbacks


def cell_multisets(sp, geom):
    """Live particles as rows (r, p) sorted by (cell, x, y, z), with the
    sorted cell ids: equal per-cell multisets give equal arrays."""
    live = sp.alive
    r = sp.r[live].astype(np.float64)
    p = sp.p[live].astype(np.float64)
    c = np.floor(r / np.array(geom.cell_steps)).astype(np.int64)
    cell = (c[:, 2] * geom.ny + c[:, 1]) * geom.nx + c[:, 0]
    order = np.lexsort((r[:, 2], r[:, 1], r[:, 0], cell))
    return cell[order], np.concatenate([r, p], axis=1)[order]


if __name__ == "__main__":
    main()
