"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``xpic_tpu_torch/csrc`` (into
``build/``), holds each against its plain PyTorch twin at the shapes of
the main path, runs 10 fused ECSIM steps at 32^3 cells x 50 particles
per cell in float32 (the flagship workload of ``bench.py``), and checks
the card's result against the CPU twins at 16^3.  Phases:

1. device: card name and power limit, the IEEE float32 pins;
2. build: nvcc for sm_90a;
3. kernels against twins: the rebin exchange bitwise at AT = 8, 16, 32
   and 64; the Chebyshev apply to 1e-5 relative; times by CUDA events;
4. main path: 10 steps through the kernels (every launch count grows;
   the migration loses no particle beyond genuine K overflow);
5. card against CPU: 2 steps at 16^3 x 50 ppc.

Exits non-zero on any failure, and without CUDA.  The last line is
``{"ok": true, "device": {...}}``; the line before it lists each kernel
with its launches on the main path, its error against its twin and the
two times.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SIDE, PPC, VTH, STEPS = 32, 50, 0.014, 10
KW = dict(q=-1.0, m=1.0, mpw=1.0 / PPC, maxit=100)
CHEB_TOL, FIELD_TOL, PARTICLE_TOL = 1e-5, 1e-4, 1e-5


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
            if "registers" in ln or "Compiling entry" in ln]
    log(f"[2 build] nvcc sm_90a in {build_s:.1f} s "
        f"({'cached' if not kernels.BUILD_LOG else 'built'})")
    for ln in regs:
        log(f"    {ln}")

    # -- 3. kernels against their twins at the slice's shapes --------------
    geom = Geometry(dx=0.5, dy=0.5, dz=0.5, dt=1.5, nx=SIDE, ny=SIDE,
                    nz=SIDE, nt=1)
    report = {}
    for ppc, slots, vth in ((3, 8, 0.05), (20, 40, 0.05), (PPC, 80, VTH),
                            (100, 160, 0.05)):
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
        report["rebin_extract"] = dict(
            max_abs_err=max(float((o_k - o_p).abs().max()),
                            float((u_k - u_p).abs().max()),
                            float((d_k - d_p).abs().max())),
            ms=time_ms(lambda: NR.rebin_extract(buf, geom, 0)),
            plain_ms=time_ms(lambda: NR.extract_plain(buf, geom, 0)))
        report["rebin_place"] = dict(
            max_abs_err=float((pl_k - pl_p).abs().max()),
            ms=time_ms(lambda: NR.rebin_place(o_k, u_k, d_k, geom, 0)),
            plain_ms=time_ms(lambda: NR.place_plain(o_k, u_k, d_k, geom, 0)))
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
    report["cheb_step"] = dict(
        max_abs_err=cheb_err,
        ms=time_ms(lambda: cheb_matM_inv(rhs, shift, **cheb)),
        plain_ms=time_ms(lambda: cheb_matM_inv_plain(rhs, shift, **cheb)))
    log(f"[3 kernels] cheb degree 12 on {tuple(rhs.shape)}: max|d|/max|x| "
        f"= {rel:.3e} (tol {CHEB_TOL}; nvcc contracts multiply-adds into "
        f"FMAs, which round once) | apply {report['cheb_step']['ms']:.4f} "
        f"ms vs twin {report['cheb_step']['plain_ms']:.4f} ms | {card}")
    check(np.isfinite(rel) and rel <= CHEB_TOL,
          f"cheb_step differs from its twin by {rel:.3e}")

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
    check(all(v > 0 for v in launches.values()),
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
    check(all(v > 0 for v in lg.values()) and not any(lc.values()),
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

    sources = {
        "cheb_step": ("xpic_tpu_torch/csrc/cheb_step.cu",
                      "xpic_tpu/ops/pallas_stencil.py:120"),
        "rebin_extract": ("xpic_tpu_torch/csrc/rebin_extract.cu",
                          "xpic_tpu/ops/neighbor_rebin.py:279"),
        "rebin_place": ("xpic_tpu_torch/csrc/rebin_place.cu",
                        "xpic_tpu/ops/neighbor_rebin.py:348"),
    }
    rows = []
    for kname, (src, repl) in sources.items():
        row = dict(name=kname, route="cuda", source=src, replaces=repl,
                   launches=launches[kname], **report[kname])
        if kname == "rebin_place":
            row["also_replaces"] = ["xpic_tpu/ops/neighbor_rebin.py:496",
                                    "xpic_tpu/ops/neighbor_rebin.py:525"]
        rows.append(row)
    log(f"card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


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
