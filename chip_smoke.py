"""Drive the PyTorch port's main paths once on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``xpic_tpu_torch/csrc`` (into
``build/``), holds each against its plain PyTorch twin at the shapes of
the main paths, runs 10 fused ECSIM steps at 32^3 cells x 50 particles
per cell in float32 (the flagship workload of ``bench.py``), runs the
config-driven path (``python -m xpic_tpu_torch cfg.json``) at the same
size for an ECSIM, an eccapfim, an ecsimcorr (on both mass routes) and
a ``basic`` config, checks the card's results against the CPU's at a
smaller size, runs the calibration path (the primitive-rate probe and
the roofline calibration) and the step presets of the mirror machine,
then the float64 path of all four schemes, the schemes' default dtype
(``XPIC_X64`` unset), through the kernels' float64 instantiations.
Phases:

1. device: card name and power limit, the IEEE float32 pins;
2. build: one nvcc per source for sm_90a, with ptxas's register and
   spill lines, and each float64 kernel's registers, shared memory a
   block and resident warps an SM, by the runtime;
3. kernels against twins: the rebin exchange bitwise at AT = 8, 16, 32,
   64 and 128; the Chebyshev apply to 1e-5 relative on the 32^3 field,
   a 40 x 24 x 12 field with ghosted, periodic and reflective axes and a
   64^3 field (more elements than the card holds threads at once), two
   applies bitwise equal, one launch an apply; the mass apply at
   K = 80, 96 and 112 to 1e-5 of max |Y|, two calls bitwise equal; the
   slot gather at K = 80 to 2e-6
   of max |E_p|; each kernel's time back to back (R launches between two
   CUDA events, over R, queued behind a sleep kernel so that no host
   launch gap is in it: ``ms``) and per call (one wrapper call between
   two events, the host's launch gap in: ``call_ms``), beside its twin's
   time and its bound;
4. fused path: 10 steps through the kernels (every launch count grows;
   the KSP iterations of every step as ``ITERS`` holds them; the
   migration loses no particle beyond genuine K overflow);
5. card against CPU: 2 fused steps at 16^3 x 50 ppc;
6. config-driven path: ``runtime.cli.main`` on a 32^3 x 50 ppc ECSIM
   config (uniform B0 = 0.2 z, field and density dumps, 5 steps, float32)
   through all five kernels: finite tables, the KSP iterations of
   ``ITERS``, the energy identity within 1e-4 of the total energy, no
   particle dropped;
7. the same config at 16^3 x 20 ppc, 2 steps, on the card and on the
   CPU: tables within 1e-4 (``diagnostics.compare``), equal KSP;
8. the eccapfim path: ``runtime.cli.main`` on bench.py's eccapfim config
   (32^3 x 50 ppc, dt 1.5, float32, the default diagnostics and the
   ConvergenceHistory table), 1 warm-up step + 3 timed steps: the
   segment-field kernel and the Chebyshev and rebin kernels all launch,
   finite tables, the energy identity within 1e-4 of the total energy,
   the outer iterations of ``ITERS``; the operands of the run's first
   fast-path segment-field call are kept, and the kernel is held against
   its twin and timed on them (live segments a slot, ``ms``, bound);
9. the eccapfim config at 8^3 x 20 ppc, 2 steps, on the card and on the
   CPU: tables within 1e-4, outer iteration counts within 1 a step;
10. the ecsimcorr path: ``runtime.cli.main`` on bench.py's ecsimcorr
    config (32^3 x 50 ppc, dt 1.5, float32, the default diagnostics every
    step), 1 warm-up step + 3 timed steps, once on each mass route
    (``XPIC_MASS=free``: the mass-apply kernel and no fill;
    ``XPIC_MASS=blocks``: the fill kernel and no mass apply; the slot
    gather, Chebyshev and rebin kernels on both): finite tables,
    the predict and correct KSP iterations of ``ITERS``, the
    current-consistency norm < 0.1, the charge-continuity norms within
    1e-5 of rho / dt, and the two routes' tables within 1e-4 of each
    other;
11. the ecsimcorr config at 8^3 x 20 ppc, 2 steps, on the ``blocks``
    route, on the card and on the CPU: tables within 1e-4, equal predict
    and correct KSP;
12. the calibration path: ``python -m xpic_tpu_torch.benchmarks.
    profile_prims`` and ``.profile_roofcal`` through their ``main`` at
    their defaults (G = 32768), their JSON lines printed; the ``prims``
    kernel launched; then each of its six probes against its twin at
    [32768, 8, 128]: bitwise for copy, roll8 and select16, within 1e-5 of
    max |out| for fma16, fma64 and reduce16; ``out.copy_(x)`` timed as
    the copy's library yardstick;
13. the ``basic`` path: ``runtime.cli.main`` on a 32^3 x 50 ppc config
    (dx 0.05, dt 0.025, float32, the default diagnostics, a vx-vy
    VelocityDistribution and a LogView table every step, a backup every
    2 steps), 1 warm-up + 4 timed steps: the rebin kernels launch and no
    other, the neighbour exchange's guard logged, finite tables, no
    particle lost, charge continuity within 1e-5 of rho / dt,
    |dE+dB+dK| within 2e-5 of the initial kinetic energy every step;
    then a run restarted from the step-2 backup (``load_from``), its
    deposit, gathers and migration timed, reaches step 5 with rows
    within 1e-4 of the first run's;
14. the ``basic`` config at 16^3 x 20 ppc, 2 steps, on the card and on
    the CPU: tables within 1e-4, the velocity distributions within 1e-5
    of the largest bin (step 0 bitwise), one state's histogram bitwise
    equal on the card twice and on the CPU, equal particle counts;
15. the mirror machine of ``tests/test_commands.py`` (ecsimcorr,
    ghosted z, two coils, InjectParticles, RemoveParticles, cylinder
    FieldsDamping), 3 steps on the card and on the CPU: the source and
    sink columns present and finite with some injection, tables within
    1e-4, equal counts step by step, ecsimcorr's kernels on the card;
16. the float64 kernels (``cheb_step_f64``, ``slot_gather_f64``,
    ``segment_fields_f64``, ``ecsim_fill_f64``) against their float64
    twins on phase 3's operands cast to float64 (K1 on its three fields,
    K5 and K7 at K = 96 and 112, K6 at K' = 32 of 96, K' = 96 and on
    the long moves): within 1e-12 of the output's largest magnitude, two
    calls bitwise equal, timed beside the twin and the bound (float64
    operations at 34 TFLOP/s, the fill's at the tensor cores' 67); the
    float32 fill kernel and its twin each against the float64 product of
    the float32 operands; the float64 kernels' edges: the fill with 0,
    1, 3, 5 and 33 live slots a cell at K = 45 and 77, the segment
    fields on 9001 cells (no multiple of the persistent grid's stride)
    with a cell at rest;
17. the float64 paths at 32^3 x 50 ppc: ``runtime.cli.main`` with
    ``XPIC_X64`` unset on the ECSIM, ecsimcorr, eccapfim and ``basic``
    configs (1 warm-up + 2 timed steps), then 1 + 3 fused ECSIM steps
    on phase 4's state: each path's float64 kernels launch and no
    other (no float32 kernel; no K2 or K3: float64 migrates through the
    global sort; ``basic`` none), the iterations of ``ITERS_F64``, the
    energy identity of ECSIM and ecsimcorr within 1e-6 of the total
    energy, charge continuity (ecsimcorr, ``basic``) within 1e-5 of
    rho / dt, ``basic``'s energy within 2e-5 of wK_0 a step;
18. the configs and sizes of phases 7, 9, 11 and 14 in float64, card
    against CPU: tables within 1e-9 of each column's scale, equal
    iterations of every solver and equal counts step by step, step-0
    dumps bitwise;
19. the ECSIM path over two ranks that share the card (``"Mesh": 2``,
    one 16-plane z slab each; NCCL refuses two ranks on one device, so
    the ranks join with gloo, staged through pinned host buffers, and
    the phase first shows NCCL's refusal; two ranks on one card give no
    scaling figure): in the phase's own two ranks, K1's slab form
    (``cheb_sweep``, ``cheb_sweep_f64``: one deep-ghost exchange and one
    cooperative launch a segment, ceil(11 / min(11, t)) segments an apply
    on t planes: 1 at t = 16) on each rank's slab of phase 3's 32^3
    field, and in float64 also of a 16^3 field (t = 8: 2 segments),
    within 1e-5 (float32) and 1e-12 (float64) of its slab twin and
    bitwise equal to the one-launch K1 on the whole field, its launches
    and exchanges an apply counted, timed (a segment's launch and an
    apply with its exchanges); K3's z pass with ghost planes bitwise
    against its twin on phase 3's drifted state; 1 + 10 fused float32
    steps of phase 4's state (KSP within one of ``ITERS`` a step, step
    ms, bytes, exchange ms and collectives a step a rank, the
    collectives within 10% of ``MESH_CALLS_PREDICTED``); then
    ``runtime.cli.main`` with
    ``"Mesh": 2`` from this process (it starts the ranks; each writes
    its ``--report``) on phase 6's config, float32 ``free`` (tables
    within 1e-4 of phase 6's one-rank run, the energy identity within
    1e-4, no particle dropped), float32 ``blocks`` (against a one-rank
    ``blocks`` run), and float64 at 16^3 x 20 ppc (tables within 1e-9,
    equal iterations): every rank launches each kernel of its route;
20. ecsimcorr (both mass routes), ``basic`` (without its backup: a
    backup over ranks is ROADMAP A11b) and eccapfim over two ranks that
    share the card, at 32^3 x 50 ppc in float32 (1 + 2 steps, ``basic``
    1 + 3) and 16^3 x 20 ppc in float64 (1 + 2 steps): each config's
    one-rank run on the card, then one spawn of two ranks that run
    ``runtime.cli.main`` on every ``"Mesh": 2`` config as ranks of one
    group (each step timed, its bytes, exchange ms, collectives, K1
    slab applies and launches counted; each rank's ``--report``
    printed): K1's ghost exchanges and launches ceil(11 / min(11, t)) an
    apply, the float32 runs' collectives a step within 10% of
    ``MESH_CALLS_PREDICTED``, no collective handed a host tensor (a
    counting wrapper around ``SlabMesh``'s collectives), tables within 1e-4
    (float32) and 1e-9 (float64) of each column's scale of the one-rank
    run, the solvers' iterations equal (within one a step in float32),
    every particle kept, each kernel of the run launched on each rank;
    then on each rank K6 on its slab's window blocks (seeded 32^3
    fields, K' = 32 moves of up to 0.9 cell) in float32 and float64:
    the windows and K6 bitwise the whole grid's rows, K6 within phase
    3's tolerance of its twin, timed.

Phase 3 also holds the segment-field kernel against its twin on the
drifted 32^3 x 50 ppc state (K = 96) with moves of up to 0.9 cell a
axis, at K' = 32 (the fast path's crosser columns, read in place) and
K' = 96, and at K' = 32 with moves of 1.1 to 2.5 cells a axis (segments
longer than a cell, the kernel's whole-window branch), within 1e-5 of
max |E_p| and of max |B_p|, two calls bitwise equal, and the ECSIM fill
kernel against its twin on the drifted 32^3 x 50 ppc state at K = 96
and 112, within 1e-5 of max |L| and of max |Islot|, two calls bitwise
equal.

``python3 chip_smoke.py --profile`` adds, after phase 15, two fused steps
under ``torch.profiler``, the phase-6 config for 8 steps, the phase-8
config for 6 steps and the phase-10 config for 6 steps on each mass
route through ``xpic_tpu_torch.runtime.step_profile``.

Exits non-zero on any failure, and without CUDA.  The last line is
``{"ok": true, "device": {...}}``; the line before it lists each kernel,
the four float64 entry points as rows of their own (``cheb_step_f64``,
...), with its launches on the fused path, the ECSIM config-driven path,
the eccapfim path, the two ecsimcorr runs, the calibration path, the
``basic`` path (``launches_basic``) and each float64 path of phase 17
(``launches_f64_<path>``), its launches over phase 19's mesh runs,
both ranks (``launches_mesh2``), its launches over each run of phase
20, both ranks (``launches_mesh2_<run>``), K6 on a slab under its rows'
``slab`` key, and the slab form of K1 as rows of its
own (``cheb_sweep``, ``cheb_sweep_f64`` with the 16^3 case under ``t8``:
a segment launch's times, an apply's with its exchanges in ``apply_ms``),
its error against its twin, its times
(``ms``, ``call_ms``), its twin's and its bound; the float64 rows also
``registers``, ``smem_bytes`` (a block), ``threads``, ``warps_per_sm``
and ``local_bytes``.  The ``prims``
row's times are the copy probe's (with ``copy_``'s as ``library_ms``),
its error the largest of the six, and ``probes`` holds each probe's.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

SIDE, PPC, VTH, STEPS = 32, 50, 0.014, 10
KW = dict(q=-1.0, m=1.0, mpw=1.0 / PPC, maxit=100)
CHEB_TOL, FIELD_TOL, PARTICLE_TOL = 1e-5, 1e-4, 1e-5
MASS_TOL, GATHER_TOL, TABLE_TOL, ENERGY_TOL = 1e-5, 2e-6, 1e-4, 1e-4
SEGMENT_TOL, FILL_TOL, CHARGE_TOL, PRIM_TOL = 1e-5, 1e-5, 1e-5, 1e-5
CLI_STEPS = 5
# Each path's iterations, step by step, at 32^3 x 50 ppc (the KSP
# solves, ecsimcorr's correct solve on either mass route, eccapfim's
# outer iterations, a warm-up step first where the path has one), as
# the 12-launch K1 gave them: a preconditioner that computes the same
# must not move them.  A regression pin: a kernel that rightly reorders
# float32 sums may move a solve by an iteration (the CLI's last steps
# sit at the 1e-5 tolerance), and such a change may re-pin a list only
# beside a card-against-CPU run of the same path with equal iterations.
ITERS = {"fused": [4] * STEPS, "cli": [4, 4, 4, 5, 5],
         "ecsimcorr predict": [4] * 4, "ecsimcorr correct": [4] * 4,
         "eccapfim outer": [5] * 4}
FIM_STEPS = CORR_STEPS = 3  # timed, after one warm-up step
BASIC_STEPS = 4  # timed, after one warm-up step
MASS_ROUTES = ("free", "blocks")
# The basic scheme's cell and step (tests/test_basic_scheme.py), its
# energy bound a step against the initial kinetic energy
# (tests/test_basic_scheme.py:90), the backup its restart loads, and the
# parts of its step timed in the restart (step_profile's hooks).
BASIC_DX, BASIC_DT, BASIC_ENERGY_TOL, BASIC_RESTART = 0.05, 0.025, 2e-5, 2
VDF_TOL = 1e-5
BASIC_PARTS = {
    "esirkepov_current": ("schemes.basic", ("esirkepov_current",)),
    "gather_vector": ("schemes.basic", ("gather_vector",)),
    "migrate_checked": ("schemes.basic", ("migrate_checked",)),
}
# Float32 operations an element of one degree-12 Chebyshev apply,
# counted from cheb_step.cu's body: a first sweep of 46, ten middle
# sweeps of 33 and a last sweep of 1 (x += d).
CHEB_FLOPS = 46 + 33 * 10 + 1
# H100 SXM peaks (vendor datasheet): HBM bytes/s, float32 and float64
# FLOP/s outside the tensor cores, and float64 on the tensor cores (the
# float64 fill's products).
HBM_BPS, F32_FLOPS, F64_FLOPS = 3.35e12, 67e12, 34e12
F64_MMA_FLOPS = 67e12
# The float64 kernels against their float64 twins: within 1e-12 of the
# output's largest magnitude (sums in another order, FMAs).
F64_TOL = 1e-12
# The float64 paths at 32^3 x 50 ppc: one warm-up step, then timed ones
# (phase 17); the card against the CPU (phase 18) within 1e-9 of each
# table column's scale; the energy identity of ECSIM and ecsimcorr
# within 1e-6 of the total energy.
F64_STEPS, F64_TABLE_TOL, F64_ENERGY_TOL = 2, 1e-9, 1e-6
# The environment of a float32 run and of a float64 run (the schemes'
# default dtype: XPIC_X64 unset, as a user's first command has it); None
# unsets a variable (``run_env``).
F32_ENV = {"XPIC_X64": "0", "XPIC_MASS": None}
F64_ENV = {"XPIC_X64": None, "XPIC_MASS": None}
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
    "prims": ("xpic_tpu_torch/csrc/prims.cu",
              "benchmarks/profile_pallas_prims.py:27"),
    # K1's slab form, one deep-ghost segment a launch (phase 19)
    "cheb_sweep": ("xpic_tpu_torch/csrc/cheb_step.cu",
                   "xpic_tpu/ops/pallas_stencil.py:120"),
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
# The basic path runs the neighbour exchange's kernels and no other.
BASIC_KERNELS = ("rebin_extract", "rebin_place")
# The float64 paths' kernels (phase 17): each runs these and no other;
# float64 migrates through the global sort, so K2 and K3 do not launch.
F64_PATH_KERNELS = {
    "cli": ("cheb_step_f64", "slot_gather_f64", "ecsim_fill_f64"),
    "ecsimcorr": ("cheb_step_f64", "slot_gather_f64", "ecsim_fill_f64"),
    "fused": ("cheb_step_f64", "slot_gather_f64", "ecsim_fill_f64"),
    "eccapfim": ("cheb_step_f64", "segment_fields_f64"),
    "basic": (),
}
# The float64 paths' iterations at 32^3 x 50 ppc, step by step (phase
# 17: the warm-up step first; GMRES to 1e-7, eccapfim's outer solve to
# the reference's budgets), as the float64 kernels gave them, pinned
# beside phase 18's equal iterations on the card and the CPU, under the
# rule of ITERS.
ITERS_F64 = {"cli ksp": [7, 7, 6], "ecsimcorr ksp": [6, 6, 6],
             "ecsimcorr correct": [4, 4, 4], "eccapfim outer": [10, 9, 10],
             "fused ksp": [6, 6, 6]}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn) -> float:
    """The device time of one call of ``fn``: R calls back to back between
    two CUDA events, over R, with no host launch gap
    (``xpic_tpu_torch.benchmarks.device_ms``)."""
    from xpic_tpu_torch.benchmarks import device_ms

    return device_ms(fn, torch.device("cuda", 0))


def kernel_times(fn) -> dict:
    """A kernel row's times: back to back (``ms``) and per call
    (``call_ms``: one call between two CUDA events, the host's launch gap
    in; ``xpic_tpu_torch.benchmarks.call_ms``)."""
    from xpic_tpu_torch.benchmarks import call_ms

    return dict(ms=time_ms(fn), call_ms=call_ms(fn, torch.device("cuda", 0)))


def bound(n_bytes: float, n_flops: float, flops=F32_FLOPS) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the peak ``flops`` of their type
    (default float32)."""
    t_bytes = n_bytes / HBM_BPS * 1e3
    t_ops = n_flops / flops * 1e3
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
    from xpic_tpu_torch.benchmarks import card_label
    from xpic_tpu_torch.config import Geometry
    from xpic_tpu_torch.convert import state_from_numpy, to_numpy
    from xpic_tpu_torch.ops import neighbor_rebin as NR
    from xpic_tpu_torch.ops.binning import bin_state, drift_state
    from xpic_tpu_torch.parallel.step import ecsim_multi_step

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_label(dev)
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
    # What each float64 kernel takes on this card, by the runtime.
    f64_info = {n + kernels.F64: kernels.kernel_info(n + kernels.F64)
                for n in kernels.F64_KERNELS}
    for kname, info in f64_info.items():
        log(f"    {kname}: {info['registers']} registers, "
            f"{info['smem_bytes']} bytes of shared memory a block of "
            f"{info['threads']} threads, {info['warps_per_sm']} resident "
            f"warps an SM, {info['local_bytes']} bytes of local memory a "
            f"thread")

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
            **kernel_times(lambda: NR.rebin_extract(buf, geom, 0)),
            plain_ms=time_ms(lambda: NR.extract_plain(buf, geom, 0)),
            **bound(pass_bytes, 0))
        report["rebin_place"] = dict(
            max_abs_err=float((pl_k - pl_p).abs().max()),
            **kernel_times(lambda: NR.rebin_place(o_k, u_k, d_k, geom, 0)),
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

    report["cheb_step"] = cheb_kernel(geom, dev, card)
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
    check(iters.tolist() == ITERS["fused"],
          f"KSP iterations {iters.tolist()}, not {ITERS['fused']}")
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
    # Phase 19 holds its two ranks' run against this run's tables.
    keep = tempfile.TemporaryDirectory(prefix="xpic_smoke_")
    cli_out, sim, step_times, cli_launches = run_cli(
        keep.name, SIDE, PPC, CLI_STEPS, "cuda:0")
    check_cli_run(cli_out, sim, cli_launches, name, card, step_times)
    cli_ksp = list(sim.ksp_history)

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
    import xpic_tpu_torch.schemes.eccapfim as fim
    from xpic_tpu_torch.benchmarks.turns import (
        capture_fast_call,
        eccapfim_config,
    )

    fast_call = {}
    inner = capture_fast_call(fim, fast_call)
    with tempfile.TemporaryDirectory(prefix="xpic_smoke_") as work:
        try:
            out, sim, step_times, fim_launches = run_cli(
                work, SIDE, PPC, FIM_STEPS + 1, "cuda:0",
                doc=eccapfim_config)
        finally:
            fim.segment_fields = inner
        check_eccapfim_run(out, sim, fim_launches, name, card, step_times)
    check(bool(fast_call), "the eccapfim run made no fast-path call")
    kc = fast_call["kc"]
    report["segment_fields"]["path_operands"] = segment_row(
        fast_call["Eblk"], fast_call["Bblk"], fast_call["t0"][:, :kc],
        fast_call["tn"][:, :kc], "[8 eccapfim path] segment_fields on the "
        f"run's first fast-path call, K'={kc} of "
        f"K={fast_call['t0'].shape[1]}", card)
    del fast_call

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
            f"card {sim_g.correct_ksp_history} cpu {sim_c.correct_ksp_history}")
        check(all(lg[k] > 0 for k in CORR_KERNELS["blocks"])
              and not any(lc.values()),
              f"routing: card launches {lg}, CPU launches {lc}")
        check(all(e <= TABLE_TOL for _, e in worst.values()),
              "ecsimcorr card tables differ from the CPU's")
        check(sim_g.ksp_history == sim_c.ksp_history
              and sim_g.correct_ksp_history == sim_c.correct_ksp_history,
              "ecsimcorr KSP iterations differ between card and CPU")
    del os.environ["XPIC_MASS"]

    # -- 12. the calibration path ------------------------------------------
    cal_launches, report["prims"] = calibration_path(dev, card)

    # -- 13. the basic scheme on the card, with a restart ------------------
    basic_launches = basic_path(name, card)

    # -- 14. the basic scheme, card against CPU ------------------------------
    basic_card_vs_cpu(card)

    # -- 15. the commands and their energy columns, card against CPU -------
    commands_path(name, card)

    # -- 16. the float64 kernels against their float64 twins ---------------
    f64_rows = f64_kernels(geom, dev, card)

    # -- 17. the float64 paths at full width --------------------------------
    f64_launches, f64_k = f64_paths(name, card, dev, geom)
    # K5's and K7's rows at the K the ECSIM run ended with
    for kname, fn in (("slot_gather_f64", gather_kernel),
                      ("ecsim_fill_f64", fill_kernel)):
        if f64_k not in f64_rows[kname]:
            f64_rows[kname].update(fn(geom, dev, card, (f64_k,),
                                      dtype=torch.float64))
        report[kname] = f64_rows[kname][f64_k]
    report["cheb_step_f64"] = f64_rows["cheb_step_f64"]
    report["segment_fields_f64"] = f64_rows["segment_fields_f64"]

    # -- 18. the float64 paths, card against CPU ------------------------------
    f64_card_vs_cpu(card)

    # -- 19. the ECSIM path over two ranks sharing the card ----------------
    mesh_launches, mesh_rows = mesh_path(name, card, cli_out, cli_ksp)
    keep.cleanup()
    report.update((k, v) for k, v in mesh_rows.items()
                  if k in kernels.SIGNATURES)
    report["rebin_place"]["zghost"] = mesh_rows["rebin_place_zghost"]

    # -- 20. ecsimcorr, basic and eccapfim over two ranks ------------------
    scheme_launches, k6_rows = mesh_schemes_path(name, card)
    report["segment_fields"]["slab"] = k6_rows["float32"]
    report["segment_fields_f64"]["slab"] = k6_rows["float64"]

    if "--profile" in sys.argv[1:]:
        profile_paths(name, card, dev, lambda: ecsim_multi_step(
            E, B, B0, sp, geom, slots, n_steps=2, **KW))

    rows = []
    for kname in kernels.SIGNATURES:
        base = kname.removesuffix(kernels.F64)
        src, repl = KERNELS[base]
        own = {"segment_fields": fim_launches,
               "ecsim_fill": corr_launches["blocks"],
               "prims": cal_launches,
               "cheb_step_f64": f64_launches["cli"],
               "slot_gather_f64": f64_launches["cli"],
               "ecsim_fill_f64": f64_launches["cli"],
               "segment_fields_f64": f64_launches["eccapfim"],
               "cheb_sweep": mesh_launches,
               "cheb_sweep_f64": mesh_launches}.get(kname, launches)
        row = dict(name=kname, route="cuda", source=src, replaces=repl,
                   launches=own[kname], launches_fused=launches[kname],
                   launches_cli=cli_launches[kname],
                   launches_eccapfim=fim_launches[kname],
                   launches_ecsimcorr_free=corr_launches["free"][kname],
                   launches_ecsimcorr_blocks=corr_launches["blocks"][kname],
                   launches_probe=cal_launches[kname],
                   launches_basic=basic_launches[kname],
                   launches_mesh2=mesh_launches.get(kname, 0),
                   **{f"launches_mesh2_{run}": n.get(kname, 0)
                      for run, n in scheme_launches.items()},
                   library_ms=None,
                   **{f"launches_f64_{path}": n[kname]
                      for path, n in f64_launches.items()})
        row.update(report[kname])
        row.update(f64_info.get(kname, {}))
        if kname == "rebin_place":
            row["also_replaces"] = ["xpic_tpu/ops/neighbor_rebin.py:496",
                                    "xpic_tpu/ops/neighbor_rebin.py:525"]
        # What the kernel loses against its bound over every path: timed
        # calls x (ms - bound_ms).  Every wrapper call is one launch: a K1
        # apply of all 12 Chebyshev iterations, a slab segment of its
        # sweeps.
        calls = sum(v for k, v in row.items()
                    if k.startswith("launches_") and k != "launches_an_apply")
        row["excess_ms"] = calls * (row["ms"] - row["bound_ms"])
        rows.append(row)
    order = sorted(rows, key=lambda r: -r["excess_ms"])
    log("redesign order, timed calls x (ms - bound) over every path: "
        + ", ".join(f"{r['name']} {r['excess_ms']:.3f} ms" for r in order))
    log(f"card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


def basic_config(out_dir, side, ppc, steps):
    """The explicit scheme's run: ``side``^3 periodic cells of 0.05,
    dt 0.025 (``tests/test_basic_scheme.py``'s cell and step, Courant
    0.87), one electron species at ``ppc`` and T = 0.1 keV; the default
    diagnostics, the electrons' vx-vy velocity distribution and a LogView
    table every step, a backup every 2 steps."""
    L = side * BASIC_DX
    return {
        "Simulation": "basic",
        "OutputDirectory": out_dir,
        "Geometry": {"x": L, "y": L, "z": L, "t": steps * BASIC_DT,
                     "dx": BASIC_DX, "dy": BASIC_DX, "dz": BASIC_DX,
                     "dt": BASIC_DT, "diagnose_period": BASIC_DT},
        "Particles": [{"sort_name": "electrons", "Np": ppc, "n": 1.0,
                       "q": -1.0, "m": 1.0, "T": 0.1}],
        "Presets": [
            {"command": "SetParticles", "particles": "electrons",
             "coordinate": {"name": "CoordinateInBox"},
             "momentum": {"name": "MaxwellianMomentum", "tov": True}},
        ],
        "Diagnostics": [
            {"diagnostic": "VelocityDistribution", "particles": "electrons",
             "projection": "vx_vy"},
            {"diagnostic": "LogView", "level": "EachTimestep"},
        ],
        "SimulationBackup": {"diagnose_period": 2 * BASIC_DT},
    }


def basic_restart_config(out_dir, side, ppc, steps):
    """:func:`basic_config` restarted from its step-``BASIC_RESTART``
    backup, which holds the particles."""
    doc = basic_config(out_dir, side, ppc, steps)
    doc["Presets"] = []
    doc["SimulationBackup"]["load_from"] = BASIC_RESTART
    return doc


def basic_path(name, card):
    """Phase 13: ``runtime.cli.main`` on :func:`basic_config` at 32^3 x
    50 ppc, float32, 1 warm-up + ``BASIC_STEPS`` timed steps, the launch
    counts set to 0 just before; the neighbour exchange's guard recorded
    a migration.  Gates: K2 and K3 launch and no other kernel; every table
    finite with a row a step; no particle lost; charge continuity within
    ``CHARGE_TOL`` of rho / dt; |dE+dB+dK| within ``BASIC_ENERGY_TOL`` of
    the initial kinetic energy every step.  Then a second run restarts
    from the step-2 backup (``load_from``) with the deposit, the gathers
    and the migration timed (each closed by a synchronisation) and
    reaches the last step, whose rows must lie within ``TABLE_TOL`` of
    the first run's.  Returns the first run's launches."""
    import shutil

    from xpic_tpu_torch.diagnostics.compare import (
        TABLES,
        read_table,
        table_errors,
    )
    from xpic_tpu_torch.ops import neighbor_rebin as NR
    from xpic_tpu_torch.runtime.step_profile import _patch, _unpatch

    guard = []
    stats = NR.neighbor_guard_stats

    def recorded(st, geom):
        out = stats(st, geom)
        guard.append(bool(out[0]))
        return out

    steps = BASIC_STEPS + 1
    n_cells, n0 = SIDE ** 3, SIDE ** 3 * PPC
    with tempfile.TemporaryDirectory(prefix="xpic_smoke_") as work:
        NR.neighbor_guard_stats = recorded
        try:
            out, sim, step_ms, launches = run_cli(
                os.path.join(work, "run"), SIDE, PPC, steps, "cuda:0",
                doc=basic_config)
        finally:
            NR.neighbor_guard_stats = stats
        tables = {t: read_table(os.path.join(out, "temporal", t))
                  for t in TABLES}
        h_en, en = tables["energy.txt"]
        h_ec, ec = tables["energy_conservation.txt"]
        wk0 = en[0, h_en.index("wK_electrons")]
        energy = np.abs(ec[1:, h_ec.index("dE+dB+dK")]).max() / wk0
        charge = charge_share(*tables["charge_conservation.txt"], n_cells,
                              BASIC_DT)
        h_log, log_rows = read_table(os.path.join(
            out, "temporal", "log_EachTimestep.txt"))
        # each row's diagnostics are the step before's
        diag_ms = [round(1e3 * v, 3)
                   for v in log_rows[1:, h_log.index("diagnostics")]]
        vdf = len(os.listdir(os.path.join(out, "electrons", "vx_vy")))
        kept = sorted(os.listdir(os.path.join(out, "simulation_backup")))
        ms = statistics.median(step_ms[1:])
        slots = sim.species[0].slots
        log(f"[13 basic path] python -m xpic_tpu_torch cfg.json: {SIDE}^3 "
            f"x {PPC} ppc f32, dx {BASIC_DX}, dt {BASIC_DT}, 1 + "
            f"{BASIC_STEPS} steps, K={slots}, {n0} particles: ms/step "
            f"median {ms:.3f} (per step {[round(v, 3) for v in step_ms]}, "
            f"the first a warm-up), particle_steps_per_s="
            f"{n0 / ms * 1e3:.4e}, diagnostics of steps 1.."
            f"{BASIC_STEPS} (LogView, host clock; backups at even steps) "
            f"{diag_ms} ms; neighbour-exchange guard passed "
            f"{sum(guard)} of {len(guard)} migrations; counts "
            f"{sim.count_history}; max |dE+dB+dK| / wK_0 = {energy:.3e} "
            f"(tol {BASIC_ENERGY_TOL}); charge continuity / (rho/dt) "
            f"{charge:.3e} (tol {CHARGE_TOL}); velocity distributions "
            f"{vdf}, backups kept {kept}; launches {launches} | {name} | "
            f"{card}")
        check(all(launches[k] > 0 for k in BASIC_KERNELS)
              and not any(n for k, n in launches.items()
                          if k not in BASIC_KERNELS),
              f"the basic path's launches {launches}")
        check(all(np.isfinite(rows).all() and rows.shape[0] == steps + 1
                  for _, rows in tables.values()),
              "a basic table row is not finite, or a row is missing")
        check(sim.count_history == [[n0]] * steps,
              f"basic lost particles: {sim.count_history}")
        check(charge <= CHARGE_TOL, "basic does not conserve charge")
        check(energy <= BASIC_ENERGY_TOL,
              f"basic's energy error {energy:.3e} of wK_0 a step")
        check(vdf == steps + 1 and kept == [str(BASIC_RESTART + 2 * i)
                                            for i in range(2)],
              f"velocity distributions {vdf}, backups {kept}")

        again = os.path.join(work, "restart")
        shutil.copytree(os.path.join(out, "simulation_backup",
                                     str(BASIC_RESTART)),
                        os.path.join(again, "out", "simulation_backup",
                                     str(BASIC_RESTART)))
        parts = {}
        patched = _patch(BASIC_PARTS, torch.cuda.synchronize, parts)
        try:
            out2, sim2, step2_ms, _ = run_cli(
                again, SIDE, PPC, steps, "cuda:0", doc=basic_restart_config)
        finally:
            _unpatch(patched)
        errs = {table: table_errors(table, out, out2, n_cells,
                                    charge_scale=np.sqrt(n_cells) / BASIC_DT,
                                    dt=BASIC_DT, step=steps)
                for table in TABLES}
        worst = {t: max(e.items(), key=lambda kv: kv[1])
                 for t, e in errs.items()}
        n_timed = len(step2_ms)
        parts_ms = {k: v / n_timed for k, v in parts.items()}
        step2 = statistics.mean(step2_ms)
        log(f"[13 basic restart] load_from {BASIC_RESTART}, steps "
            f"{BASIC_RESTART + 1}..{steps}: ms/step "
            f"{[round(v, 3) for v in step2_ms]}"
            f" with the parts closed by synchronisations, a step: "
            f"{ {k: round(v, 3) for k, v in parts_ms.items()} } ms, the "
            f"deposit's share {parts_ms['esirkepov_current'] / step2:.3f}; "
            f"counts {sim2.count_history}; step {steps} rows against the "
            f"uninterrupted run, worst column per table {worst} (tol "
            f"{TABLE_TOL}) | {name} | {card}")
        check(sim2.start == BASIC_RESTART and n_timed == steps - BASIC_RESTART
              and sim2.count_history == [[n0]] * n_timed,
              f"the restart ran {n_timed} steps, counts "
              f"{sim2.count_history}")
        check(all(e <= TABLE_TOL for _, e in worst.values()),
              "the restarted run's last rows differ from the first run's")
    return launches


def basic_card_vs_cpu(card):
    """Phase 14: :func:`basic_config` at 16^3 x 20 ppc, 2 steps, float32,
    on the card and on the CPU: tables within ``TABLE_TOL`` (the charge
    norms against rho / dt), the velocity distributions within
    ``VDF_TOL`` of the largest bin, equal counts; K2 and K3 launch on the
    card, no kernel on the CPU."""
    from xpic_tpu_torch.convert import to_numpy
    from xpic_tpu_torch.diagnostics.compare import TABLES, table_errors

    side = 16
    with tempfile.TemporaryDirectory(prefix="xpic_smoke_") as work:
        runs = {}
        for device in ("cuda:0", "cpu"):
            runs[device] = run_cli(os.path.join(work, device.split(":")[0]),
                                   side, 20, 2, device, doc=basic_config)
        (out_g, sim_g, _, lg), (out_c, sim_c, _, lc) = (runs["cuda:0"],
                                                        runs["cpu"])
        worst = {}
        for table in TABLES:
            errs = table_errors(table, out_c, out_g, n_cells=side ** 3,
                                charge_scale=np.sqrt(side ** 3) / BASIC_DT,
                                dt=BASIC_DT)
            worst[table] = max(errs.items(), key=lambda kv: kv[1])
            log(f"    {table}: {errs}")
        vdf = os.path.join("electrons", "vx_vy")
        names = sorted(os.listdir(os.path.join(out_c, vdf)))
        first_equal = (
            open(os.path.join(out_g, vdf, names[0]), "rb").read()
            == open(os.path.join(out_c, vdf, names[0]), "rb").read())
        vdf_err, moved = 0.0, []
        w = np.float32(1.0 / 20)
        for nm in names:
            a = np.fromfile(os.path.join(out_g, vdf, nm), dtype=np.float32)
            b = np.fromfile(os.path.join(out_c, vdf, nm), dtype=np.float32)
            check(a.shape == b.shape, f"velocity distribution {nm} shapes")
            vdf_err = max(vdf_err, float(np.abs(a - b).max() / b.max()))
            # particles counted in another bin on the card than on the CPU
            moved.append(float(np.abs(a - b).sum() / (2 * w)))
        # The two runs' last states, slot by slot, and the histogram of
        # the card's last state on both devices.
        st_g, st_c = (to_numpy(sim.species[0].state) for sim in (sim_g,
                                                                 sim_c))
        same_slots = np.array_equal(st_g.valid, st_c.valid)
        dp = (np.abs(st_g.p - st_c.p)[st_c.valid] if same_slots
              else np.full((1, 3), np.inf))
        dr = (np.abs(st_g.r - st_c.r)[st_c.valid] if same_slots
              else np.full((1, 3), np.inf))
        vd_g, vd_c = (next(d for d in sim.diagnostics
                           if type(d).__name__ == "VelocityDistribution")
                      for sim in (sim_g, sim_c))
        arr = sim_g.species[0].arrays
        h1, h2 = vd_g.collect(arr), vd_g.collect(arr)
        h_cpu = vd_c.collect(type(arr)(r=arr.r.cpu(), p=arr.p.cpu(),
                                       alive=arr.alive.cpu()))
        same_hist = (torch.equal(h1, h2)
                     and torch.equal(h1.cpu(), h_cpu))
        log(f"[14 card vs cpu, basic] {side}^3 x 20 ppc f32, 2 steps: worst "
            f"column per table {worst} (tol {TABLE_TOL}); velocity "
            f"distributions {len(names)}, step 0 bitwise equal "
            f"{first_equal}, max |d| / max bin {vdf_err:.3e} (tol "
            f"{VDF_TOL}), particles in another bin per file {moved}; "
            f"last states: same slots {same_slots}, p differs in "
            f"{int((dp > 0).any(-1).sum())} of {len(dp)} live slots, max "
            f"|dp| {dp.max():.3e} (max |p| {np.abs(st_c.p).max():.3e}), r "
            f"differs in {int((dr > 0).any(-1).sum())}, max |dr| "
            f"{dr.max():.3e} cells; the card's last state's histogram on "
            f"the card twice and on the CPU bitwise equal: {same_hist}; "
            f"counts card {sim_g.count_history} cpu "
            f"{sim_c.count_history}; launches card {lg} cpu {lc} | {card}")
        check(all(lg[k] > 0 for k in BASIC_KERNELS)
              and not any(lc.values()),
              f"routing: card launches {lg}, CPU launches {lc}")
        check(all(e <= TABLE_TOL for _, e in worst.values()),
              "basic card tables differ from the CPU's")
        check(sorted(os.listdir(os.path.join(out_g, vdf))) == names
              and len(names) == 3 and first_equal and vdf_err <= VDF_TOL,
              "basic card velocity distributions differ from the CPU's")
        check(same_hist, "the velocity histogram of one state differs "
              "between two card calls or between the card and the CPU")
        check(sim_g.count_history == sim_c.count_history,
              "basic card counts differ from the CPU's")


def mirror_config(out_dir, side, ppc, steps):
    """``tests/test_commands.py``'s mirror machine (its size; ``side``
    and ``ppc`` are not used): ecsimcorr on 8 x 8 x 12 cells of 0.5,
    dt 0.5, z ghosted (open), two coils, electrons in a cylinder, and
    every step paired injection of ions and electrons, removal of the
    electrons outside r = 1.8 and cylinder damping of the fields."""
    ghosted, periodic = "DM_BOUNDARY_GHOSTED", "DM_BOUNDARY_PERIODIC"
    return {
        "Simulation": "ecsimcorr",
        "OutputDirectory": out_dir,
        "Geometry": {"x": 4.0, "y": 4.0, "z": 6.0, "t": steps * 0.5,
                     "dx": 0.5, "dy": 0.5, "dz": 0.5, "dt": 0.5,
                     "diagnose_period": 1, "da_boundary_x": periodic,
                     "da_boundary_y": periodic, "da_boundary_z": ghosted},
        "Particles": [
            {"sort_name": "electrons", "Np": 10, "n": 1.0, "q": -1.0,
             "m": 1.0, "T": 0.02},
            {"sort_name": "ions", "Np": 10, "n": 1.0, "q": 1.0,
             "m": 100.0, "T": 0.02},
        ],
        "Presets": [
            {"command": "SetMagneticField",
             "field": {"name": "SetCoilsField",
                       "coils": [{"z0": 1.0, "R": 1.5, "I": 0.05},
                                 {"z0": 5.0, "R": 1.5, "I": 0.05}]}},
            {"command": "SetParticles", "particles": "electrons",
             "coordinate": {"name": "CoordinateInCylinder", "radius": 1.0,
                            "height": 4.0},
             "momentum": {"name": "MaxwellianMomentum"}},
        ],
        "StepPresets": [
            {"command": "InjectParticles", "ionized": "ions",
             "ejected": "electrons", "per_step_particles_num": 20,
             "coordinate": {"name": "CoordinateInCylinder", "radius": 0.5,
                            "height": 2.0},
             "momentum_i": {"name": "MaxwellianMomentum"},
             "momentum_e": {"name": "MaxwellianMomentum"}},
            {"command": "RemoveParticles", "particles": "electrons",
             "geometry": {"name": "CylinderGeometry", "radius": 1.8}},
            {"command": "FieldsDamping",
             "geometry": {"name": "CylinderGeometry", "radius": 1.6,
                          "coefficient": 0.8}},
        ],
        "Diagnostics": [],
    }


def commands_path(name, card):
    """Phase 15: :func:`mirror_config` for 3 steps on the card and on the
    CPU, float32, on the default mass route: the Damped(E+B), Inj_* and
    Rm_* columns present and finite and some injection seen; the tables
    within ``TABLE_TOL``; the species counts equal step by step (where
    they are not, the particles that one device removed and the other
    kept are printed with their radii); ecsimcorr's kernels launch on the
    card, none on the CPU."""
    from xpic_tpu_torch.commands.remove_particles import RemoveParticles
    from xpic_tpu_torch.diagnostics.compare import (
        TABLES,
        read_table,
        table_errors,
    )

    removed = {}
    execute = RemoveParticles.execute

    def recording(self, t):
        arr = self.species.arrays
        before, r = arr.alive.cpu().numpy(), arr.r.cpu().numpy()
        execute(self, t)
        after = self.species.arrays.alive.cpu().numpy()
        removed[run].append(r[before & ~after].astype(np.float64))

    cols = ("Damped(E+B)", "Inj_ions", "Inj_electrons", "Rm_electrons",
            "dE+dB+dK")
    steps = 3
    with tempfile.TemporaryDirectory(prefix="xpic_smoke_") as work:
        runs = {}
        RemoveParticles.execute = recording
        try:
            for run in ("cuda:0", "cpu"):
                removed[run] = []
                runs[run] = run_cli(os.path.join(work, run.split(":")[0]),
                                    0, 0, steps, run, doc=mirror_config)
        finally:
            RemoveParticles.execute = execute
        (out_g, sim_g, ms_g, lg), (out_c, sim_c, _, lc) = (runs["cuda:0"],
                                                           runs["cpu"])
        header, rows = read_table(os.path.join(out_g, "temporal",
                                               "energy_conservation.txt"))
        worst = {}
        for table in TABLES:
            errs = table_errors(table, out_c, out_g, n_cells=8 * 8 * 12,
                                charge_scale=np.sqrt(8 * 8 * 12) / 0.5,
                                dt=0.5)
            worst[table] = max(errs.items(), key=lambda kv: kv[1])
            log(f"    {table}: {errs}")
        present = all(c in header for c in cols)
        shown = {c: rows[:, header.index(c)].tolist() for c in cols
                 if c in header}
        log(f"[15 commands, card vs cpu] mirror machine (ecsimcorr, 8 x 8 x "
            f"12, z ghosted, coils, InjectParticles, RemoveParticles, "
            f"FieldsDamping) f32, {steps} steps: card ms/step "
            f"{[round(v, 3) for v in ms_g]}; card columns {shown}; worst "
            f"column per table {worst} (tol {TABLE_TOL}); counts (electrons,"
            f" ions) card {sim_g.count_history} cpu {sim_c.count_history}; "
            f"launches card {lg} cpu {lc} | {name} | {card}")
        if sim_g.count_history != sim_c.count_history:
            for step, (a, b) in enumerate(zip(removed["cuda:0"],
                                              removed["cpu"]), start=1):
                only_g = {tuple(x) for x in a} - {tuple(x) for x in b}
                only_c = {tuple(x) for x in b} - {tuple(x) for x in a}
                for who, pts in (("card", only_g), ("cpu", only_c)):
                    for x in sorted(pts):
                        log(f"    step {step}: removed on the {who} only: r "
                            f"{x}, radius {np.hypot(x[0] - 2.0, x[1] - 2.0)!r}"
                            f" (keep < 1.8)")
        check(present and np.isfinite(rows).all()
              and max(shown["Inj_ions"]) > 0.0,
              f"the commands' energy columns {shown}")
        check(all(e <= TABLE_TOL for _, e in worst.values()),
              "the mirror machine's card tables differ from the CPU's")
        check(sim_g.count_history == sim_c.count_history,
              "the mirror machine's card counts differ from the CPU's")
        check(all(lg[k] > 0 for k in CORR_KERNELS["free"])
              and not any(lc.values()),
              f"routing: card launches {lg}, CPU launches {lc}")


def f64_kernels(geom, dev, card):
    """Phase 16: the four float64 kernels against their float64 twins on
    phase 3's operands cast to float64 (K1 on its three fields, K5 and
    K7 at K = 96 and 112, K6 at K' = 32 of 96, K' = 96 and on the long
    moves), each within ``F64_TOL`` of its output's largest magnitude,
    two calls bitwise equal, timed beside its twin and its bound (bytes
    twice the float32 operands', operations over the float64 peak).  K7
    also holds the float32 kernel and the float32 twin against its
    float64 product.  Returns the rows: K1's and K6's, and K5's and K7's
    by K."""
    f64 = torch.float64
    fill_f64_edges(dev)
    segment_f64_edges(dev)
    return {"cheb_step_f64": cheb_kernel(geom, dev, card, f64),
            "slot_gather_f64": gather_kernel(geom, dev, card, (96, 112),
                                             f64),
            "segment_fields_f64": segment_kernel(geom, dev, card,
                                                 f64)["segment_fields"],
            "ecsim_fill_f64": fill_kernel(geom, dev, card, (96, 112), f64)}


def fill_f64_edges(dev):
    """Phase 16's edges of the float64 fill kernel (its k-steps of 4 live
    slots, tiles of 32): 16^3 cells at K = 45 and 77 (not multiples of
    32), 70% of slots live at random, cells 0-4 with 0, 1, 3, 5 and 33
    live slots; each of those cells within ``F64_TOL`` of its own twin's
    max (cell 0 exactly zero), the whole within ``F64_TOL``, two calls
    bitwise equal."""
    from xpic_tpu_torch.ops.ecsim_kernel import ecsim_fill, ecsim_fill_plain

    kw = dict(q=-1.0, m=1.0, mpw=0.02, dt=1.5)
    G, counts = 16 ** 3, (0, 1, 3, 5, 33)
    for K in (45, 77):
        rng = np.random.default_rng(K)
        valid = rng.random((G, K)) < 0.7
        for cell, n in enumerate(counts):
            valid[cell] = False
            valid[cell, rng.choice(K, n, replace=False)] = True
        t, v, B_p = (torch.tensor(a, dtype=torch.float64, device=dev)
                     for a in (rng.random((G, K, 3)),
                               0.05 * rng.standard_normal((G, K, 3)),
                               0.25 * rng.standard_normal((G, K, 3))))
        valid = torch.tensor(valid, device=dev)
        got = ecsim_fill(t, v, B_p, valid, **kw)
        again = ecsim_fill(t, v, B_p, valid, **kw)
        ref = ecsim_fill_plain(t, v, B_p, valid, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        rel = max(float((a - b).abs().max()) / float(b.abs().max())
                  for a, b in zip(got, ref))
        cells = [max(float((a[c] - b[c]).abs().max())
                     / float(b[c].abs().max()) for a, b in zip(got, ref))
                 for c in range(1, len(counts))]
        empty = not any(bool(a[0].any()) for a in got)
        log(f"[16 f64 kernels] ecsim_fill_f64 edges K={K}: max|d|/max "
            f"{rel:.3e}; cells of {counts[1:]} live slots {cells} (tol "
            f"{F64_TOL}); the cell of 0 zero: {empty}; two calls bitwise "
            f"equal: {same}")
        check(rel <= F64_TOL and max(cells) <= F64_TOL and empty and same,
              f"ecsim_fill_f64 edges at K={K}")


def segment_f64_edges(dev):
    """Phase 16's edges of the float64 segment-field kernel (its ring of
    window stages over a persistent grid): G = 9001 cells (a prime: no
    multiple of the grid's stride, and more than two strides), K' = 32
    of 40 and K' = 40 (a second slot group of 8), cell 0 wholly at rest
    (one segment a slot, the fewest: no slot has none), cell 1 crossing
    three faces a slot; within ``F64_TOL`` of the twin's max, two calls
    bitwise equal."""
    from xpic_tpu_torch.ops.segment_kernel import (
        segment_fields,
        segment_fields_plain,
    )

    G, K = 9001, 40
    rng = np.random.default_rng(9001)

    def f64(a):
        return torch.tensor(a, dtype=torch.float64, device=dev)

    Eblk = f64(rng.standard_normal((G, 3, 6, 6, 6)))
    Bblk = f64(rng.standard_normal((G, 3, 6, 6, 6)))
    t0 = rng.random((G, K, 3))
    move = rng.uniform(-0.9, 0.9, (G, K, 3))
    move[0] = 0.0
    t0[1] = (0.45, 0.4, 0.35)
    move[1] = (0.3, 0.25, 0.2)
    t0, tn = f64(t0), f64(t0 + move)
    for kp in (32, K):
        a, b = t0[:, :kp], tn[:, :kp]
        got = segment_fields(Eblk, Bblk, a, b)
        again = segment_fields(Eblk, Bblk, a, b)
        ref = segment_fields_plain(Eblk, Bblk, a, b)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        rel = max(float((x - y).abs().max()) / float(y.abs().max())
                  for x, y in zip(got, ref))
        log(f"[16 f64 kernels] segment_fields_f64 edges G={G} K'={kp} of "
            f"{K}: max|d|/max {rel:.3e} (tol {F64_TOL}), two calls bitwise "
            f"equal: {same}")
        check(rel <= F64_TOL and same, f"segment_fields_f64 edges K'={kp}")
    del Eblk, Bblk, got, again, ref


def gather_kernel(geom, dev, card, ks, dtype):
    """The slot gather on phase 3's state and field at each K of ``ks``
    (``slot_kernels``' operands, cast to ``dtype``): against its twin
    (``GATHER_TOL``, float64 ``F64_TOL``), two calls bitwise equal.
    Returns the rows by K."""
    from xpic_tpu_torch import kernels
    from xpic_tpu_torch.convert import state_from_numpy
    from xpic_tpu_torch.ops.binning import bin_state, drift_state, rebin
    from xpic_tpu_torch.ops.ecsim_blocks import gather_slots
    from xpic_tpu_torch.ops.ecsim_kernel import (
        ecsim_gather,
        ecsim_gather_plain,
    )
    from xpic_tpu_torch.ops.gather_scatter import cell_t

    f64 = dtype == torch.float64
    tag, tol, flops = (("16 f64 kernels", F64_TOL, F64_FLOPS) if f64
                       else ("3 kernels", GATHER_TOL, F32_FLOPS))
    rng = np.random.default_rng(7)  # slot_kernels' draws, in its order
    shape = (3,) + geom.shape
    rng.standard_normal(shape)
    x = rng.standard_normal(shape)
    rows = {}
    for slots in ks:
        *_, r, p, alive = bench_state(geom, PPC, VTH, seed=1)
        xt, _, _, sp = state_from_numpy(x, np.zeros(1), np.zeros(1), r, p,
                                        alive, device=dev,
                                        dtype=torch.float32)
        st = rebin(drift_state(bin_state(sp, geom, slots), geom), geom)
        t = cell_t(geom, st.r).to(dtype)
        Fg = gather_slots(xt, geom).to(dtype)
        kname = kernels.entry("slot_gather", t)
        E_k = ecsim_gather(t, Fg)
        E_2 = ecsim_gather(t, Fg)
        E_p = ecsim_gather_plain(t, Fg)
        torch.cuda.synchronize()
        same = torch.equal(E_k, E_2)
        err = float((E_k - E_p).abs().max())
        rel = err / float(E_p.abs().max())
        n_valid = int(st.valid.sum())
        # Read t and Fg, write E_p; ~75 operations per live slot.
        row = rows[slots] = dict(
            max_abs_err=err, **kernel_times(lambda: ecsim_gather(t, Fg)),
            plain_ms=time_ms(lambda: ecsim_gather_plain(t, Fg)),
            **bound(t.element_size() * (2 * t.numel() + Fg.numel()),
                    75 * n_valid, flops))
        log(f"[{tag}] {kname} K={slots}: max|d|/max|E_p| = {rel:.3e} (tol "
            f"{tol}), two calls bitwise equal: {same} | {row['ms']:.4f} ms "
            f"({row['call_ms']:.4f} a call) vs twin {row['plain_ms']:.4f} "
            f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), share "
            f"{row['bound_ms'] / row['ms']:.3f} | {card}")
        check(np.isfinite(rel) and rel <= tol,
              f"{kname} differs from its twin by {rel:.3e} at K={slots}")
        check(same, f"two {kname} calls differ at K={slots}")
    return rows


@contextlib.contextmanager
def run_env(env):
    """Set (or, for None, unset) the variables of ``env`` inside; put back
    after."""
    saved = {k: os.environ.get(k) for k in env}
    try:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def f64_launch_gate(path, launches):
    """Phase 17 and 18's launch gate of one float64 path on the card:
    its float64 kernels launch, no other kernel does (no float32
    kernel, and no K2 or K3: float64 migrates through the global
    sort)."""
    want = F64_PATH_KERNELS[path]
    check(all(launches[k] > 0 for k in want)
          and not any(n for k, n in launches.items() if k not in want),
          f"the float64 {path} path's launches {launches}")


def f64_paths(name, card, dev, geom):
    """Phase 17: ``python -m xpic_tpu_torch cfg.json`` with ``XPIC_X64``
    unset (float64) at 32^3 x 50 ppc for ECSIM (:func:`cli_config`),
    ecsimcorr (:func:`ecsimcorr_config`: both mass settings assemble in
    float64, so one run), eccapfim (``turns.eccapfim_config``) and
    ``basic`` (:func:`basic_config`), 1 warm-up + ``F64_STEPS`` timed
    steps each, then 1 + 3 fused ECSIM steps on phase 4's state in
    float64.  Gates: the launches of ``F64_PATH_KERNELS``; the run in
    float64; the iterations of ``ITERS_F64``; ECSIM and ecsimcorr's
    energy identity within ``F64_ENERGY_TOL`` of the total energy a
    step; ecsimcorr and ``basic`` conserve charge within ``CHARGE_TOL``
    of rho / dt; ``basic``'s |dE+dB+dK| within ``BASIC_ENERGY_TOL`` of
    wK_0 a step.  Returns the launches by path and the K of the ECSIM
    run."""
    from xpic_tpu_torch import kernels
    from xpic_tpu_torch.benchmarks.turns import eccapfim_config
    from xpic_tpu_torch.convert import state_from_numpy
    from xpic_tpu_torch.diagnostics.compare import TABLES, read_table
    from xpic_tpu_torch.parallel.step import ecsim_multi_step

    launches = {}
    docs = {"cli": cli_config, "ecsimcorr": ecsimcorr_config,
            "eccapfim": eccapfim_config, "basic": basic_config}
    steps = F64_STEPS + 1
    with run_env(F64_ENV), tempfile.TemporaryDirectory(
            prefix="xpic_smoke_") as work:
        for path, doc in docs.items():
            out, sim, step_ms, launches[path] = run_cli(
                os.path.join(work, path), SIDE, PPC, steps, "cuda:0",
                doc=doc)
            tables = {t: read_table(os.path.join(out, "temporal", t))
                      for t in TABLES
                      if os.path.exists(os.path.join(out, "temporal", t))}
            h_en, en = tables["energy.txt"]
            h_ec, ec = tables["energy_conservation.txt"]
            total = en[:, 1:1 + (len(h_en) - 1) // 2].sum(axis=1)
            closure = np.abs(ec[:, h_ec.index("dE+dB+dK")])
            dt = BASIC_DT if path == "basic" else 1.5
            iters = {"ksp": getattr(sim, "ksp_history", None),
                     "correct": getattr(sim, "correct_ksp_history", None),
                     "outer": getattr(sim, "outer_history", None),
                     "cn": getattr(sim, "cn_history", None)}
            iters = {k: list(v) for k, v in iters.items() if v}
            stats = dict(energy=float((closure / total).max()))
            if path in ("ecsimcorr", "basic"):
                stats["charge"] = charge_share(
                    *tables["charge_conservation.txt"], SIDE ** 3, dt)
            if path == "basic":
                stats["energy"] = float(closure[1:].max()
                                        / en[0, h_en.index("wK_electrons")])
            sp = sim.species[0]
            ms = statistics.median(step_ms[1:])
            log(f"[17 f64 paths] {path}: python -m xpic_tpu_torch cfg.json "
                f"(XPIC_X64 unset) {SIDE}^3 x {PPC} ppc {sim.E.dtype}, 1 + "
                f"{F64_STEPS} steps, K={sp.slots}, {sp.count()} particles: "
                f"ms/step median {ms:.3f} (per step "
                f"{[round(v, 3) for v in step_ms]}, the first a warm-up), "
                f"iterations {iters}, "
                f"{ {k: f'{v:.3e}' for k, v in stats.items()} } "
                f"(energy: |dE+dB+dK| over the total energy, basic's over "
                f"wK_0; charge: continuity over rho/dt), launches "
                f"{launches[path]} | {name} | {card}")
            f64_launch_gate(path, launches[path])
            check(sim.E.dtype == torch.float64,
                  f"the {path} run took {sim.E.dtype}")
            check(all(np.isfinite(rows).all() and rows.shape[0] == steps + 1
                      for _, rows in tables.values()),
                  f"a float64 {path} table row is not finite, or missing")
            for key, want in ITERS_F64.items():
                if key.startswith(path + " "):
                    got = iters[key.split(" ", 1)[1]]
                    check(got == want,
                          f"float64 {key} iterations {got}, not {want}")
            if path in ("cli", "ecsimcorr"):
                check(stats["energy"] <= F64_ENERGY_TOL,
                      f"the float64 {path} energy identity fails")
            if path == "basic":
                check(stats["energy"] <= BASIC_ENERGY_TOL,
                      "float64 basic's energy error a step")
            if "charge" in stats:
                check(stats["charge"] <= CHARGE_TOL,
                      f"float64 {path} does not conserve charge")
            if path == "cli":
                cli_k = sp.slots

    # The fused steps on phase 4's state (bench.py's ecsim_f64 workload).
    E, B, B0, r, p, alive = bench_state(geom, PPC, VTH)
    slots = max(8, int(PPC * 1.6) // 8 * 8)
    E, B, B0, sp = state_from_numpy(E, B, B0, r, p, alive, device=dev,
                                    dtype=torch.float64)
    ecsim_multi_step(E, B, B0, sp, geom, slots, n_steps=1, **KW)
    torch.cuda.synchronize()
    kernels.reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    E1, B1, sp1, iters = ecsim_multi_step(E, B, B0, sp, geom, slots,
                                          n_steps=3, **KW)
    end.record()
    end.synchronize()
    launches["fused"] = dict(kernels.LAUNCHES)
    ms = start.elapsed_time(end) / 3
    log(f"[17 f64 paths] fused: ecsim_multi_step {SIDE}^3 x {PPC} ppc "
        f"float64, K={slots}, 1 + 3 steps: step_ms={ms:.3f} "
        f"particle_steps_per_s={len(r) / ms * 1e3:.4e} KSP per step "
        f"{iters.tolist()}, launches {launches['fused']} | {name} | {card}")
    f64_launch_gate("fused", launches["fused"])
    check(bool(torch.isfinite(E1).all() and torch.isfinite(B1).all()
               and torch.isfinite(sp1.p).all()), "non-finite float64 state")
    want = ITERS_F64["fused ksp"]
    check(iters.tolist() == want,
          f"float64 fused KSP iterations {iters.tolist()}, not {want}")
    return launches, cli_k


def f64_card_vs_cpu(card):
    """Phase 18: the configs and sizes of phases 7, 9, 11 and 14 (ECSIM
    and ``basic`` at 16^3 x 20 ppc, eccapfim and ecsimcorr at 8^3 x 20
    ppc, 2 steps) in float64 (``XPIC_X64`` unset), on the card and on
    the CPU: the tables within ``F64_TABLE_TOL`` of each column's scale
    (the same tables and scales as those phases), every solver's
    iterations equal step by step, equal particle counts, the step-0
    dumps bitwise equal; the float64 kernels launch on the card (and no
    other), none on the CPU."""
    from xpic_tpu_torch.benchmarks.turns import eccapfim_config
    from xpic_tpu_torch.diagnostics.compare import TABLES, table_errors

    cases = (("cli", cli_config, 16), ("basic", basic_config, 16),
             ("eccapfim", eccapfim_config, 8),
             ("ecsimcorr", ecsimcorr_config, 8))
    with run_env(F64_ENV), tempfile.TemporaryDirectory(
            prefix="xpic_smoke_") as work:
        for path, doc, side in cases:
            runs = {}
            for device in ("cuda:0", "cpu"):
                runs[device] = run_cli(
                    os.path.join(work, path, device.split(":")[0]), side,
                    20, 2, device, doc=doc)
            (out_g, sim_g, _, lg), (out_c, sim_c, _, lc) = (runs["cuda:0"],
                                                            runs["cpu"])
            dt = BASIC_DT if path == "basic" else 1.5
            extra = {"cli": {}, "basic": dict(dt=dt)}.get(path, {})
            tables = (("energy.txt", "energy_conservation.txt",
                       "momentum_conservation.txt") if path == "cli"
                      else TABLES)
            if path != "cli":
                extra["charge_scale"] = np.sqrt(side ** 3) / dt
            worst = {}
            for table in tables:
                errs = table_errors(table, out_c, out_g, n_cells=side ** 3,
                                    **extra)
                worst[table] = max(errs.items(), key=lambda kv: kv[1])
            hists = {k: (getattr(sim_g, k), getattr(sim_c, k))
                     for k in ("ksp_history", "correct_ksp_history",
                               "outer_history", "cn_history",
                               "count_history")
                     if getattr(sim_g, k, None)}
            dumps, differ = 0, []
            for root, dirs, files in os.walk(out_c):
                dirs[:] = [d for d in dirs
                           if d not in ("temporal", "simulation_backup")]
                if not files or os.path.basename(root) == "out":
                    continue
                first = sorted(files)[0]
                rel = os.path.relpath(os.path.join(root, first), out_c)
                dumps += 1
                with open(os.path.join(out_c, rel), "rb") as a, \
                        open(os.path.join(out_g, rel), "rb") as b:
                    if a.read() != b.read():
                        differ.append(rel)
            log(f"[18 card vs cpu, f64] {path} {side}^3 x 20 ppc float64, 2 "
                f"steps: worst column per table {worst} (tol "
                f"{F64_TABLE_TOL}); card, cpu {hists}; step-0 dumps "
                f"{dumps}, differing {differ}; launches card {lg} cpu {lc} "
                f"| {card}")
            f64_launch_gate(path, lg)
            check(not any(lc.values()), f"CPU launches {lc}")
            check(all(e <= F64_TABLE_TOL for _, e in worst.values()),
                  f"float64 {path} card tables differ from the CPU's")
            check(all(g == c for g, c in hists.values()),
                  f"float64 {path} iterations or counts differ between "
                  f"card and CPU")
            check(not differ, f"float64 {path} step-0 dumps differ")


def calibration_path(dev, card):
    """Phase 12: the calibration path through its two entry points (the
    launch counts set to 0 just before), then each probe of the ``prims``
    kernel against its twin at [32768, 8, 128].  Returns the path's
    launches and the ``prims`` row: the copy probe's times, ``copy_``'s
    as ``library_ms``, the largest error of the six and every probe's
    numbers under ``probes``."""
    import io

    from xpic_tpu_torch import kernels
    from xpic_tpu_torch.benchmarks import call_ms
    from xpic_tpu_torch.benchmarks import prims as P
    from xpic_tpu_torch.benchmarks import profile_prims, profile_roofcal

    lines = {}
    kernels.reset_counts()
    for script in (profile_prims, profile_roofcal):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = script.main([])
        check(rc == 0, f"{script.__name__} returned {rc}")
        lines[script] = out.getvalue().strip().splitlines()[-1]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    for script, line in lines.items():
        log(f"[12 calibration] python -m {script.__name__} | {card}")
        print(line, flush=True)
    probe = json.loads(lines[profile_prims])
    check(launches["prims"] > 0
          and not any(n for k, n in launches.items() if k != "prims"),
          f"the calibration path's launches {launches}")

    x = profile_prims.make_input(profile_prims.CELLS, dev)
    n_bytes = 2 * 4 * x.numel()
    probes = {}
    for name in P.PRIMS:
        got, ref = P.prim(x, name), P.prim_plain(x, name)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        same = bool(torch.equal(got, ref))
        del got, ref
        row = probes[name] = dict(
            max_abs_err=err, ms=probe[name + "_ms"],
            call_ms=call_ms(lambda: P.prim(x, name), dev),
            plain_ms=time_ms(lambda: P.prim_plain(x, name)),
            **bound(n_bytes, P.FLOPS_PER_ELEMENT[name] * x.numel()))
        tol = "bitwise" if name in P.BITWISE else f"tol {PRIM_TOL}"
        log(f"[12 calibration] prims {name} {tuple(x.shape)}: max|d|/max = "
            f"{rel:.3e} (bitwise {same}; {tol}) | {row['ms']:.4f} ms "
            f"(per call {row['call_ms']:.4f}) vs twin {row['plain_ms']:.4f}"
            f" ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}) | "
            f"{card}")
        check(same if name in P.BITWISE else rel <= PRIM_TOL,
              f"prims {name} differs from its twin by {rel:.3e}")
    # copy_ against the copy probe, in turns, for the spread of both
    out = torch.empty_like(x)
    turns = {"copy_": [], "probe": []}
    for _ in range(3):
        turns["probe"].append(time_ms(lambda: P.prim(x, "copy")))
        turns["copy_"].append(time_ms(lambda: out.copy_(x)))
    log(f"[12 calibration] in turns, ms: copy_ {turns['copy_']} copy probe "
        f"{turns['probe']} | {card}")
    copy = probes["copy"]
    return launches, dict(
        max_abs_err=max(p["max_abs_err"] for p in probes.values()),
        ms=copy["ms"], call_ms=copy["call_ms"], plain_ms=copy["plain_ms"],
        **bound(n_bytes, max(P.FLOPS_PER_ELEMENT.values()) * x.numel()),
        library_ms=statistics.median(turns["copy_"]), probes=probes)


def cheb_kernel(geom, dev, card, dtype=torch.float32):
    """Phase 3 for the Chebyshev apply: against its twin at degree 12 on
    the main paths' 32^3 field (the row), on a non-cubic field with
    ghosted, periodic and reflective axes, and on a 64^3 field, more
    elements than the card holds threads at once (the grid-stride loop);
    two applies of one input bitwise equal; one launch an apply.  With
    ``dtype`` float64, phase 16: the same operands cast to float64
    through ``cheb_step_f64``, within ``F64_TOL``."""
    from xpic_tpu_torch import kernels
    from xpic_tpu_torch.config import Geometry
    from xpic_tpu_torch.ops.stencil_kernel import (
        cheb_matM_inv,
        cheb_matM_inv_plain,
    )

    f64 = dtype == torch.float64
    tag, tol, flops = (("16 f64 kernels", F64_TOL, F64_FLOPS) if f64
                       else ("3 kernels", CHEB_TOL, F32_FLOPS))
    shift = torch.tensor(0.37, dtype=torch.float32, device=dev).to(dtype)
    kname = kernels.entry("cheb_step", shift)
    row = None
    for shape, bounds in (((SIDE,) * 3, geom.bounds),
                          ((40, 24, 12), ("ghosted", "periodic",
                                          "reflective")),
                          ((64,) * 3, geom.bounds)):
        nx, ny, nz = shape
        g = Geometry(dx=geom.dx, dy=geom.dy, dz=geom.dz, dt=geom.dt, nx=nx,
                     ny=ny, nz=nz, nt=1, bounds=bounds)
        rng = np.random.default_rng(2)
        rhs = torch.tensor(rng.standard_normal((3,) + g.shape),
                           dtype=torch.float32, device=dev).to(dtype)
        cheb = dict(geom=g, degree=12, dt=g.dt)
        before = kernels.LAUNCHES[kname]
        x_k = cheb_matM_inv(rhs, shift, **cheb)
        again = cheb_matM_inv(rhs, shift, **cheb)
        x_p = cheb_matM_inv_plain(rhs, shift, **cheb)
        torch.cuda.synchronize()
        applies = kernels.LAUNCHES[kname] - before
        err = float((x_k - x_p).abs().max())
        rel = err / float(x_p.abs().max())
        same = bool(torch.equal(x_k, again))
        log(f"[{tag}] {kname} degree 12 on {tuple(rhs.shape)} {bounds}: "
            f"max|d|/max|x| = {rel:.3e} (tol {tol}; nvcc contracts "
            f"multiply-adds into FMAs, which round once), two applies "
            f"bitwise {same}, launches {applies} for 2 applies")
        check(np.isfinite(rel) and rel <= tol,
              f"{kname} differs from its twin by {rel:.3e} on {shape}")
        check(same, f"two {kname} applies differ on {shape}")
        check(applies == 2, f"{kname} launched {applies} times for two "
              f"applies on {shape}")
        if row is None:
            # One apply reads rhs and writes x once and does CHEB_FLOPS
            # operations an element.
            row = dict(
                max_abs_err=err,
                **kernel_times(lambda: cheb_matM_inv(rhs, shift, **cheb)),
                plain_ms=time_ms(lambda: cheb_matM_inv_plain(rhs, shift,
                                                             **cheb)),
                **bound(2 * rhs.element_size() * rhs.numel(),
                        CHEB_FLOPS * rhs.numel(), flops))
            log(f"[{tag}] {kname} apply {row['ms']:.4f} ms (per call "
                f"{row['call_ms']:.4f}) vs twin {row['plain_ms']:.4f} ms, "
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
                f"share {row['bound_ms'] / row['ms']:.3f} | {card}")
    return row


def slot_kernels(geom, dev, card):
    """Phase 3 for the mass apply (K = 80, the fused path, 96, the
    config-driven path's K at 50 ppc, and 112, the K that the CLI and
    ecsimcorr runs grow to) and the slot gather (K = 80,
    :func:`gather_kernel`), on the drifted and migrated 32^3 x 50 ppc
    state with B at the slots ~0.2."""
    from xpic_tpu_torch.convert import state_from_numpy
    from xpic_tpu_torch.ops.binning import bin_state, drift_state, rebin
    from xpic_tpu_torch.ops.ecsim_blocks import gather_slots
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
    for slots in (80, 96, 112):
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
        same = torch.equal(Y_k, mass_apply_slots(xg, packed))
        Y_p = mass_apply_slots_plain(xg, packed)
        torch.cuda.synchronize()
        err = float((Y_k - Y_p).abs().max())
        rel = err / float(Y_p.abs().max())
        n_valid = int(st.valid.sum())
        G = geom.n_cells
        # Read: 7 operand channels (the 8th is zero and never read) and
        # xg; written: Y.  ~140 float32 operations per live slot.
        row = dict(max_abs_err=err,
                   **kernel_times(lambda: mass_apply_slots(xg, packed)),
                   plain_ms=time_ms(lambda: mass_apply_slots_plain(xg,
                                                                   packed)),
                   **bound(4 * G * (7 * slots + 2 * 36), 140 * n_valid))
        log(f"[3 kernels] mass_apply K={slots} |B_p| max "
            f"{float(B_p.norm(dim=-1).max()):.3f}: max|d|/max|Y| = "
            f"{rel:.3e} (tol {MASS_TOL}), two calls bitwise equal: {same} "
            f"| {row['ms']:.4f} ms vs twin {row['plain_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}) | {card}")
        check(np.isfinite(rel) and rel <= MASS_TOL,
              f"mass_apply differs from its twin by {rel:.3e} at K={slots}")
        check(same, f"two mass_apply calls differ at K={slots}")
        if slots == 80:
            report["mass_apply"] = row
    report["slot_gather"] = gather_kernel(geom, dev, card, (80,),
                                          torch.float32)[80]
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
    kernel launches of the run (counts set to 0 just before it).  The
    simulation records each species' live count after every step
    (``count_history``); an ecsimcorr simulation records each step's
    correct-solve iterations and consistency norm itself
    (``correct_ksp_history``, ``consistency_history``)."""
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
            sim.count_history.append([sp.count() for sp in sim.species])

        sim.count_history = []
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
    check(hist == ITERS["cli"], f"KSP iterations {hist}, not {ITERS['cli']}")
    check(closure.max() <= ENERGY_TOL, "the ECSIM energy identity fails")
    check(all(v == CLI_STEPS + 1 for v in dumps.values()),
          f"dumps {dumps}")


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
    check(list(sim.outer_history) == ITERS["eccapfim outer"],
          f"outer iterations {sim.outer_history}, not "
          f"{ITERS['eccapfim outer']}")


def ecsimcorr_config(out_dir, side, ppc, steps):
    """bench.py's ecsimcorr workload: ``side``^3 cells of 0.5, dt 1.5,
    periodic, one electron species at ``ppc`` and T = 0.1 keV, no field;
    the default diagnostics every step."""
    from xpic_tpu_torch.benchmarks.turns import eccapfim_config

    doc = eccapfim_config(out_dir, side, ppc, steps)
    doc["Simulation"] = "ecsimcorr"
    return doc


def check_ecsimcorr_run(mass, out, sim, launches, name, card, step_ms):
    """Phase 10's gates and line for one mass route: the first step is
    the warm-up."""
    from xpic_tpu_torch.diagnostics.compare import TABLES, read_table

    tables = {t: read_table(os.path.join(out, "temporal", t))
              for t in TABLES}
    charge = charge_share(*tables["charge_conservation.txt"], SIDE ** 3,
                          1.5)
    sp = sim.species[0]
    n = sp.count()
    ms = statistics.median(step_ms[1:])
    log(f"[10 ecsimcorr path, {mass}] python -m xpic_tpu_torch cfg.json: "
        f"{SIDE}^3 x {PPC} ppc f32, 1 + {CORR_STEPS} steps, K={sp.slots}, "
        f"{n} particles: ms/step median {ms:.3f} (per step "
        f"{[round(v, 3) for v in step_ms]}, the first a warm-up), "
        f"particle_steps_per_s={n / ms * 1e3:.4e}, predict KSP "
        f"{sim.ksp_history}, correct KSP {sim.correct_ksp_history}, consistency "
        f"norm {sim.consistency_history} (tol 0.1), charge continuity / (rho/dt) "
        f"{charge:.3e} (tol {CHARGE_TOL}), launches {launches} | {name} | "
        f"{card}")
    other = "mass_apply" if mass == "blocks" else "ecsim_fill"
    check(all(launches[k] > 0 for k in CORR_KERNELS[mass])
          and launches[other] == 0,
          f"the ecsimcorr {mass} route's launches {launches}")
    check(all(np.isfinite(rows).all() and rows.shape[0] == CORR_STEPS + 2
              for _, rows in tables.values()), "a table row is not finite")
    check(sim.ksp_history == ITERS["ecsimcorr predict"]
          and sim.correct_ksp_history == ITERS["ecsimcorr correct"],
          f"KSP iterations {sim.ksp_history} {sim.correct_ksp_history}, not "
          f"{ITERS['ecsimcorr predict']} {ITERS['ecsimcorr correct']}")
    check(all(0.0 <= v < 0.1 for v in sim.consistency_history),
          f"current-consistency norms {sim.consistency_history}")
    check(charge <= CHARGE_TOL, "ecsimcorr does not conserve charge")


def charge_share(header, rows, n_cells, dt):
    """The largest charge-continuity norm of a table against the same
    norm of rho / dt (|q n| = 1 a cell): n_cells / dt for the 1-norms,
    sqrt(n_cells) / dt for the 2-norms."""
    return max(float(np.abs(rows[:, c]).max())
               / ((n_cells if h.startswith("N1") else np.sqrt(n_cells)) / dt)
               for c, h in enumerate(header) if h != "Time")


def fill_kernel(geom, dev, card, ks=(96, 112), dtype=torch.float32):
    """Phase 3 for the ECSIM fill kernel: the drifted and migrated
    32^3 x 50 ppc state at each K of ``ks`` with B at the slots ~0.2
    (``benchmarks.turns.fill_operands``, the operands its ``ecsim_fill``
    case times); two calls bitwise equal.  With ``dtype`` float64, phase
    16: the same operands cast to float64 through ``ecsim_fill_f64``,
    within ``F64_TOL``, and the float32 kernel (3xTF32) and the float32
    twin each held against that float64 product of the float32 operands
    (the source of the float32 kernel's gap from its twin).  Returns the
    rows by K."""
    from xpic_tpu_torch import kernels
    from xpic_tpu_torch.benchmarks.turns import fill_operands
    from xpic_tpu_torch.ops.ecsim_kernel import (
        FILL_FLOPS_PER_SLOT,
        ecsim_fill,
        ecsim_fill_plain,
    )

    f64 = dtype == torch.float64
    tag, tol, flops = (("16 f64 kernels", F64_TOL, F64_MMA_FLOPS) if f64
                       else ("3 kernels", FILL_TOL, F32_FLOPS))
    rows = {}
    for slots in ks:
        args32, kw = fill_operands(dev, geom.nx, slots, PPC, VTH)
        args = tuple(a.to(dtype) for a in args32[:3]) + args32[3:]
        kname = kernels.entry("ecsim_fill", args[0])
        L_k, I_k = ecsim_fill(*args, **kw)
        L_2, I_2 = ecsim_fill(*args, **kw)
        L_p, I_p = ecsim_fill_plain(*args, **kw)
        torch.cuda.synchronize()
        same = torch.equal(L_k, L_2) and torch.equal(I_k, I_2)
        errs = [float((k - q).abs().max()) for k, q in ((L_k, L_p),
                                                        (I_k, I_p))]
        rel = max(errs[0] / float(L_p.abs().max()),
                  errs[1] / float(I_p.abs().max()))
        gap = ""
        if f64:
            # The float32 kernel and the float32 twin on the float32
            # operands, each against the float64 product of the same
            # operands (L_k, I_k).
            dist = {}
            for who, fill in (("f32 kernel", ecsim_fill),
                              ("f32 twin", ecsim_fill_plain)):
                L_32, I_32 = fill(*args32, **kw)
                dist[who] = max(
                    float((L_32.double() - L_k).abs().max())
                    / float(L_k.abs().max()),
                    float((I_32.double() - I_k).abs().max())
                    / float(I_k.abs().max()))
                del L_32, I_32
            gap = (f"; against this float64 product of the float32 "
                   f"operands, max|d|/max |L|, |Islot|: the float32 kernel "
                   f"(3xTF32) {dist['f32 kernel']:.3e}, the float32 twin "
                   f"{dist['f32 twin']:.3e}")
        del L_k, I_k, L_2, I_2, L_p, I_p
        G = geom.n_cells
        n_valid = int(args[3].sum())
        esize = args[0].element_size()
        # What these inputs need: t, v, B_p of the live slots and every
        # slot's valid byte read once, L and Islot written once; the
        # operations of the live slots (a dead slot adds nothing).
        row = dict(max_abs_err=max(errs),
                   **kernel_times(lambda: ecsim_fill(*args, **kw)),
                   plain_ms=time_ms(lambda: ecsim_fill_plain(*args, **kw)),
                   **bound(esize * 9 * n_valid + G * slots
                           + esize * G * (1296 + 36),
                           FILL_FLOPS_PER_SLOT * n_valid, flops))
        if f64:
            row["f32_gap_from_f64"] = dist
        rows[slots] = row
        log(f"[{tag}] {kname} K={slots} ({n_valid} live "
            f"slots): max|d|/max |L|, |Islot| = {rel:.3e} (tol {tol}), "
            f"two calls bitwise equal: {same} | {row['ms']:.4f} ms "
            f"({row['call_ms']:.4f} a call) vs twin {row['plain_ms']:.4f} "
            f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
            f"share {row['bound_ms'] / row['ms']:.3f}{gap} | {card}")
        check(np.isfinite(rel) and rel <= tol,
              f"{kname} differs from its twin by {rel:.3e} at K={slots}")
        check(same, f"two {kname} calls differ at K={slots}")
    return rows


def segment_kernel(geom, dev, card, dtype=torch.float32):
    """Phase 3 for the segment-field kernel: the drifted 32^3 x 50 ppc
    state at K = 96 (the eccapfim run's K), random E and B, moves of up
    to +-0.9 cell a axis (1 to 4 segments) and rows with tn == t0; the
    fast path's K' = 32 crosser columns read in place, and K' = 96; then
    K' = 32 with moves of 1.1 to 2.5 cells a axis, some segment of which
    is at least 2.05 cells long on an axis (the window offsets of S2 at
    its two ends then lie two or more apart: the whole-window branch).
    With ``dtype`` float64, phase 16: the same operands cast to float64
    through ``segment_fields_f64``."""
    from xpic_tpu_torch import kernels
    from xpic_tpu_torch.convert import state_from_numpy
    from xpic_tpu_torch.ops.binning import bin_state, drift_state
    from xpic_tpu_torch.ops.gather_scatter import cell_t
    from xpic_tpu_torch.ops.implicit_esirkepov import (
        gather_window_blocks,
        split_segments,
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
    Eblk = gather_window_blocks(Et, geom).to(dtype)
    Bblk = gather_window_blocks(Bt, geom).to(dtype)
    tag = "16 f64 kernels" if dtype == torch.float64 else "3 kernels"
    kname = kernels.entry("segment_fields", Eblk)
    t0, tn = t0.to(dtype), tn.to(dtype)
    report = {}
    for kp in (32, 96):
        row = segment_row(Eblk, Bblk, t0[:, :kp], tn[:, :kp],
                          f"[{tag}] {kname} K'={kp} of K=96", card)
        if kp == 32:
            report["segment_fields"] = row
    far = rng.uniform(1.1, 2.5, tuple(t0.shape)) * rng.choice([-1.0, 1.0],
                                                               t0.shape)
    a = t0[:, :32]
    b = (t0.float() + torch.tensor(far, dtype=torch.float32, device=dev)
         ).to(dtype)[:, :32]
    longest = float(((b - a)[..., None, :]
                     * split_segments(a, b).diff(dim=-1)[..., None]).abs()
                    .max())
    check(longest >= 2.05, f"no segment of the long moves is 2.05 cells "
          f"long on an axis (longest {longest:.3f})")
    segment_row(Eblk, Bblk, a, b, f"[{tag}] {kname} K'=32 of K=96, moves "
                f"of 1.1 to 2.5 cells (longest segment {longest:.3f} cells "
                f"on an axis)", card)
    return report


def segment_row(Eblk, Bblk, a, b, label, card):
    """The segment-field kernel on (Eblk, Bblk, a, b): against its twin
    within 1e-5 of max |E_p| and of max |B_p| (float64: ``F64_TOL``), two
    calls bitwise equal, timed beside its twin and its bound; logs
    ``label`` with the numbers and returns the kernels line's row, with
    the live segments a slot."""
    from xpic_tpu_torch.ops.segment_kernel import (
        FLOPS_PER_SEGMENT,
        live_segments,
        segment_fields,
        segment_fields_plain,
    )

    E_k, B_k = segment_fields(Eblk, Bblk, a, b)
    E_2, B_2 = segment_fields(Eblk, Bblk, a, b)
    E_p, B_p = segment_fields_plain(Eblk, Bblk, a, b)
    torch.cuda.synchronize()
    same = torch.equal(E_k, E_2) and torch.equal(B_k, B_2)
    errs = [float((k - q).abs().max()) for k, q in ((E_k, E_p), (B_k, B_p))]
    # B is exactly 0 at the start of an eccapfim run: its error must be 0
    rel = max(errs[0] / max(float(E_p.abs().max()), 1e-30),
              errs[1] / max(float(B_p.abs().max()), 1e-30))
    G, kp, _ = a.shape
    segs = live_segments(a, b)
    f64 = Eblk.dtype == torch.float64
    tol = F64_TOL if f64 else SEGMENT_TOL
    # Read the two windows and t0, tn once; write E_p and B_p.
    row = dict(max_abs_err=max(errs),
               **kernel_times(lambda: segment_fields(Eblk, Bblk, a, b)),
               plain_ms=time_ms(lambda: segment_fields_plain(Eblk, Bblk, a,
                                                             b)),
               **bound(Eblk.element_size() * (2 * G * 648 + 4 * G * kp * 3),
                       FLOPS_PER_SEGMENT * segs,
                       F64_FLOPS if f64 else F32_FLOPS),
               segments_per_slot=segs / (G * kp))
    log(f"{label} ({segs} live segments, {row['segments_per_slot']:.3f} a "
        f"slot): max|d|/max = {rel:.3e} (tol {tol}), two calls "
        f"bitwise equal: {same} | {row['ms']:.4f} ms ({row['call_ms']:.4f} "
        f"a call) vs twin {row['plain_ms']:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}), share "
        f"{row['bound_ms'] / row['ms']:.3f} | {card}")
    check(np.isfinite(rel) and rel <= tol,
          f"segment_fields differs from its twin by {rel:.3e}: {label}")
    check(same, f"two segment_fields calls differ: {label}")
    return row


def profile_paths(name, card, dev, fused_run):
    """``--profile``: two fused steps (phase 4's state) under
    ``torch.profiler``, the phase-6 config for 8 steps, the phase-8
    config for 6 steps and the phase-10 config for 6 steps on each mass
    route through ``runtime.step_profile`` (per-phase and per-diagnostic
    times, and a 2-step ``torch.profiler`` window)."""
    from xpic_tpu_torch.benchmarks.turns import eccapfim_config
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


# -- phase 19: the ECSIM path over two ranks sharing the card ---------------
# Two ranks, one z slab each (16 x 32 x 32 cells at phase 6's size).
# They share the one card, so this phase gives no scaling figure.
MESH = 2
MESH_STEPS = 10  # fused steps on phase 4's state, after one warm-up step
MESH_F64_SIDE, MESH_F64_PPC, MESH_F64_STEPS = 16, 20, 2
# The ranks' time limits: the join and each collective, and the spawn.
MESH_RANK_TIMEOUT_S, MESH_DEADLINE_S = 300, 900
# Every rank's kernels on each mesh path; the float32 routes' and the
# float64 route's (blocks, the global sort: no K2, K3 or K4).
MESH_KERNELS = {
    "free": ("cheb_sweep", "rebin_extract", "rebin_place", "mass_apply",
             "slot_gather"),
    "blocks": ("cheb_sweep", "rebin_extract", "rebin_place", "ecsim_fill",
               "slot_gather"),
    "f64": ("cheb_sweep_f64", "slot_gather_f64", "ecsim_fill_f64"),
}
# Collectives a step a rank predicted for phase 19's fused step and
# phase 20's float32 runs at 32^3 x 50 ppc with one K1 ghost exchange an
# apply (t = 16 planes); each is checked within MESH_CALLS_SLACK.
MESH_CALLS_PREDICTED = {"fused": 55, "ecsimcorr_free": 96,
                        "ecsimcorr_blocks": 96, "eccapfim": 55.5,
                        "basic": 11}
MESH_CALLS_SLACK = 0.1


def cheb_segments(planes):
    """K1's slab form: exchanges (and launches) an apply on a slab of
    ``planes`` planes at degree 12."""
    return -(-11 // min(11, planes))


def nccl_probe():
    """Two processes ask NCCL for a group of two ranks on cuda:0 and
    all-reduce one number.  Returns what NCCL said (the first error
    line), or that it passed."""
    import subprocess

    from xpic_tpu_torch.runtime.distributed import free_port

    code = (
        "import sys, torch, torch.distributed as dist\n"
        "r = int(sys.argv[1])\n"
        "torch.cuda.set_device(0)\n"
        "dist.init_process_group('nccl', init_method=sys.argv[2], rank=r,"
        " world_size=2)\n"
        "x = torch.ones(1, device='cuda:0')\n"
        "dist.all_reduce(x)\n"
        "torch.cuda.synchronize()\n"
        "print('all_reduce', float(x))\n"
        "dist.destroy_process_group()\n")
    init = f"tcp://127.0.0.1:{free_port()}"
    env = dict(os.environ, NCCL_DEBUG="WARN")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), init],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=90)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate()[0] + "\n(timed out after 90 s)")
    lines = [ln.strip() for out in outs for ln in out.splitlines()
             if "rror" in ln or "uplicate" in ln or "all_reduce" in ln
             or "timed out" in ln]
    rcs = [p.returncode for p in procs]
    return rcs, lines[:4]


def _slab_segment_fn(rhs_slab, shift, sgeom):
    """One launch of the slab form's first segment on this rank's slab,
    padded with its ghost planes (zeros here: the kernel alone, for its
    time).  Returns the launch and its sweeps."""
    from xpic_tpu_torch import kernels
    from xpic_tpu_torch.ops.stencil_kernel import _beta_lam, _depths, \
        slab_schedule

    n = sgeom.nz
    g, segs = slab_schedule(12, n)
    lo, hi = _depths(sgeom.mesh, g)
    k0, count = segs[0]
    pad = (3, lo + n + hi, sgeom.ny, sgeom.nx)
    rhs_p = torch.zeros(pad, dtype=rhs_slab.dtype, device=rhs_slab.device)
    rhs_p[:, lo:lo + n] = rhs_slab
    x, r, d0, d1 = torch.zeros((4,) + pad, dtype=rhs_slab.dtype,
                               device=rhs_slab.device)
    beta, beta_lam = _beta_lam(sgeom, sgeom.dt)
    name = kernels.entry("cheb_sweep", rhs_slab)

    def segment():
        kernels.call(name, rhs_p.data_ptr(), shift.data_ptr(), x.data_ptr(),
                     r.data_ptr(), d0.data_ptr(), d1.data_ptr(), sgeom.nx,
                     sgeom.ny, lo + n + hi, 1, 1, 1.0 / sgeom.dx,
                     1.0 / sgeom.dy, 1.0 / sgeom.dz, beta, beta_lam, k0,
                     count, 12, device=rhs_slab.device)
    return segment, count


def _fixed_ms(fn, reps):
    """``reps`` calls between two CUDA events, over ``reps``, after one
    warm-up: the same number of calls on every rank (the calls exchange
    planes)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _mesh_cheb(geom, mesh, dtype):
    """K1's slab form on this rank's slab of a seeded field on ``geom``
    against its slab twin and the one-launch K1 on the whole field:
    launches and exchanges an apply, a segment launch's time and an
    apply's with its exchanges.  The bound counts an apply's kernel work
    as K1's row does (CHEB_FLOPS operations an element of the own planes,
    rhs read and x written once), a launch's as its share; the exchange
    is stated apart (its ms and bytes an apply)."""
    import torch.distributed as dist

    from xpic_tpu_torch import kernels
    from xpic_tpu_torch.benchmarks import call_ms, device_ms
    from xpic_tpu_torch.ops.stencil_kernel import (
        cheb_matM_inv,
        cheb_matM_inv_slab,
        cheb_matM_inv_slab_plain,
        slab_schedule,
    )

    dev = torch.device("cuda", 0)
    sgeom = geom.slab(mesh)
    rng = np.random.default_rng(2)
    rhs = torch.tensor(rng.standard_normal((3,) + geom.shape),
                       dtype=torch.float32, device=dev).to(dtype)
    shift = torch.tensor(0.37, dtype=torch.float32, device=dev).to(dtype)
    n = sgeom.nz
    g, segs = slab_schedule(12, n)
    rhs_s = rhs[:, mesh.z0:mesh.z0 + n].contiguous()
    cheb = dict(degree=12, dt=geom.dt)
    name = kernels.entry("cheb_sweep", rhs)
    before = kernels.LAUNCHES[name]
    x_k = cheb_matM_inv_slab(rhs_s, shift, geom=sgeom, **cheb)
    launches = kernels.LAUNCHES[name] - before
    x_p = cheb_matM_inv_slab_plain(rhs_s, shift, geom=sgeom, **cheb)
    x_one = cheb_matM_inv(rhs, shift, geom=geom, **cheb)[:, mesh.z0:
                                                           mesh.z0 + n]
    torch.cuda.synchronize()
    err = float((x_k - x_p).abs().max())
    segment, sweeps = _slab_segment_fn(rhs_s, shift, sgeom)
    for rank in range(mesh.world):  # the launch timed while the other waits
        dist.barrier()
        if rank == mesh.rank:
            seg_ms = device_ms(segment, dev)
            seg_call = call_ms(segment, dev)
    dist.barrier()
    own = rhs_s.numel()
    apply_bound = bound(2 * own * rhs.element_size(), CHEB_FLOPS * own,
                        F64_FLOPS if dtype == torch.float64 else F32_FLOPS)
    reps = 10
    mesh.reset_counts()
    apply_ms = _fixed_ms(lambda: cheb_matM_inv_slab(rhs_s, shift,
                                                    geom=sgeom, **cheb), reps)
    applies = reps + 1  # _fixed_ms's warm-up call too
    exch = mesh.calls["cheb_ghosts"] / applies
    exch_ms = mesh.seconds * 1e3 / applies
    exch_bytes = mesh.bytes_sent / applies
    apply_call = call_ms(lambda: cheb_matM_inv_slab(rhs_s, shift,
                                                    geom=sgeom, **cheb),
                         torch.device("cuda", 0), reps=10)
    plain_apply = _fixed_ms(lambda: cheb_matM_inv_slab_plain(
        rhs_s, shift, geom=sgeom, **cheb), 5)
    return dict(
        planes=n, ghost_planes=g, segments=len(segs),
        max_abs_err=err, rel_err=err / float(x_p.abs().max()),
        bitwise_one_launch=bool(torch.equal(x_k, x_one)),
        launches_an_apply=launches, exchanges_an_apply=exch,
        sweeps_a_launch=sweeps,
        ms=seg_ms, call_ms=seg_call, apply_ms=apply_ms,
        apply_call_ms=apply_call,
        exchange_ms_an_apply=exch_ms, exchange_bytes_an_apply=exch_bytes,
        plain_ms=plain_apply / len(segs), plain_apply_ms=plain_apply,
        bound_ms=apply_bound["bound_ms"] / len(segs),
        bound_by=apply_bound["bound_by"],
        apply_bound_ms=apply_bound["bound_ms"], library_ms=None)


def _mesh_k3(geom, mesh):
    """K3's z pass with ghost planes on this rank's slab of phase 3's
    drifted 32^3 x 50 ppc state (K = 80), bitwise against its twin on
    the same padded buffers; the whole slab exchange bitwise against
    its twins."""
    from xpic_tpu_torch.benchmarks import call_ms, device_ms
    from xpic_tpu_torch.convert import state_from_numpy
    from xpic_tpu_torch.ops import neighbor_rebin as NR
    from xpic_tpu_torch.ops.binning import BinnedState, bin_state, \
        drift_state

    dev = torch.device("cuda", 0)
    sgeom = geom.slab(mesh)
    *_, r, p, alive = bench_state(geom, PPC, VTH, seed=1)
    _, _, _, sp = state_from_numpy(np.zeros(1), np.zeros(1), np.zeros(1),
                                   r, p, alive, device=dev,
                                   dtype=torch.float32)
    st = drift_state(bin_state(sp, geom, 80), geom)
    G = sgeom.n_cells
    rows = slice(mesh.rank * G, (mesh.rank + 1) * G)
    st = BinnedState(r=st.r[rows], p=st.p[rows], valid=st.valid[rows])
    _, _, buf, _ = NR.partition_movers(st, sgeom)
    proxy = NR.slab_z_proxy(buf, sgeom)
    out, up, dn = NR.rebin_extract(proxy, sgeom, 2)
    up_p, dn_p = NR.slab_z_ghosts(up, dn, sgeom)
    k = NR.rebin_place(out, up_p, dn_p, sgeom, 2, True)
    pl = NR.place_plain(out, up_p, dn_p, sgeom, 2, True)
    s_k, l_k = NR.rebin_neighbor(st, sgeom)
    s_p, l_p = NR.rebin_neighbor(st, sgeom, plain=True)
    torch.cuda.synchronize()
    whole = (torch.equal(s_k.r, s_p.r) and torch.equal(s_k.p, s_p.p)
             and torch.equal(s_k.valid, s_p.valid)
             and torch.equal(l_k, l_p))
    pass_bytes = 4 * (2 * out.numel() + up.numel() + dn.numel())
    return dict(
        bitwise=bool(torch.equal(k, pl)), exchange_bitwise=bool(whole),
        arrivals=int(up_p[:sgeom.nx * sgeom.ny, 6].sum()
                     + dn_p[-sgeom.nx * sgeom.ny:, 6].sum()),
        ms=device_ms(lambda: NR.rebin_place(out, up_p, dn_p, sgeom, 2, True),
                     dev),
        call_ms=call_ms(lambda: NR.rebin_place(out, up_p, dn_p, sgeom, 2,
                                               True), dev),
        plain_ms=device_ms(lambda: NR.place_plain(out, up_p, dn_p, sgeom, 2,
                                                  True), dev),
        bound_ms=pass_bytes / HBM_BPS * 1e3)


def _mesh_fused(geom, mesh):
    """1 + MESH_STEPS fused float32 steps of phase 4's state on this
    rank's slab: iterations, step ms, launches, the mesh's traffic."""
    from xpic_tpu_torch import kernels
    from xpic_tpu_torch.convert import split_state, state_from_numpy
    from xpic_tpu_torch.parallel.step import ecsim_multi_step

    dev = torch.device("cuda", 0)
    sgeom = geom.slab(mesh)
    E, B, B0, r, p, alive = bench_state(geom, PPC, VTH)
    part = split_state(mesh.world, fields=[E, B, B0], flat=(r, p, alive),
                       geom=geom, dtype=torch.float32)[mesh.rank]
    E, B, B0, sp = state_from_numpy(*part["fields"], *part["flat"],
                                    device=dev, dtype=torch.float32)
    slots = max(8, int(PPC * 1.6) // 8 * 8)
    ecsim_multi_step(E, B, B0, sp, sgeom, slots, n_steps=1, **KW)
    torch.cuda.synchronize()
    kernels.reset_counts()
    mesh.reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    E1, B1, sp1, iters = ecsim_multi_step(E, B, B0, sp, sgeom, slots,
                                          n_steps=MESH_STEPS, **KW)
    end.record()
    end.synchronize()
    return dict(
        iters=iters.tolist(), step_ms=start.elapsed_time(end) / MESH_STEPS,
        launches={k: v for k, v in kernels.LAUNCHES.items() if v},
        bytes_step=mesh.bytes_sent / MESH_STEPS,
        exchange_ms_step=mesh.seconds * 1e3 / MESH_STEPS,
        calls_step={k: v / MESH_STEPS for k, v in mesh.calls.items()},
        finite=bool(torch.isfinite(E1).all() and torch.isfinite(B1).all()),
        particles=int(sp1.alive.sum()))


def _mesh_rank(rank, init, work):
    """One rank of phase 19's own ranks: the kernel checks and the fused
    run; what it finds goes to ``work/rank<r>.json``."""
    from xpic_tpu_torch import kernels
    from xpic_tpu_torch.config import Geometry
    from xpic_tpu_torch.parallel.mesh import make_mesh
    from xpic_tpu_torch.runtime import distributed

    info = distributed.join(init, rank, MESH, timeout=MESH_RANK_TIMEOUT_S)
    try:
        kernels.load()
        geom = Geometry(dx=0.5, dy=0.5, dz=0.5, dt=1.5, nx=SIDE, ny=SIDE,
                        nz=SIDE, nt=1)
        mesh = make_mesh(MESH, SIDE)
        res = {"rank": rank, "join": info.describe(),
               "backend": info.backend, "shared_card": info.shared_card,
               "cheb_sweep": _mesh_cheb(geom, mesh, torch.float32),
               "cheb_sweep_f64": _mesh_cheb(geom, mesh, torch.float64),
               "cheb_sweep_f64_t8": _mesh_cheb(
                   Geometry(dx=0.5, dy=0.5, dz=0.5, dt=1.5,
                            nx=MESH_F64_SIDE, ny=MESH_F64_SIDE,
                            nz=MESH_F64_SIDE, nt=1),
                   make_mesh(MESH, MESH_F64_SIDE), torch.float64),
               "k3": _mesh_k3(geom, mesh), "fused": _mesh_fused(geom, mesh)}
        with open(os.path.join(work, f"rank{rank}.json"), "w") as fh:
            json.dump(res, fh)
    finally:
        distributed.leave()


def run_mesh_cli(work, side, ppc, steps, doc=None):
    """``runtime.cli.main`` on the config with ``"Mesh": 2`` from this
    one process: it starts the two ranks, each on cuda:0, and each writes
    its ``--report``.  Returns the output directory and the reports."""
    from xpic_tpu_torch.commands import particles_load
    from xpic_tpu_torch.runtime import cli

    os.makedirs(work, exist_ok=True)
    out = os.path.join(work, "out")
    cfg = os.path.join(work, "cfg.json")
    with open(cfg, "w") as fh:
        json.dump(dict((doc or cli_config)(out, side, ppc, steps),
                       Mesh=MESH), fh)
    particles_load.seed(5489)
    report = os.path.join(work, "report.json")
    rc = cli.main([cfg, "--quiet", "--report", report])
    check(rc == 0, f"cli.main returned {rc}")
    reps = []
    for r in range(MESH):
        with open(f"{report}.rank{r}") as fh:
            reps.append(json.load(fh))
    return out, reps


def _mesh_tables(one, two, side, tol, label):
    from xpic_tpu_torch.diagnostics.compare import TABLES, table_errors

    worst = {}
    for table in TABLES:
        errs = table_errors(table, one, two, n_cells=side ** 3)
        worst[table] = max(errs.items(), key=lambda kv: kv[1])
    log(f"[19 mesh] {label}: 2 ranks against 1, worst column per table "
        f"{worst} (tol {tol})")
    check(all(e <= tol for _, e in worst.values()),
          f"{label}: the 2-rank tables differ from the one-rank run's")


def _mesh_launch_gate(route, reps, label):
    for rep in reps:
        got = rep["launches"]
        check(all(got.get(k, 0) > 0 for k in MESH_KERNELS[route]),
              f"{label}: rank {rep['rank']} launched {got}, not every one "
              f"of {MESH_KERNELS[route]}")


def mesh_path(name, card, cli_one_out, cli_one_ksp):
    """Phase 19: the ECSIM path over two ranks that share the card.
    Returns the kernels' launches on the mesh paths (both ranks, every
    run) and the rows of K1's slab form."""
    from xpic_tpu_torch.diagnostics.compare import read_table

    rcs, said = nccl_probe()
    log(f"[19 mesh] NCCL, two ranks on cuda:0: exit codes {rcs}, "
        f"{said or 'no error printed'}")
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    with tempfile.TemporaryDirectory(prefix="xpic_smoke_") as work:
        t0 = time.perf_counter()
        _spawn_ranks(_mesh_rank, (work,), MESH_DEADLINE_S)
        ranks = []
        for r in range(MESH):
            with open(os.path.join(work, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
        log(f"[19 mesh] two ranks' kernel checks and fused run in "
            f"{time.perf_counter() - t0:.1f} s: "
            + "; ".join(r["join"] for r in ranks))
    for r in ranks:
        for kname, tol in (("cheb_sweep", CHEB_TOL),
                           ("cheb_sweep_f64", F64_TOL),
                           ("cheb_sweep_f64_t8", F64_TOL)):
            row = r[kname]
            want = cheb_segments(row["planes"])
            log(f"[19 mesh] rank {r['rank']} {kname}: {row['planes']}-plane "
                f"slab, {row['ghost_planes']} ghost planes a side, "
                f"max|d|/max|x| {row['rel_err']:.3e} against the slab twin "
                f"(tol {tol}), bitwise the one-launch K1: "
                f"{row['bitwise_one_launch']}, {row['launches_an_apply']} "
                f"launches and {row['exchanges_an_apply']:.2f} exchanges an "
                f"apply (predicted {want}); a launch of "
                f"{row['sweeps_a_launch']} sweeps {row['ms']:.4f} ms (call "
                f"{row['call_ms']:.4f}), bound {row['bound_ms']:.5f} "
                f"({row['bound_by']}); an apply {row['apply_ms']:.4f} ms "
                f"(call {row['apply_call_ms']:.4f}; its exchanges "
                f"{row['exchange_ms_an_apply']:.4f} ms, "
                f"{row['exchange_bytes_an_apply']:.0f} bytes sent), bound "
                f"{row['apply_bound_ms']:.5f} without the exchange, twin "
                f"{row['plain_apply_ms']:.4f} | {card}")
            check(row["rel_err"] <= tol, f"{kname} differs from its twin")
            check(row["bitwise_one_launch"],
                  f"{kname} differs from the one-launch K1")
            check(row["launches_an_apply"] == want
                  and row["exchanges_an_apply"] == want,
                  f"{kname}: {row['launches_an_apply']} launches and "
                  f"{row['exchanges_an_apply']} exchanges an apply, not "
                  f"{want}")
        k3 = r["k3"]
        log(f"[19 mesh] rank {r['rank']} rebin_place z pass with ghost "
            f"planes: bitwise {k3['bitwise']} ({k3['arrivals']} movers "
            f"across the faces), whole slab exchange bitwise its twins "
            f"{k3['exchange_bitwise']}; {k3['ms']:.4f} ms (call "
            f"{k3['call_ms']:.4f}) vs twin {k3['plain_ms']:.4f}, bound "
            f"{k3['bound_ms']:.4f} | {card}")
        check(k3["bitwise"] and k3["exchange_bitwise"] and k3["arrivals"],
              "K3 with ghost planes differs from its twin")
        f = r["fused"]
        log(f"[19 mesh] rank {r['rank']} fused {MESH_STEPS} steps of phase "
            f"4's state on a 16 x 32 x 32 slab: KSP {f['iters']} (one rank "
            f"{ITERS['fused']}), step_ms {f['step_ms']:.3f}, bytes a step "
            f"{f['bytes_step']:.0f}, exchange ms a step "
            f"{f['exchange_ms_step']:.3f}, collectives a step "
            f"{f['calls_step']}, launches {f['launches']} | {card}")
        calls = sum(f["calls_step"].values())
        ghosts = f["calls_step"].get("cheb_ghosts", 0)
        want = MESH_CALLS_PREDICTED["fused"]
        log(f"[19 mesh] rank {r['rank']} fused: {calls:.1f} collectives a "
            f"step (predicted ~{want}), {ghosts:.1f} of them K1's ghost "
            f"exchanges for {f['launches'].get('cheb_sweep', 0) / MESH_STEPS}"
            f" K1 launches a step")
        check(abs(calls - want) <= MESH_CALLS_SLACK * want,
              f"fused: {calls} collectives a step, predicted ~{want}")
        check(round(ghosts * MESH_STEPS)
              == f["launches"].get("cheb_sweep", 0),
              "fused: K1's ghost exchanges differ from its launches")
        check(f["finite"], "the 2-rank fused run diverged")
        check(all(abs(a - b) <= 1 for a, b in zip(f["iters"],
                                                   ITERS["fused"])),
              f"fused 2-rank KSP {f['iters']} vs {ITERS['fused']}")
        _mesh_launch_gate("free", [dict(f, rank=r["rank"])], "fused")
        add(f["launches"])
    check(ranks[0]["fused"]["iters"] == ranks[1]["fused"]["iters"],
          "the two ranks took other iteration counts")
    log(f"[19 mesh] ranks share a card: {ranks[0]['shared_card']}, backend "
        f"{ranks[0]['backend']} (NCCL refuses two ranks on one device): no "
        f"scaling figure")

    with tempfile.TemporaryDirectory(prefix="xpic_smoke_") as work:
        # float32, free route: phase 6's config over two ranks
        out, reps = run_mesh_cli(os.path.join(work, "free"), SIDE, PPC,
                                 CLI_STEPS)
        _mesh_tables(cli_one_out, out, SIDE, TABLE_TOL,
                     f"cli {SIDE}^3 x {PPC} ppc f32 free")
        h_en, en = read_table(os.path.join(out, "temporal", "energy.txt"))
        h_ec, ec = read_table(os.path.join(out, "temporal",
                                           "energy_conservation.txt"))
        n_en = (len(h_en) - 1) // 2
        closure = (np.abs(ec[:, h_ec.index("dE+dB+dK")])
                   / en[:, 1:1 + n_en].sum(axis=1)).max()
        n0 = SIDE ** 3 * PPC
        for rep in reps:
            steps = rep["step_s"]
            log(f"[19 mesh] cli f32 free rank {rep['rank']}: "
                f"{rep['device']} {rep['backend']}, ranks share a card "
                f"{rep['shared_card']}; KSP {rep['ksp_history']} (one rank "
                f"{cli_one_ksp}); step ms median "
                f"{statistics.median(steps) * 1e3:.3f} (per step "
                f"{[round(s * 1e3, 3) for s in steps]}); bytes exchanged a "
                f"step {rep['mesh']['bytes_sent'] / len(steps):.0f}, "
                f"exchange ms a step "
                f"{rep['mesh']['seconds'] * 1e3 / len(steps):.3f}; "
                f"particles {rep['count']}; launches {rep['launches']} | "
                f"{card}")
            check(rep["count"] == [n0], f"particles {rep['count']} of {n0}")
            check(all(abs(a - b) <= 1 for a, b in zip(rep["ksp_history"],
                                                       cli_one_ksp)),
                  "the 2-rank CLI run's KSP iterations")
            add(rep["launches"])
        log(f"[19 mesh] cli f32 free: max |dE+dB+dK|/(wE+wB+wK) "
            f"{closure:.3e} (tol {ENERGY_TOL})")
        check(closure <= ENERGY_TOL, "the 2-rank energy identity fails")
        _mesh_launch_gate("free", reps, "cli f32 free")

        # float32, blocks route: one rank and two
        os.environ["XPIC_MASS"] = "blocks"
        try:
            one, sim, _, one_l = run_cli(os.path.join(work, "blocks1"),
                                         SIDE, PPC, CLI_STEPS, "cuda:0")
            out, reps = run_mesh_cli(os.path.join(work, "blocks2"), SIDE,
                                     PPC, CLI_STEPS)
        finally:
            del os.environ["XPIC_MASS"]
        _mesh_tables(one, out, SIDE, TABLE_TOL,
                     f"cli {SIDE}^3 x {PPC} ppc f32 blocks")
        for rep in reps:
            log(f"[19 mesh] cli f32 blocks rank {rep['rank']}: KSP "
                f"{rep['ksp_history']} (one rank {sim.ksp_history}), "
                f"launches {rep['launches']}")
            add(rep["launches"])
        _mesh_launch_gate("blocks", reps, "cli f32 blocks")

        # float64 (blocks, the global sort): one rank and two, 16^3
        with run_env(F64_ENV):
            one, sim, _, _ = run_cli(os.path.join(work, "f64one"),
                                     MESH_F64_SIDE, MESH_F64_PPC,
                                     MESH_F64_STEPS, "cuda:0")
            out, reps = run_mesh_cli(os.path.join(work, "f64two"),
                                     MESH_F64_SIDE, MESH_F64_PPC,
                                     MESH_F64_STEPS)
        _mesh_tables(one, out, MESH_F64_SIDE, F64_TABLE_TOL,
                     f"cli {MESH_F64_SIDE}^3 x {MESH_F64_PPC} ppc f64")
        for rep in reps:
            log(f"[19 mesh] cli f64 rank {rep['rank']}: KSP "
                f"{rep['ksp_history']} (one rank {sim.ksp_history}), "
                f"launches {rep['launches']}")
            check(rep["ksp_history"] == sim.ksp_history,
                  "the float64 2-rank KSP iterations differ")
            add(rep["launches"])
        _mesh_launch_gate("f64", reps, "cli f64")
    rows = {k: dict(ranks[0][k], launches=total.get(k, 0))
            for k in ("cheb_sweep", "cheb_sweep_f64")}
    rows["cheb_sweep_f64"]["t8"] = ranks[0]["cheb_sweep_f64_t8"]
    rows["rebin_place_zghost"] = ranks[0]["k3"]
    return total, rows


# -- phase 20: ecsimcorr, basic and eccapfim over two ranks sharing the card --
# Each run: (scheme, side, ppc, steps with the warm-up step, environment).
# The float32 runs at 32^3 x 50 ppc (16 x 32 x 32 slabs), the float64 ones
# at 16^3 x 20 ppc.  SimulationBackup over ranks is ROADMAP A11b, so the
# basic runs drop phase 13's backup.
MESH_RUNS = {
    "ecsimcorr_free": ("ecsimcorr", SIDE, PPC, 3,
                       dict(F32_ENV, XPIC_MASS="free")),
    "ecsimcorr_blocks": ("ecsimcorr", SIDE, PPC, 3,
                         dict(F32_ENV, XPIC_MASS="blocks")),
    "basic": ("basic", SIDE, PPC, 4, F32_ENV),
    "eccapfim": ("eccapfim", SIDE, PPC, 3, F32_ENV),
    "f64_ecsimcorr": ("ecsimcorr", MESH_F64_SIDE, MESH_F64_PPC, 3, F64_ENV),
    "f64_basic": ("basic", MESH_F64_SIDE, MESH_F64_PPC, 3, F64_ENV),
    "f64_eccapfim": ("eccapfim", MESH_F64_SIDE, MESH_F64_PPC, 3, F64_ENV),
}
# Every rank's kernels on each run (float64: no K2 or K3; basic f64: none).
MESH_RUN_KERNELS = {
    "ecsimcorr_free": MESH_KERNELS["free"],
    "ecsimcorr_blocks": MESH_KERNELS["blocks"],
    "basic": BASIC_KERNELS,
    "eccapfim": ("cheb_sweep", "rebin_extract", "rebin_place",
                 "segment_fields"),
    "f64_ecsimcorr": MESH_KERNELS["f64"],
    "f64_basic": (),
    "f64_eccapfim": ("cheb_sweep_f64", "segment_fields_f64"),
}


def basic_mesh_config(out_dir, side, ppc, steps):
    doc = basic_config(out_dir, side, ppc, steps)
    del doc["SimulationBackup"]
    return doc


def mesh_run_config(scheme):
    from xpic_tpu_torch.benchmarks.turns import eccapfim_config

    return {"ecsimcorr": ecsimcorr_config, "basic": basic_mesh_config,
            "eccapfim": eccapfim_config}[scheme]


def _mesh_k6(geom, mesh):
    """K6 on this rank's slab: seeded E and B on the 32^3 grid, cell-
    relative moves of up to 0.9 cell a axis at K' = 32 (rows of slots at
    rest); the slab's window blocks (through the ghost planes) bitwise
    the whole grid's rows, K6 on them within phase 3's tolerance of its
    twin and bitwise the rows of K6 on the whole grid, timed while the
    other rank waits (the two share the card); float32 and float64."""
    import torch.distributed as dist

    from xpic_tpu_torch.benchmarks import call_ms, device_ms
    from xpic_tpu_torch.ops.implicit_esirkepov import gather_window_blocks
    from xpic_tpu_torch.ops.segment_kernel import (
        FLOPS_PER_SEGMENT,
        live_segments,
        segment_fields,
        segment_fields_plain,
    )

    dev = torch.device("cuda", 0)
    sgeom = geom.slab(mesh)
    rng = np.random.default_rng(21)
    shape = (3,) + geom.shape
    E, B = (torch.tensor(0.1 * rng.standard_normal(shape),
                         dtype=torch.float32, device=dev) for _ in range(2))
    kp = 32
    t0 = torch.tensor(rng.random((geom.n_cells, kp, 3)), dtype=torch.float32,
                      device=dev)
    move = torch.tensor(rng.uniform(-0.9, 0.9, tuple(t0.shape)),
                        dtype=torch.float32, device=dev)
    move[:, :4] = 0.0
    tn = t0 + move
    n, G = sgeom.nz, sgeom.n_cells
    rows = slice(mesh.rank * G, (mesh.rank + 1) * G)
    out = {}
    for dtype in (torch.float32, torch.float64):
        Ew = gather_window_blocks(E.to(dtype), geom)
        Bw = gather_window_blocks(B.to(dtype), geom)
        Es = gather_window_blocks(E[:, mesh.z0:mesh.z0 + n].to(dtype),
                                  sgeom)
        Bs = gather_window_blocks(B[:, mesh.z0:mesh.z0 + n].to(dtype),
                                  sgeom)
        a, b = t0[rows].to(dtype), tn[rows].to(dtype)
        E_k, B_k = segment_fields(Es, Bs, a, b)
        E_w, B_w = segment_fields(Ew, Bw, t0.to(dtype), tn.to(dtype))
        E_p, B_p = segment_fields_plain(Es, Bs, a, b)
        torch.cuda.synchronize()
        rel = max(float((E_k - E_p).abs().max() / E_p.abs().max()),
                  float((B_k - B_p).abs().max() / B_p.abs().max()))
        segs = live_segments(a, b)
        f64 = dtype == torch.float64
        for r in range(mesh.world):
            dist.barrier()
            if r == mesh.rank:
                times = dict(
                    ms=device_ms(lambda: segment_fields(Es, Bs, a, b), dev),
                    call_ms=call_ms(lambda: segment_fields(Es, Bs, a, b),
                                    dev),
                    plain_ms=device_ms(
                        lambda: segment_fields_plain(Es, Bs, a, b), dev))
        dist.barrier()
        out[str(dtype).removeprefix("torch.")] = dict(
            cells=G, kp=kp, segments_per_slot=segs / (G * kp),
            windows_bitwise=bool(torch.equal(Es, Ew[rows])
                                 and torch.equal(Bs, Bw[rows])),
            bitwise_whole=bool(torch.equal(E_k, E_w[rows])
                               and torch.equal(B_k, B_w[rows])),
            max_abs_err=max(float((E_k - E_p).abs().max()),
                            float((B_k - B_p).abs().max())),
            rel_err=rel, **times,
            **bound(Es.element_size() * (2 * G * 648 + 4 * G * kp * 3),
                    FLOPS_PER_SEGMENT * segs,
                    F64_FLOPS if f64 else F32_FLOPS),
            library_ms=None)
    return out


# SlabMesh's collectives, each checked for an input on the host while the
# run's data is on the card (NCCL takes card tensors only).
MESH_COLLECTIVES = ("exchange", "_all_reduce", "allgather",
                    "allgather_rows", "gather_to_root")


@contextlib.contextmanager
def _counted_collectives(host):
    """Count in ``host`` (method -> calls) every SlabMesh collective
    handed a tensor that lies on the host."""
    from xpic_tpu_torch.parallel.mesh import SlabMesh

    saved = {m: getattr(SlabMesh, m) for m in MESH_COLLECTIVES}

    def wrap(meth, fn):
        def counted(self, *args, **kwargs):
            if any(torch.is_tensor(a) and a.device.type == "cpu"
                   for a in args):
                host[meth] = host.get(meth, 0) + 1
            return fn(self, *args, **kwargs)
        return counted

    for m, fn in saved.items():
        setattr(SlabMesh, m, wrap(m, fn))
    try:
        yield
    finally:
        for m, fn in saved.items():
            setattr(SlabMesh, m, fn)


def _scheme_rank(rank, init, work):
    """One rank of phase 20: ``runtime.cli.main`` on each run's
    ``"Mesh": 2`` config as a rank of the group (a launched group, as
    under ``torchrun``), each step timed and its collectives, K1 slab
    applies and launches counted, every collective handed a host tensor
    counted, then K6 on the slab; what it finds goes to
    ``work/rank<r>.json``."""
    from xpic_tpu_torch import kernels, schemes
    from xpic_tpu_torch.commands import particles_load
    from xpic_tpu_torch.config import Geometry
    from xpic_tpu_torch.ops import stencil_kernel
    from xpic_tpu_torch.parallel.mesh import make_mesh
    from xpic_tpu_torch.runtime import cli, distributed

    distributed.join(init, rank, MESH, timeout=MESH_RANK_TIMEOUT_S)
    try:
        kernels.load()
        res = {"rank": rank, "runs": {}, "host_inputs": {}}
        build = schemes.build_simulation
        slab_apply = stencil_kernel.cheb_matM_inv_slab
        applies = [0]

        def counted_apply(*args, **kwargs):
            applies[0] += 1
            return slab_apply(*args, **kwargs)

        def cheb_launches():
            return (kernels.LAUNCHES["cheb_sweep"]
                    + kernels.LAUNCHES["cheb_sweep_f64"])

        for name, (_, _, _, _, env) in MESH_RUNS.items():
            steps = []

            def timed_build(*args, **kwargs):
                sim = build(*args, **kwargs)
                step, mesh = sim.timestep_implementation, sim.mesh

                def timed_step(t):
                    torch.cuda.synchronize()
                    b0, s0 = mesh.bytes_sent, mesh.seconds
                    c0 = dict(mesh.calls)
                    a0, l0 = applies[0], cheb_launches()
                    t0 = time.perf_counter()
                    step(t)
                    torch.cuda.synchronize()
                    steps.append(dict(
                        ms=(time.perf_counter() - t0) * 1e3,
                        bytes=mesh.bytes_sent - b0,
                        exchange_ms=(mesh.seconds - s0) * 1e3,
                        calls={k: v - c0.get(k, 0)
                               for k, v in mesh.calls.items()
                               if v - c0.get(k, 0)},
                        cheb_applies=applies[0] - a0,
                        cheb_launches=cheb_launches() - l0))

                sim.timestep_implementation = timed_step
                return sim

            rep = os.path.join(work, name, "report.json")
            schemes.build_simulation = timed_build
            stencil_kernel.cheb_matM_inv_slab = counted_apply
            particles_load.seed(5489)
            host = {}
            try:
                with run_env(env), _counted_collectives(host):
                    rc = cli.main([os.path.join(work, name, "cfg.json"),
                                   "--quiet", "--report", rep])
            finally:
                schemes.build_simulation = build
                stencil_kernel.cheb_matM_inv_slab = slab_apply
            if rc != 0:
                raise RuntimeError(f"{name}: cli.main returned {rc}")
            res["runs"][name] = steps
            res["host_inputs"][name] = host
        geom = Geometry(dx=0.5, dy=0.5, dz=0.5, dt=1.5, nx=SIDE, ny=SIDE,
                        nz=SIDE, nt=1)
        res["k6"] = _mesh_k6(geom, make_mesh(MESH, SIDE))
        with open(os.path.join(work, f"rank{rank}.json"), "w") as fh:
            json.dump(res, fh)
    finally:
        distributed.leave()


def _spawn_ranks(fn, args, deadline):
    """Start the ``MESH`` ranks of ``fn(rank, init, *args)``, wait at most
    ``deadline`` seconds; fail when a rank fails or the time is up (the
    ranks are killed then)."""
    import torch.multiprocessing as mp

    from xpic_tpu_torch.runtime.distributed import free_port

    init = f"tcp://127.0.0.1:{free_port()}"
    ctx = mp.start_processes(fn, args=(init, *args), nprocs=MESH,
                             join=False, start_method="spawn")
    end = time.monotonic() + deadline
    while not ctx.join(timeout=max(1.0, end - time.monotonic())):
        if time.monotonic() >= end:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
            check(False, f"the ranks ran past {deadline} s")


def mesh_schemes_path(name, card):
    """Phase 20: ecsimcorr (both mass routes), basic and eccapfim over two
    ranks that share the card, each against a one-rank run of the same
    config at the same depth, then K6 on each rank's slab.  Returns each
    run's kernel launches (both ranks) and K6's slab rows."""
    from xpic_tpu_torch.diagnostics.compare import TABLES, table_errors

    one = {}
    with tempfile.TemporaryDirectory(prefix="xpic_smoke_") as work:
        t0 = time.perf_counter()
        for run, (scheme, side, ppc, steps, env) in MESH_RUNS.items():
            doc = mesh_run_config(scheme)
            with run_env(env):
                out, sim, step_ms, _ = run_cli(
                    os.path.join(work, run, "one"), side, ppc, steps,
                    "cuda:0", doc=doc)
            one[run] = dict(
                out=out, ms=statistics.median(step_ms[1:]),
                ksp=list(getattr(sim, "ksp_history", [])),
                correct=list(getattr(sim, "correct_ksp_history", [])),
                outer=list(getattr(sim, "outer_history", [])),
                count=sim.count_history[-1])
            os.makedirs(os.path.join(work, run), exist_ok=True)
            with open(os.path.join(work, run, "cfg.json"), "w") as fh:
                json.dump(dict(doc(os.path.join(work, run, "out"), side,
                                   ppc, steps), Mesh=MESH), fh)
        one_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _spawn_ranks(_scheme_rank, (work,), MESH_DEADLINE_S)
        ranks = []
        for r in range(MESH):
            with open(os.path.join(work, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
        log(f"[20 mesh schemes] one-rank runs in {one_s:.1f} s; the two "
            f"ranks' runs and K6 checks in {time.perf_counter() - t0:.1f} s")
        launches = {}
        for run, (scheme, side, ppc, steps, env) in MESH_RUNS.items():
            f64 = run.startswith("f64")
            tol = F64_TABLE_TOL if f64 else TABLE_TOL
            ref = one[run]
            charge = np.sqrt(side ** 3) / (BASIC_DT if scheme == "basic"
                                           else 1.5)
            worst = {}
            for table in TABLES:
                errs = table_errors(
                    table, ref["out"], os.path.join(work, run, "out"),
                    n_cells=side ** 3, charge_scale=charge,
                    dt=BASIC_DT if scheme == "basic" else 0.0)
                worst[table] = max(errs.items(), key=lambda kv: kv[1])
            label = (f"{run} {side}^3 x {ppc} ppc "
                     f"{'f64' if f64 else 'f32'}, 1 + {steps - 1} steps")
            log(f"[20 mesh schemes] {label}: 2 ranks against 1, worst "
                f"column per table {worst} (tol {tol}); one rank "
                f"{ref['ms']:.3f} ms a step (median after the warm-up)")
            check(all(e <= tol for _, e in worst.values()),
                  f"{label}: the 2-rank tables differ from the one-rank "
                  f"run's")
            total = {}
            for r in ranks:
                with open(os.path.join(work, run,
                                       f"report.json.rank{r['rank']}")) as fh:
                    rep = json.load(fh)
                timed = r["runs"][run][1:]
                calls = {}
                for st in timed:
                    for k, v in st["calls"].items():
                        calls[k] = calls.get(k, 0) + v / len(timed)
                n_calls = sum(calls.values())
                applies = sum(st["cheb_applies"] for st in timed)
                k1_launches = sum(st["cheb_launches"] for st in timed)
                ghosts = sum(st["calls"].get("cheb_ghosts", 0)
                             for st in timed)
                host = r["host_inputs"][run]
                e = cheb_segments(side // MESH)
                want = MESH_CALLS_PREDICTED.get(run)
                hist = {"ksp": rep["ksp_history"],
                        "correct": rep.get("correct_ksp_history", []),
                        "outer": rep.get("outer_history", [])}
                log(f"[20 mesh schemes] {label} rank {rep['rank']}: "
                    f"{rep['device']} {rep['backend']}, ranks share a card "
                    f"{rep['shared_card']}; ms a step "
                    f"{statistics.median(s['ms'] for s in timed):.3f} "
                    f"(per step {[round(s['ms'], 3) for s in r['runs'][run]]}"
                    f", the first a warm-up), exchange ms a step "
                    f"{statistics.median(s['exchange_ms'] for s in timed):.3f}"
                    f", bytes sent a step "
                    f"{statistics.median(s['bytes'] for s in timed):.0f}, "
                    f"collectives a step {n_calls:.1f} "
                    f"{ {k: round(v, 1) for k, v in calls.items()} } "
                    f"(predicted {want if want is not None else '-'}; "
                    f"{applies / len(timed):.1f} K1 slab applies a step, "
                    f"{ghosts} ghost exchanges and {k1_launches} launches "
                    f"for {applies} applies, {e} each predicted; with 11 "
                    f"exchanges an apply "
                    f"{n_calls + applies * (11 - e) / len(timed):.1f}); "
                    f"collectives handed a host tensor {host}; "
                    f"iterations {hist} (one rank ksp {ref['ksp']}, correct "
                    f"{ref['correct']}, outer {ref['outer']}); particles "
                    f"{rep['count']}; launches {rep['launches']} | {card}")
                check(ghosts == k1_launches == e * applies,
                      f"{label}: {ghosts} K1 ghost exchanges and "
                      f"{k1_launches} launches for {applies} applies, not "
                      f"{e} each")
                check(want is None
                      or abs(n_calls - want) <= MESH_CALLS_SLACK * want,
                      f"{label}: {n_calls} collectives a step, predicted "
                      f"{want}")
                check(not host, f"{label}: collectives handed a host "
                      f"tensor on the card: {host}")
                for key in ("ksp", "correct", "outer"):
                    a, b = hist[key], ref[key]
                    check(len(a) == len(b) and all(
                        abs(x - y) <= (0 if f64 else 1)
                        for x, y in zip(a, b)),
                          f"{label}: {key} iterations {a} against one "
                          f"rank's {b}")
                check(rep["count"] == [side ** 3 * ppc] == ref["count"],
                      f"{label}: particles {rep['count']} of "
                      f"{side ** 3 * ppc}")
                got = rep["launches"]
                check(all(got.get(k, 0) > 0 for k in MESH_RUN_KERNELS[run]),
                      f"{label}: rank {rep['rank']} launched {got}, not "
                      f"every one of {MESH_RUN_KERNELS[run]}")
                for k, v in got.items():
                    total[k] = total.get(k, 0) + v
            launches[run] = total
    k6 = {}
    for dtype, tol in (("float32", SEGMENT_TOL), ("float64", F64_TOL)):
        for r in ranks:
            row = r["k6"][dtype]
            log(f"[20 mesh schemes] rank {r['rank']} K6 {dtype} on its "
                f"{row['cells']}-cell slab, K'={row['kp']} "
                f"({row['segments_per_slot']:.3f} live segments a slot): "
                f"window blocks bitwise the whole grid's rows "
                f"{row['windows_bitwise']}, K6 bitwise the whole-grid "
                f"K6's rows {row['bitwise_whole']}, max|d|/max "
                f"{row['rel_err']:.3e} against its twin (tol {tol}); "
                f"{row['ms']:.4f} ms (call {row['call_ms']:.4f}) vs twin "
                f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.4f} "
                f"({row['bound_by']}) | {card}")
            check(row["windows_bitwise"] and row["bitwise_whole"],
                  f"K6 {dtype} on a slab differs from the whole grid's rows")
            check(row["rel_err"] <= tol,
                  f"K6 {dtype} on a slab differs from its twin")
        k6[dtype] = ranks[0]["k6"][dtype]
    return launches, k6


if __name__ == "__main__":
    main()
