"""The port's eccapfim scheme against the JAX package, on the CPU, from the
same numpy inputs.

* The implicit-Esirkepov pieces (``ops/implicit_esirkepov.py``: the window
  blocks, the segment split, the E and B gathers, the current deposit)
  and the plain twin of the ``segment_fields`` kernel against JAX in
  float64 to 1e-12 (the same expressions summed in another order); the
  twin in float32 against the Pallas kernel in interpret mode within the
  JAX suite's own tolerance for it (2e-5, ``test_implicit_esirkepov``).
* The Anderson solver on a small nonlinear system: equal iteration
  counts, iterates to 1e-12.
* The slice: ``python -m xpic_tpu_torch cfg.json --device cpu`` against
  ``python -m xpic_tpu cfg.json``, both float64 with the reference's
  mt19937 load, 6^3 cells x 8 particles per cell, 2 steps: every table
  column within 1e-9 of its scale (``diagnostics.compare``), equal
  Crank-Nicolson and outer iteration counts, the residual histories to
  1e-6 of each row's first entry, the step-0 dumps byte for byte.  The
  JAX run, which is most of this file's time, happens once a test run
  (``torch_shared_fixture.build_once``).
* Port-only: the crosser fast path equals the general path, the
  fast-path and fast-particle guards fire, the remaining pushers keep the
  JAX suite's invariants (``tests/test_pushers.py``), and the entry point
  keeps its device rules.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xpic_tpu.schemes as jschemes
import xpic_tpu_torch.schemes as tschemes
from xpic_tpu.commands import particles_load as jload
from xpic_tpu.config import Geometry as JGeometry
from xpic_tpu.ops import binning as jbin
from xpic_tpu.ops import implicit_esirkepov as jie
from xpic_tpu.ops.pallas_implicit import segment_fields_pallas
from xpic_tpu.runtime import cli as jcli
from xpic_tpu.schemes.eccapfim import _segment_fields as jax_segment_fields
from xpic_tpu.solvers import anderson_solve as jax_anderson
from xpic_tpu_torch import kernels, pushers
from xpic_tpu_torch.commands import particles_load as tload
from xpic_tpu_torch.config import Config
from xpic_tpu_torch.config import Geometry as TGeometry
from xpic_tpu_torch.convert import binned_from_numpy
from xpic_tpu_torch.diagnostics.compare import TABLES, read_table, table_errors
from xpic_tpu_torch.ops import binning as tbin
from xpic_tpu_torch.ops import implicit_esirkepov as tie
from xpic_tpu_torch.ops.segment_kernel import (
    segment_fields,
    segment_fields_plain,
)
from xpic_tpu_torch.runtime import cli as tcli
from xpic_tpu_torch.runtime import step_profile
from xpic_tpu_torch.schemes import build_simulation
from xpic_tpu_torch.schemes import eccapfim as tecc
from xpic_tpu_torch.solvers import anderson_solve

from torch_shared_fixture import build_once, load_sims, save_sims

torch.set_num_threads(1)

GEOM_KW = dict(dx=0.5, dy=0.4, dz=0.6, dt=1.5, nx=8, ny=6, nz=4, nt=1)
K = 16
STEPS = 2
DUMPS = ("E", "B")


def _t(a):
    return torch.tensor(np.asarray(a))


def _moves(seed, G=8 * 6 * 4):
    """Cell-relative start positions t0 [G, K, 3] and ends tn within
    +-0.8 cells (1-4 segments), some rows with tn == t0."""
    rng = np.random.default_rng(seed)
    t0 = rng.random((G, K, 3))
    tn = t0 + (rng.random((G, K, 3)) - 0.5) * 1.6
    tn[:, :2] = t0[:, :2]
    return t0, tn


def _fields(seed, geom):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((3,) + geom.shape),
            rng.standard_normal((3,) + geom.shape))


@pytest.mark.parametrize("bounds", [("periodic",) * 3,
                                    ("ghosted", "periodic", "reflective")],
                         ids=lambda b: b[0])
def test_window_blocks_match_jax(bounds):
    """One index gather builds the blocks of 648 rolled reads, exactly."""
    jg = JGeometry(**GEOM_KW, bounds=bounds)
    tg = TGeometry(**GEOM_KW, bounds=bounds)
    E, _ = _fields(0, jg)
    ref = np.asarray(jie.gather_window_blocks(jnp.asarray(E), jg))
    got = tie.gather_window_blocks(_t(E), tg).numpy()
    assert got.shape == ref.shape == (jg.n_cells, 3, 6, 6, 6)
    assert np.array_equal(got, ref)


def test_split_segments_match_jax():
    t0, tn = _moves(1)
    ref = np.asarray(jie.split_segments(jnp.asarray(t0), jnp.asarray(tn)))
    got = tie.split_segments(_t(t0), _t(tn)).numpy()
    assert np.array_equal(got, ref)
    # the moves take 1 to 4 segments
    n_seg = np.sum(np.diff(got, axis=-1) > 0, axis=-1)
    assert set(np.unique(n_seg)) == {1, 2, 3, 4}


@pytest.mark.parametrize("what", ["gather_E", "gather_B", "gather_dk",
                                  "deposit_J"])
def test_implicit_esirkepov_matches_jax_f64(what):
    jg, tg = JGeometry(**GEOM_KW), TGeometry(**GEOM_KW)
    E, B = _fields(2, jg)
    t0, tn = _moves(3)
    rng = np.random.default_rng(4)
    v = rng.standard_normal(t0.shape)
    scale = rng.random(t0.shape[:2])
    Ej, Bj = (jie.gather_window_blocks(jnp.asarray(F), jg) for F in (E, B))
    Et, Bt = (tie.gather_window_blocks(_t(F), tg) for F in (E, B))
    if what == "gather_E":
        ref = jie.gather_E_implicit(Ej, jnp.asarray(t0), jnp.asarray(tn))
        got = tie.gather_E_implicit(Et, _t(t0), _t(tn))
    elif what == "gather_B":
        ref = jie.gather_B_implicit(Ej, jnp.asarray(tn))
        got = tie.gather_B_implicit(Et, _t(tn))
    elif what == "gather_dk":
        # E, B and a stand-in |B|-gradient field (E's blocks again)
        ref = jnp.stack(jie.gather_dk_fields(Ej, Bj, Ej, jnp.asarray(t0),
                                             jnp.asarray(tn)))
        got = torch.stack(tie.gather_dk_fields(Et, Bt, Et, _t(t0), _t(tn)))
    else:
        ref = jie.scatter_blocks(jie.deposit_J_implicit(
            jnp.asarray(t0), jnp.asarray(tn), jnp.asarray(v),
            jnp.asarray(scale)), jg)
        got = tie.scatter_blocks(tie.deposit_J_implicit(
            _t(t0), _t(tn), _t(v), _t(scale)), tg)
    ref, got = np.asarray(ref), got.numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def test_segment_twin_matches_jax_f64():
    jg, tg = JGeometry(**GEOM_KW), TGeometry(**GEOM_KW)
    E, B = _fields(5, jg)
    t0, tn = _moves(6)
    Eb, Bb = (jie.gather_window_blocks(jnp.asarray(F), jg) for F in (E, B))
    ref = jax_segment_fields(Eb, Bb, jnp.asarray(t0), jnp.asarray(tn))
    Ebt, Bbt = (tie.gather_window_blocks(_t(F), tg) for F in (E, B))
    got = segment_fields(Ebt, Bbt, _t(t0), _t(tn))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= 1e-12 * np.abs(r).max()


def test_segment_twin_matches_pallas_kernel_f32():
    """The twin in float32 against ``segment_fields_pallas`` (interpret
    mode), the TPU kernel K6 replaces, at the JAX suite's tolerance."""
    jg, tg = JGeometry(**GEOM_KW), TGeometry(**GEOM_KW)
    E, B = _fields(7, jg)
    t0, tn = _moves(8)
    f32 = {k: np.asarray(v, np.float32)
           for k, v in dict(E=E, B=B, t0=t0, tn=tn).items()}
    Eb, Bb = (jie.gather_window_blocks(jnp.asarray(f32[k]), jg)
              for k in "EB")
    ref = segment_fields_pallas(Eb, Bb, jnp.asarray(f32["t0"]),
                                jnp.asarray(f32["tn"]), interpret=True)
    Ebt, Bbt = (tie.gather_window_blocks(_t(f32[k]), tg) for k in "EB")
    got = segment_fields_plain(Ebt, Bbt, _t(f32["t0"]), _t(f32["tn"]))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-5,
                                   atol=2e-5)


def test_segment_special_cases_match_the_general_path():
    """``_rest_fields`` is the general path at tn == t0, and
    ``_one_segment_fields`` the general path for moves that cross no
    face (float64, 1e-12)."""
    tg = TGeometry(**GEOM_KW)
    E, B = (tie.gather_window_blocks(_t(F), tg) for F in _fields(9, tg))
    t0, _ = _moves(10)
    t0 = np.clip(t0, 0.05, 0.45)  # below the face at 0.5
    tn = t0 + np.random.default_rng(11).uniform(-0.04, 0.04, t0.shape)
    for fast, ref in ((tecc._rest_fields(E, B, _t(t0)),
                       segment_fields_plain(E, B, _t(t0), _t(t0))),
                      (tecc._one_segment_fields(E, B, _t(t0), _t(tn)),
                       segment_fields_plain(E, B, _t(t0), _t(tn)))):
        for f, r in zip(fast, ref):
            assert float((f - r).abs().max()) <= 1e-12 * float(r.abs().max())


def test_cpu_wrapper_counts_no_launch_and_others_raise():
    tg = TGeometry(**GEOM_KW)
    kernels.reset_counts()
    E, B = (tie.gather_window_blocks(_t(F).float(), tg)
            for F in _fields(12, tg))
    t0, tn = (_t(a).float() for a in _moves(13))
    segment_fields(E, B, t0[:, :5], tn[:, :5])
    assert kernels.LAUNCHES["segment_fields"] == 0
    with pytest.raises(RuntimeError, match="unsupported device"):
        segment_fields(E.to("meta"), B.to("meta"), t0.to("meta"),
                       tn.to("meta"))


def test_migration_helpers_match_jax():
    """``wrap_state``, ``rebin_overflow`` and ``migrate_checked`` on a
    state whose particles left the domain and overfill some cells."""
    jg = JGeometry(dx=0.5, dy=0.5, dz=0.5, dt=1.0, nx=4, ny=4, nz=4, nt=1)
    tg = TGeometry(dx=0.5, dy=0.5, dz=0.5, dt=1.0, nx=4, ny=4, nz=4, nt=1)
    rng = np.random.default_rng(14)
    G, Ks = jg.n_cells, 8
    cells = np.stack(np.unravel_index(np.arange(G), jg.shape)[::-1], -1)
    r = cells[:, None, :] + rng.random((G, Ks, 3))
    r += rng.uniform(-0.9, 0.9, r.shape)  # some leave the box
    r[:3] = cells[5] + 0.5  # three full rows crowd into cell 5
    p = rng.standard_normal((G, Ks, 3))
    valid = rng.random((G, Ks)) < 0.6
    valid[:3] = True
    jst = jbin.BinnedState(r=jnp.asarray(r), p=jnp.asarray(p),
                           valid=jnp.asarray(valid))
    tst = binned_from_numpy(r, p, valid, device="cpu")
    jw, tw = jbin.wrap_state(jst, jg), tbin.wrap_state(tst, tg)
    assert np.array_equal(tw.r.numpy(), np.asarray(jw.r))
    assert int(tbin.rebin_overflow(tw, tg)) == int(
        jbin.rebin_overflow(jw, jg)) > 0
    (ts, tl), (js, jl) = (tbin.migrate_checked(tst, tg),
                          jbin.migrate_checked(jst, jg))
    assert tl.tolist() == np.asarray(jl).tolist()
    assert np.array_equal(ts.valid.numpy(), np.asarray(js.valid))
    assert np.array_equal(ts.r.numpy(), np.asarray(js.r))


def test_anderson_matches_jax():
    """F(x) = x - 0.5 tanh(A x) - b: the same iterates and iteration
    count as the JAX solver."""
    rng = np.random.default_rng(15)
    n = 24
    A = rng.standard_normal((n, n)) / np.sqrt(n)
    b = rng.standard_normal(n)

    def F_jax(x):
        return x - 0.5 * jnp.tanh(jnp.asarray(A) @ x) - jnp.asarray(b)

    def F_torch(x):
        return x - 0.5 * torch.tanh(_t(A) @ x) - _t(b)

    ref = jax_anderson(F_jax, jnp.zeros(n), atol=1e-13, rtol=1e-13, m=5)
    got = anderson_solve(F_torch, torch.zeros(n, dtype=torch.float64),
                         atol=1e-13, rtol=1e-13, m=5)
    assert got.converged and ref.converged
    assert got.iterations == ref.iterations > 3
    assert np.abs(got.x.numpy() - np.asarray(ref.x)).max() <= 1e-12
    np.testing.assert_allclose(got.history, ref.history, rtol=1e-9,
                               atol=1e-15)


# -- the slice: the config-driven run against the JAX package ---------------


def make_doc(out_dir, dt=1.0, steps=STEPS, ppc=8):
    """``tests/test_eccapfim.py``'s config at 6^3 x ``ppc``, diagnosed
    every step, with the E and B dumps."""
    return {
        "Simulation": "eccapfim",
        "OutputDirectory": str(out_dir),
        "Geometry": {
            "x": 3.0, "y": 3.0, "z": 3.0, "t": steps * dt,
            "dx": 0.5, "dy": 0.5, "dz": 0.5, "dt": dt,
            "diagnose_period": dt,
            "da_boundary_x": "DM_BOUNDARY_PERIODIC",
            "da_boundary_y": "DM_BOUNDARY_PERIODIC",
            "da_boundary_z": "DM_BOUNDARY_PERIODIC",
        },
        "Particles": [{"sort_name": "electrons", "Np": ppc, "n": 1.0,
                       "q": -1.0, "m": 1.0, "T": 0.1}],
        "Presets": [
            {"command": "SetParticles", "particles": "electrons",
             "coordinate": {"name": "CoordinateInBox"},
             "momentum": {"name": "MaxwellianMomentum", "tov": True}},
        ],
        "Diagnostics": [{"diagnostic": "FieldView", "field": f}
                        for f in DUMPS],
    }


def _run(cli, schemes, root, argv):
    """``cli.main`` on :func:`make_doc` with the reference RNG; returns
    the output directory and the simulation it built."""
    cfg = root / "cfg.json"
    cfg.write_text(json.dumps(make_doc(root / "out")))
    built = []
    orig = schemes.build_simulation
    mp = pytest.MonkeyPatch()

    def capture(*args, **kwargs):
        built.append(orig(*args, **kwargs))
        return built[-1]

    mp.setattr(schemes, "build_simulation", capture)
    mp.setenv("XPIC_RNG", "reference")
    try:
        assert cli.main([str(cfg), "--quiet", *argv]) == 0
    finally:
        mp.undo()
        jload.seed(5489)
        tload.seed(5489)
    return root / "out", built[0]


def _build_runs(root):
    """Both packages' runs into ``root/<name>/out``, and the port's outer
    iterations into ``root/sims.json``."""
    sims = {}
    for name, cli, schemes, argv in (
            ("jax", jcli, jschemes, []),
            ("torch", tcli, tschemes, ["--device", "cpu"])):
        (root / name).mkdir()
        sims[name] = _run(cli, schemes, root / name, argv)[1]
    save_sims(root / "sims.json", sims, ("outer_history",))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Built once per test run, whatever the number of xdist workers
    (``tests/test_torch_mesh_schemes.py`` reads it too)."""
    root = build_once(tmp_path_factory, "torch_eccapfim_runs", _build_runs)
    sims = load_sims(root / "sims.json")
    return {name: (root / name / "out", sims[name]) for name in sims}


def test_cli_run_matches_jax(runs):
    """One test on purpose: the JAX run behind it is the expensive part,
    and one test keeps it on one worker of a parallel run."""
    (jout, _), (tout, tsim) = runs["jax"], runs["torch"]
    # Charge is conserved to rounding: its continuity norms are held
    # against the 2-norm of rho / dt (|q n| = 1 per cell).
    charge = np.sqrt(6 ** 3) / 1.0
    for table in TABLES:
        errs = table_errors(table, jout, tout, n_cells=6 ** 3,
                            charge_scale=charge)
        _, rows = read_table(tout / "temporal" / table)
        assert rows.shape[0] == STEPS + 1 and np.isfinite(rows).all()
        assert all(e <= 1e-9 for e in errs.values()), (table, errs)
    _, ch = read_table(tout / "temporal" / "charge_conservation.txt")
    assert np.all(ch[:, 1:] < 1e-9)  # the scheme conserves charge

    with open(jout / "temporal" / "convergence_history.txt") as fj, \
            open(tout / "temporal" / "convergence_history.txt") as ft:
        rj, rt = fj.read().splitlines(), ft.read().splitlines()
    assert rt[0].split() == rj[0].split() and len(rt) == len(rj) == STEPS + 1
    for a, b in zip(rj[1:], rt[1:]):
        a, b = a.split(), b.split()
        assert b[:3] == a[:3]  # Time, AvgCN_electrons, ItNum
        ha, hb = np.array(a[3:], float), np.array(b[3:], float)
        assert ha.shape == hb.shape == (int(a[2]) + 1,)
        assert np.abs(ha - hb).max() <= 1e-6 * ha[0]
    assert tsim.outer_history == [int(r.split()[2]) for r in rt[1:]]
    assert all(0 < it < tecc.MAXIT for it in tsim.outer_history)

    for dump in DUMPS:
        names = sorted(os.listdir(jout / dump))
        assert sorted(os.listdir(tout / dump)) == names
        assert len(names) == STEPS + 1
        assert (tout / dump / names[0]).read_bytes() == \
            (jout / dump / names[0]).read_bytes()
        for name in names[1:]:
            a = np.fromfile(tout / dump / name, dtype=np.float32)
            b = np.fromfile(jout / dump / name, dtype=np.float32)
            assert np.abs(a - b).max() <= 1e-6 * max(np.abs(b).max(), 1e-30)


# -- port-only checks -------------------------------------------------------


def _species(tmp_path, dt, seed=558, ppc=30):
    tload.seed(seed)
    sim = build_simulation(Config.from_json(
        make_doc(tmp_path / "out", dt=dt, steps=4, ppc=ppc)), device="cpu")
    sim.initialize()
    tload.seed(5489)
    return sim, sim.species[0]


def test_fast_path_matches_general_path(tmp_path):
    """The crosser fast path (kc > 0) reproduces the general 4-segment
    evaluation up to float reassociation, at dt = 0.1 where only a few
    particles cross a face (float64, 1e-12)."""
    sim, sp = _species(tmp_path, dt=0.1)
    st = sp.state
    rng = np.random.default_rng(0)
    E, B = (_t(rng.normal(0.0, 1e-3, sim.E.shape)) for _ in range(2))
    qm, a0 = sp.params.qm, sp.params.q * sp.params.n_Np
    kc = max(2, st.p.shape[1] // 2)
    ref = tecc._form_species(E, B, st, sim.geom, qm, a0, 0)
    fast = tecc._form_species(E, B, st, sim.geom, qm, a0, kc)
    overflow, viol = fast[6]
    assert int(overflow) == 0 and int(viol) == 0
    for name, a, b in zip(("J", "r_new", "p_new", "iters", "nonconv",
                           "max_disp"), ref, fast):
        assert float(torch.as_tensor(b - a).abs().max()) <= 1e-12, name
    crossed = (torch.any(torch.round(fast[1]) != torch.round(st.r), dim=-1)
               & st.valid)
    assert 0 < int(crossed.sum()) < crossed.numel()


def test_crosser_overflow_raises_the_fallback_flag(tmp_path):
    """dt = 1: nearly every particle is a classified crosser, so kc = 1
    overflows a row."""
    sim, sp = _species(tmp_path, dt=1.0, seed=559)
    z = torch.zeros_like(sim.E)
    out = tecc._form_species(z, z, sp.state, sim.geom, sp.params.qm,
                             sp.params.q * sp.params.n_Np, 1)
    assert int(out[6][0]) == 1


def test_fast_particle_is_flagged(tmp_path):
    """A particle at 1.2 c (2.4 cells per dt = 1 along x) raises instead
    of losing charge outside the 6-wide window."""
    sim, sp = _species(tmp_path, dt=1.0, seed=556, ppc=8)
    arr = sp.arrays
    p = arr.p.clone()
    i = int(torch.nonzero(arr.alive)[0])
    p[i] = torch.tensor([1.2, 0.0, 0.0], dtype=p.dtype)
    sp.arrays = type(arr)(r=arr.r, p=p, alive=arr.alive)
    sp.count()
    with pytest.raises(RuntimeError, match="cells along one axis|converge"):
        sim.timestep_implementation(1)


def test_entry_point_device_rules(tmp_path, monkeypatch):
    cfg = Config.from_json(make_doc(tmp_path / "out"))
    with pytest.raises(ValueError, match="float32 and float64"):
        build_simulation(cfg, device="cuda", dtype=torch.float16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_simulation(cfg)
    sim = build_simulation(cfg, device="cpu")
    assert isinstance(sim, tecc.EccapfimSimulation)


def test_step_profile_reports_the_eccapfim_phases(tmp_path, monkeypatch):
    """The eccapfim breakdown on the CPU; the profiler window (held by
    ``test_torch_cli``) just runs its steps here: tracing the thousands
    of small CPU ops of an eccapfim step takes most of a minute."""
    monkeypatch.setenv("XPIC_X64", "0")

    def window(fns, device, after=None):
        for i, fn in enumerate(fns):
            fn()
            after(i)
        return {"runs": len(fns)}

    monkeypatch.setattr(step_profile, "device_window", window)
    tload.seed(560)
    sim = build_simulation(Config.from_json(
        make_doc(tmp_path / "out", steps=3, ppc=4)), device="cpu")
    out = step_profile.profile_run(sim)
    tload.seed(5489)
    assert out["steps_timed"] == 3 - step_profile.WINDOW
    assert set(out["phases_ms"]) == set(step_profile.ECCAPFIM_PHASES)
    assert out["outer_iters_per_step"] > 0 and out["cn_iters_per_sweep"] > 0
    assert out["fast_path_fallback_steps"] >= 0
    assert out["eccapfim_particle_push_throughput"] is None  # no card
    assert "ConvergenceHistory" in out["diagnostics_ms"]
    assert out["window"]["runs"] == step_profile.WINDOW


# -- the remaining pushers (tests/test_pushers.py's cases) -----------------

B0, QM = 2.0, -1.0


def _uniform(E, B):
    def fn(rn, r0):
        n = rn.shape[0]
        return (torch.tensor(E, dtype=torch.float64).expand(n, 3),
                torch.tensor(B, dtype=torch.float64).expand(n, 3))
    return fn


@pytest.mark.parametrize("omega_dt", [0.1, 0.5, 1.0])
def test_crank_nicolson_gyration(omega_dt):
    dt = omega_dt / B0
    fields = _uniform([0.0, 0.0, 0.0], [0.0, 0.0, B0])
    r = torch.zeros((1, 3), dtype=torch.float64)
    p = torch.tensor([[0.0, 0.4, 0.0]], dtype=torch.float64)
    speeds = []
    for _ in range(200):
        res = pushers.crank_nicolson_push(dt, QM, r, p, fields,
                                          atol=1e-13, rtol=1e-13)
        assert bool(res.converged.all())
        r, p = res.r, res.p
        speeds.append(float(torch.linalg.norm(p)))
    np.testing.assert_allclose(speeds, 0.4, rtol=1e-10)


def test_crank_nicolson_exb():
    dt = 0.2
    fields = _uniform([0.0, 0.05, 0.0], [0.0, 0.0, 1.0])
    r = torch.zeros((1, 3), dtype=torch.float64)
    p = torch.tensor([[0.05, 0.0, 0.0]], dtype=torch.float64)
    r_first = r[0].clone()
    for _ in range(500):
        res = pushers.crank_nicolson_push(dt, QM, r, p, fields)
        r, p = res.r, res.p
    drift_v = (r[0] - r_first).numpy() / (500 * dt)
    np.testing.assert_allclose(drift_v, [0.05, 0.0, 0.0], atol=5e-3)


def _dk_fields(E, B):
    def fn(r0, rn):
        n = r0.shape[0]
        return (torch.tensor(E, dtype=torch.float64).expand(n, 3),
                torch.tensor(B, dtype=torch.float64).expand(n, 3),
                torch.zeros((n, 3), dtype=torch.float64))
    return fn


def test_drift_kinetic_uniform_B():
    fields = _dk_fields([0.0, 0.0, 0.0], [0.0, 0.0, 2.0])
    dt = 0.05
    r = torch.zeros((1, 3), dtype=torch.float64)
    ppar, pperp = (torch.tensor([v], dtype=torch.float64) for v in (0.3, 0.2))
    mu = torch.tensor([1.0 * 0.2 ** 2 / (2 * 2.0)], dtype=torch.float64)
    for _ in range(50):
        res = pushers.drift_kinetic_push(dt, QM, 1.0, r, ppar, pperp, mu,
                                         fields)
        assert bool(res.converged.all())
        r, ppar, pperp = res.r, res.p_parallel, res.p_perp
    np.testing.assert_allclose(float(ppar[0]), 0.3, rtol=1e-12)
    np.testing.assert_allclose(float(pperp[0]), 0.2, rtol=1e-12)
    np.testing.assert_allclose(r[0].numpy(), [0.0, 0.0, 0.3 * 50 * dt],
                               atol=1e-10)


def test_drift_kinetic_exb_drift():
    fields = _dk_fields([0.05, 0.0, 0.0], [0.0, 0.0, 1.0])
    dt = 0.1
    r = torch.zeros((1, 3), dtype=torch.float64)
    ppar, pperp = (torch.tensor([v], dtype=torch.float64) for v in (0.0, 0.1))
    mu = torch.tensor([0.005], dtype=torch.float64)
    for _ in range(100):
        res = pushers.drift_kinetic_push(dt, QM, 1.0, r, ppar, pperp, mu,
                                         fields)
        r, ppar, pperp = res.r, res.p_parallel, res.p_perp
    np.testing.assert_allclose(r[0].numpy(), [0.0, -0.05 * 100 * dt, 0.0],
                               atol=1e-8)
