"""The port's ecsimcorr scheme and assembled mass route against the JAX
package, on the CPU, from the same numpy inputs.

* The assembled route's pieces (``ops/ecsim_blocks.py``: the s1 slot
  weights, the particle terms, the block assembly, the block apply and
  the slot-summed current deposit) against JAX in float64 to 1e-12, on
  periodic and ghosted bounds; the plain twin of the ``ecsim_fill``
  kernel in float32 against the Pallas kernel in interpret mode at the
  JAX suite's tolerance for it (``tests/test_pallas_ecsim.py``), and in
  float64 against JAX's einsum composition to 1e-12.
* ecsimcorr's own pieces: the Esirkepov deposit, the kinetic energy, the
  correct solve (equal CG iterations) and the renormalization, float64
  to 1e-12.
* The routes: one float32 fused step on the ``blocks`` route against the
  ``free`` route within 2e-6 (the analog of JAX's
  ``test_pallas_step_route_matches_xla``); ``XPIC_MASS`` read when the
  simulation is built; MatDump of the port's blocks against JAX's.
* The slice: ``python -m xpic_tpu_torch cfg.json --device cpu`` on an
  ecsimcorr config against ``python -m xpic_tpu cfg.json``, both float64
  (both assemble matL) with the reference's mt19937 load, 6^3 cells x 8
  particles per cell, 4 steps: every table column within 1e-10 of its
  scale (the work-bookkeeping columns CWD/PWD/LdK/WD included), the
  step-0 dumps byte for byte, equal predict and correct KSP histories,
  the consistency norm of every step within 1e-9 relative.  Both runs
  happen once, in one module fixture.
"""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xpic_tpu.schemes as jschemes
import xpic_tpu_torch.schemes as tschemes
from xpic_tpu.commands import particles_load as jload
from xpic_tpu.config import Geometry as JGeometry
from xpic_tpu.diagnostics import mat_dump as jmat
from xpic_tpu.ops import binning as jbin
from xpic_tpu.ops import ecsim_blocks as jeb
from xpic_tpu.ops import gather_scatter as jgs
from xpic_tpu.ops.pallas_ecsim import ecsim_fill_pallas
from xpic_tpu.runtime import cli as jcli
from xpic_tpu.schemes import ecsimcorr as jcorr
from xpic_tpu_torch import kernels
from xpic_tpu_torch.commands import particles_load as tload
from xpic_tpu_torch.config import Config
from xpic_tpu_torch.config import Geometry as TGeometry
from xpic_tpu_torch.convert import binned_from_numpy
from xpic_tpu_torch.diagnostics import mat_dump as tmat
from xpic_tpu_torch.diagnostics.compare import TABLES, read_table, table_errors
from xpic_tpu_torch.ops import binning as tbin
from xpic_tpu_torch.ops import ecsim_blocks as teb
from xpic_tpu_torch.ops import gather_scatter as tgs
from xpic_tpu_torch.ops.ecsim_kernel import ecsim_fill, ecsim_fill_plain
from xpic_tpu_torch.parallel import step as tstep
from xpic_tpu_torch.particles import ParticleArrays
from xpic_tpu_torch.runtime import cli as tcli
from xpic_tpu_torch.runtime import step_profile
from xpic_tpu_torch.schemes import build_simulation
from xpic_tpu_torch.schemes import ecsimcorr as tcorr

torch.set_num_threads(1)

GEOM_KW = dict(dx=0.5, dy=0.4, dz=0.6, dt=1.5, nx=6, ny=5, nz=4, nt=1)
BOUNDS = [("periodic",) * 3, ("ghosted", "periodic", "reflective")]
K = 16
FILL = dict(q=-1.0, m=1.0, mpw=0.125, dt=1.5)
STEPS = 4
DUMPS = ("E", "B")


def _t(a):
    return torch.tensor(np.asarray(a))


def _geoms(bounds=BOUNDS[0]):
    return JGeometry(**GEOM_KW, bounds=bounds), TGeometry(**GEOM_KW,
                                                          bounds=bounds)


def _slots(seed, G=6 * 5 * 4, dtype=np.float64):
    """Slot inputs t, v, B_p [G, K, 3] (|b| ~ 0.2) and valid [G, K]."""
    rng = np.random.default_rng(seed)
    t = rng.random((G, K, 3))
    v = 0.05 * rng.standard_normal((G, K, 3))
    B_p = 0.25 * rng.standard_normal((G, K, 3))
    valid = rng.random((G, K)) < 0.7
    return (t.astype(dtype), v.astype(dtype), B_p.astype(dtype), valid)


def _jax_fill(t, v, B_p, valid):
    """JAX's assembled fill in float64: the einsum composition of
    ``parallel/step.fill_phase``."""
    W = jeb.s1_slot_weights(jnp.asarray(t))
    I_p, M = jeb.ecsim_particle_terms(jnp.asarray(B_p), jnp.asarray(v),
                                      jnp.asarray(valid), **FILL)
    return (jeb.assemble_blocks(W, M), jnp.einsum("gkc,gkcs->gcs", I_p, W),
            W, I_p)


def _close(got, ref, tol=1e-12):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


# -- the slice: the config-driven run against the JAX package ---------------


def make_doc(out_dir, steps=STEPS, ppc=8):
    """6^3 cells, dt 1.5, periodic, electrons at T = 0.1 with ``ppc``
    particles per cell, a uniform B0 of 0.2 along z, the E and B dumps
    every step."""
    return {
        "Simulation": "ecsimcorr",
        "OutputDirectory": str(out_dir),
        "Geometry": {
            "x": 3.0, "y": 3.0, "z": 3.0, "t": steps * 1.5,
            "dx": 0.5, "dy": 0.5, "dz": 0.5, "dt": 1.5,
            "diagnose_period": 1.5,
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
            {"command": "SetMagneticField",
             "field": {"name": "SetUniformField", "value": [0.0, 0.0, 0.2]}},
        ],
        "Diagnostics": [{"diagnostic": "FieldView", "field": f}
                        for f in DUMPS],
    }


def _run(cli, schemes, root, argv):
    """``cli.main`` on :func:`make_doc` with the reference RNG; returns
    the output directory and the simulation it built, which records the
    correct solve's iterations and the consistency norm of every step."""
    cfg = root / "cfg.json"
    cfg.write_text(json.dumps(make_doc(root / "out")))
    built = []
    orig = schemes.build_simulation
    mp = pytest.MonkeyPatch()

    def capture(*args, **kwargs):
        sim = orig(*args, **kwargs)
        sync = sim._host_sync
        sim.corr_history, sim.norm_history = [], []

        def recorded():
            sync()
            sim.corr_history.append(sim.correct_ksp_iters)
            sim.norm_history.append(sim.current_consistency_norm)

        sim._host_sync = recorded
        built.append(sim)
        return sim

    mp.setattr(schemes, "build_simulation", capture)
    if schemes is jschemes:
        _compile_second_push_early(mp, built)
    mp.setenv("XPIC_RNG", "reference")
    try:
        assert cli.main([str(cfg), "--quiet", *argv]) == 0
    finally:
        mp.undo()
        jload.seed(5489)
        tload.seed(5489)
    return root / "out", built[0]


def _compile_second_push_early(mp, built):
    """Most of the JAX run is the XLA compile of its two Esirkepov jits,
    which it meets one after the other.  At the first half drift, compile
    the second push for the same shapes in a thread (XLA compiles without
    the GIL), and let the second push wait for it: the run then uses the
    executable the thread made.  Nothing the run computes changes.  The
    wait is bounded: past it, the second push compiles as it would
    without the thread."""
    half, second = jcorr._half_drift_deposit, jcorr._second_push_corr
    done = []

    def spec(a):
        return jax.ShapeDtypeStruct(a.shape, a.dtype,
                                    weak_type=a.aval.weak_type)

    def half_first(st, geom, alpha, mesh=None):
        sim = built[0]
        pr = sim.species[0].params
        args = (spec(sim.E), spec(sim.B), jax.tree.map(spec, st), geom,
                pr.qm, pr.q * pr.n_Np, alpha, mesh)
        thread = threading.Thread(
            target=lambda: second.lower(*args).compile(), daemon=True)
        thread.start()
        done.append(thread)
        mp.setattr(jcorr, "_half_drift_deposit", half)
        return half(st, geom, alpha, mesh)

    def second_first(*args):
        done[0].join(timeout=600)
        mp.setattr(jcorr, "_second_push_corr", second)
        return second(*args)

    mp.setattr(jcorr, "_half_drift_deposit", half_first)
    mp.setattr(jcorr, "_second_push_corr", second_first)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {name: _run(cli, schemes, tmp_path_factory.mktemp(name), argv)
            for name, cli, schemes, argv in (
                ("jax", jcli, jschemes, []),
                ("torch", tcli, tschemes, ["--device", "cpu"]))}


def test_cli_run_matches_jax(runs):
    """One test on purpose: the JAX run behind it is the expensive part,
    and one test keeps it on one worker of a parallel run."""
    (jout, jsim), (tout, tsim) = runs["jax"], runs["torch"]
    assert tsim.mass == "blocks" and tsim.dtype == torch.float64
    # Charge is conserved to rounding: its continuity norms are held
    # against the 2-norm of rho / dt (|q n| = 1 per cell).
    charge = np.sqrt(6 ** 3) / 1.5
    for table in TABLES:
        errs = table_errors(table, jout, tout, n_cells=6 ** 3,
                            charge_scale=charge)
        header, rows = read_table(tout / "temporal" / table)
        assert rows.shape[0] == STEPS + 1 and np.isfinite(rows).all()
        assert all(e <= 1e-10 for e in errs.values()), (table, errs)
        if table == "energy_conservation.txt":
            assert {"CWD_electrons", "PWD_electrons", "LdK_electrons",
                    "WD"} <= set(header)
    assert tsim.ksp_history == list(jsim.ksp_history)
    assert tsim.corr_history == jsim.corr_history
    assert len(tsim.ksp_history) == len(tsim.corr_history) == STEPS
    assert all(0 < it < 100 for it in tsim.ksp_history + tsim.corr_history)
    for a, b in zip(tsim.norm_history, jsim.norm_history):
        assert abs(a - b) <= 1e-9 * abs(b)
    assert 0.0 < tsim.current_consistency_norm < 0.1

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


# -- the assembled route's pieces ------------------------------------------


@pytest.mark.parametrize("bounds", BOUNDS, ids=lambda b: b[0])
@pytest.mark.parametrize("what", ["weights", "particle_terms", "assemble",
                                  "apply", "currI"])
def test_block_ops_match_jax_f64(what, bounds):
    jg, tg = _geoms(bounds)
    t, v, B_p, valid = _slots(0)
    if what == "weights":
        _close(teb.s1_slot_weights(_t(t)), jeb.s1_slot_weights(jnp.asarray(t)))
        return
    I_ref, M_ref = jeb.ecsim_particle_terms(
        jnp.asarray(B_p), jnp.asarray(v), jnp.asarray(valid), **FILL)
    I_got, M_got = teb.ecsim_particle_terms(_t(B_p), _t(v), _t(valid),
                                            **FILL)
    if what == "particle_terms":
        _close(I_got, I_ref)
        _close(M_got, M_ref)
        _close(teb.rotation_tensor(_t(B_p)),
               jeb.rotation_tensor(jnp.asarray(B_p)))
        return
    L_ref, _, W_ref, _ = _jax_fill(t, v, B_p, valid)
    L_got = teb.assemble_blocks(teb.s1_slot_weights(_t(t)), M_got)
    if what == "assemble":
        _close(L_got, L_ref)
        _close(teb.blocks_trace(L_got), jnp.einsum("gcici->", L_ref))
    elif what == "apply":
        x = np.random.default_rng(1).standard_normal((3,) + jg.shape)
        _close(teb.apply_blocks(L_got, _t(x), tg),
               jeb.apply_blocks(L_ref, jnp.asarray(x), jg))
    else:  # the assembled route's currI: slot sums, then 36 shifted adds
        _, Islot = ecsim_fill_plain(_t(t), _t(v), _t(B_p), _t(valid), **FILL)
        _close(teb.deposit_slot_sums(Islot, tg),
               jeb.deposit_slots(I_ref, W_ref, jg))


def test_fill_twin_matches_jax_einsum_f64():
    t, v, B_p, valid = _slots(2)
    L_ref, I_ref, _, _ = _jax_fill(t, v, B_p, valid)
    L, Islot = ecsim_fill(_t(t), _t(v), _t(B_p), _t(valid), **FILL)
    assert L.dtype == Islot.dtype == torch.float64
    _close(L, L_ref)
    _close(Islot, I_ref)


def test_fill_twin_matches_pallas_kernel_f32():
    """The twin in float32 against ``ecsim_fill_pallas`` (interpret
    mode), the TPU kernel K7 replaces, at the JAX suite's tolerance."""
    t, v, B_p, valid = _slots(3, G=64, dtype=np.float32)
    L_ref, I_ref = ecsim_fill_pallas(
        jnp.asarray(t), jnp.asarray(v), jnp.asarray(B_p), jnp.asarray(valid),
        **FILL, interpret=True)
    L, Islot = ecsim_fill_plain(_t(t), _t(v), _t(B_p), _t(valid), **FILL)
    assert L.dtype == Islot.dtype == torch.float32
    for got, ref in ((L, L_ref), (Islot, I_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                                   atol=2e-6)


def test_fill_wrapper_cpu_counts_no_launch_and_others_raise():
    t, v, B_p, valid = (_t(a) for a in _slots(4, G=8, dtype=np.float32))
    kernels.reset_counts()
    ecsim_fill(t, v, B_p, valid, **FILL)
    assert kernels.LAUNCHES["ecsim_fill"] == 0
    with pytest.raises(RuntimeError, match="unsupported device"):
        ecsim_fill(t.to("meta"), v.to("meta"), B_p.to("meta"),
                   valid.to("meta"), **FILL)


@pytest.mark.parametrize("bounds", BOUNDS, ids=lambda b: b[0])
def test_esirkepov_current_matches_jax_f64(bounds):
    """Moves of up to 0.6 cell a axis, a third of the slots invalid."""
    jg, tg = _geoms(bounds)
    rng = np.random.default_rng(5)
    t0 = rng.random((jg.n_cells, K, 3))
    tn = t0 + rng.uniform(-0.6, 0.6, t0.shape)
    valid = rng.random(t0.shape[:2]) < 0.67
    ref = jgs.esirkepov_current(jnp.asarray(t0), jnp.asarray(tn),
                                jnp.asarray(valid), -0.3, jg)
    _close(tgs.esirkepov_current(_t(t0), _t(tn), _t(valid), -0.3, tg), ref)


def _binned(seed, geom, slots=8):
    rng = np.random.default_rng(seed)
    G = geom.n_cells
    cells = np.stack(np.unravel_index(np.arange(G), geom.shape)[::-1], -1)
    r = cells[:, None, :] + rng.random((G, slots, 3))
    p = 0.05 * rng.standard_normal((G, slots, 3))
    valid = rng.random((G, slots)) < 0.6
    return r, p, valid


def test_kinetic_energy_state_matches_jax():
    jg, tg = _geoms()
    r, p, valid = _binned(6, jg)
    ref = jbin.kinetic_energy_state(
        jbin.BinnedState(r=jnp.asarray(r), p=jnp.asarray(p),
                         valid=jnp.asarray(valid)), 0.25)
    got = tbin.kinetic_energy_state(binned_from_numpy(r, p, valid,
                                                      device="cpu"), 0.25)
    assert abs(float(got) - float(ref)) <= 1e-12 * abs(float(ref))


def _fields(seed, geom, scale=1e-2):
    rng = np.random.default_rng(seed)
    return [scale * rng.standard_normal((3,) + geom.shape) for _ in range(4)]


def test_correct_fields_matches_jax():
    """CG on matM with the Chebyshev preconditioner at shift 0: equal
    iteration counts, Ec to 1e-12."""
    jg, tg = _geoms()
    E, B, B0, J = _fields(7, jg)
    Ej, itj, rj, okj = jcorr._correct_fields(
        *(jnp.asarray(a) for a in (E, B, B0, J)), jg)
    Et, itt, rt, okt = tcorr._correct_fields(*(_t(a) for a in (E, B, B0, J)),
                                             tg)
    assert bool(okj) and okt
    assert int(itt) == int(itj) > 1
    _close(Et, Ej)
    assert abs(float(rt) - float(rj)) <= 1e-6 * float(rj)


def test_renormalize_matches_jax():
    jg, tg = _geoms()
    r, p, valid = _binned(8, jg)
    _, _, J, Ec = _fields(9, jg, scale=1e-3)
    pred_w, m_mpw = 2.5e-7, 0.5
    K0 = 0.98 * float(jbin.kinetic_energy_state(
        jbin.BinnedState(r=jnp.asarray(r), p=jnp.asarray(p),
                         valid=jnp.asarray(valid)), m_mpw))
    jst = jbin.BinnedState(r=jnp.asarray(r), p=jnp.asarray(p),
                           valid=jnp.asarray(valid))
    jst2, jstats = jcorr._renormalize(jst, jnp.asarray(J), jnp.asarray(Ec),
                                      jnp.asarray(pred_w), jnp.asarray(K0),
                                      jg, m_mpw)
    tst2, tstats = tcorr._renormalize(
        binned_from_numpy(r, p, valid, device="cpu"), _t(J), _t(Ec),
        torch.tensor(pred_w, dtype=torch.float64),
        torch.tensor(K0, dtype=torch.float64), tg, m_mpw)
    for got, ref in zip(tstats.numpy(), np.asarray(jstats)):
        assert abs(got - ref) <= 1e-12 * abs(ref)
    _close(tst2.p, jst2.p)


# -- the two mass routes ------------------------------------------------------


def _step_inputs(dtype):
    geom = TGeometry(dx=0.5, dy=0.5, dz=0.5, dt=1.5, nx=6, ny=6, nz=6, nt=1)
    rng = np.random.default_rng(3)
    n = geom.n_cells * 5
    r = rng.random((n, 3)) * np.array(geom.L)
    p = rng.standard_normal((n, 3)) * 0.02
    shape = (3,) + geom.shape

    def f(a):
        return torch.tensor(a, dtype=dtype)

    E, B = (f(rng.standard_normal(shape) * 1e-3) for _ in range(2))
    sp = ParticleArrays(r=f(r), p=f(p), alive=torch.ones(n, dtype=bool))
    return geom, E, B, torch.zeros_like(E), tbin.bin_state(sp, geom, 16)


def test_blocks_route_matches_free_route_f32():
    """One float32 fused step: the assembled route (L blocks, the
    ``ecsim_fill`` twin) and the matrix-free route agree within 2e-6."""
    geom, E, B, B0, st = _step_inputs(torch.float32)
    args = dict(geom=geom, q=-1.0, m=1.0, mpw=0.2, maxit=50)
    outs = {mass: tstep.ecsim_step_binned(E, B, B0, st, mass=mass, **args)
            for mass in ("free", "blocks")}
    (E1, B1, st1, c1, it1), (E2, B2, st2, c2, it2) = (outs["free"],
                                                      outs["blocks"])
    for a, b in ((E2, E1), (B2, B1), (c2, c1), (st2.p, st1.p)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2e-6)
    assert it1 == it2


@pytest.mark.parametrize("env,dtype,route", [
    (None, torch.float32, "free"), ("free", torch.float32, "free"),
    ("blocks", torch.float32, "blocks"), (None, torch.float64, "blocks"),
    ("free", torch.float64, "blocks")])
def test_mass_route_follows_xpic_mass(tmp_path, monkeypatch, env, dtype,
                                      route):
    """JAX's rule, read when the simulation is built: ``free`` only for
    float32 under XPIC_MASS=free (the default)."""
    if env is None:
        monkeypatch.delenv("XPIC_MASS", raising=False)
    else:
        monkeypatch.setenv("XPIC_MASS", env)
    assert tstep.mass_route(dtype) == route
    cfg = Config.from_json(make_doc(tmp_path / "out"))
    assert build_simulation(cfg, device="cpu", dtype=dtype).mass == route
    other = "blocks" if route == "free" else "free"
    if dtype == torch.float32:  # an explicit argument wins over the env
        assert build_simulation(cfg, device="cpu", dtype=dtype,
                                mass=other).mass == other


def test_bad_xpic_mass_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("XPIC_MASS", "dense")
    cfg = Config.from_json(make_doc(tmp_path / "out"))
    with pytest.raises(ValueError, match="XPIC_MASS"):
        build_simulation(cfg, device="cpu")
    with pytest.raises(ValueError, match="'sparse'"):
        tstep.mass_route(torch.float32, "sparse")


def test_mat_dump_round_trip_against_jax(tmp_path):
    """The port's blocks dumped by the port's MatDump and compared by
    JAX's, and the other way round; a perturbed block fails."""
    t, v, B_p, valid = _slots(10)
    L_ref = _jax_fill(t, v, B_p, valid)[0]
    L, _ = ecsim_fill(_t(t), _t(v), _t(B_p), _t(valid), **FILL)
    tmat.dump(str(tmp_path / "port.npy"), L)
    jmat.dump(str(tmp_path / "jax.npy"), L_ref)
    assert jmat.compare(str(tmp_path / "port.npy"), L_ref)
    assert tmat.compare(str(tmp_path / "jax.npy"), L)
    assert tmat.compare(str(tmp_path / "port.npy"), tmat.load(
        str(tmp_path / "jax.npy")))
    L[5, 1, 2, 0, 3] += 1e-6 * float(L.abs().max())
    assert not tmat.compare(str(tmp_path / "jax.npy"), L)


# -- port-only checks -------------------------------------------------------


@pytest.mark.parametrize("mass", ["free", "blocks"])
def test_step_profile_times_every_ecsimcorr_phase(tmp_path, monkeypatch,
                                                 mass):
    """The ecsimcorr breakdown on the CPU in float32, on either route:
    every phase (``correct_fields`` included) and the Esirkepov deposit
    timed; the fill kernel's part only on the ``blocks`` route.  The
    profiler window (held by ``test_torch_cli``) just runs its steps."""
    monkeypatch.setenv("XPIC_X64", "0")

    def window(fns, device, after=None):
        for i, fn in enumerate(fns):
            fn()
            after(i)
        return {"runs": len(fns)}

    monkeypatch.setattr(step_profile, "device_window", window)
    tload.seed(561)
    sim = build_simulation(Config.from_json(
        make_doc(tmp_path / "out", steps=3, ppc=4)), device="cpu", mass=mass)
    out = step_profile.profile_run(sim)
    tload.seed(5489)
    assert out["mass"] == mass
    assert set(out["phases_ms"]) == set(step_profile.ECSIMCORR_PHASES)
    assert out["parts_ms"]["esirkepov_current"] > 0
    assert (out["parts_ms"]["ecsim_fill"] > 0) == (mass == "blocks")
    assert 0 < out["correct_ksp_iters"] < 100
    assert 0 < out["consistency_norm"] < 0.1
    assert out["window"]["runs"] == step_profile.WINDOW
