"""The port's ecsimcorr, ``basic`` and eccapfim schemes, and the step
presets and diagnostics they drive, over two ``torch.distributed`` ranks
(gloo, CPU), one z slab each, against the one-rank port and the JAX
package.

One fixture, built once a test run (``torch_shared_fixture.build_once``),
runs each config once on one rank (in this process) and once with
``"Mesh": 2`` in two ranks of one group (``torch_mesh_worker.
run_schemes``: the CLI in each rank, then the eccapfim slab checks):

* ``basic``: ``test_torch_basic.make_doc`` (6^3 x 8 ppc, 4 steps, the
  velocity distribution and LogView) without its backup;
* ``ecsimcorr-blocks``: ``test_torch_ecsimcorr.make_doc`` in float64
  (the assembled mass route) and ``ecsimcorr-free``: the same in float32
  on the matrix-free route, which only float32 takes;
* ``eccapfim``: ``test_torch_eccapfim.make_doc`` (6^3 x 8 ppc, 2 steps);
* ``commands``: ``test_torch_commands.base_doc`` (``basic``, 8 x 8 x 10,
  two species) with InjectParticles, RemoveParticles, a box
  FieldsDamping across both slabs, VelocityDistribution, LogView, a
  DistributionMoment region across both slabs and the E dumps.

The slabs of the 6^3 configs are 3 planes thick, the fewest the width-6
windows take (2 ghost planes below, 3 above).  The JAX runs are
``test_torch_basic``'s, ``test_torch_ecsimcorr``'s and
``test_torch_eccapfim``'s (built once a run, whichever file asks first).

Bars: in float64 the tables within 1e-11 absolute of the one-rank run
(the JAX suite's multi-device bar, ``tests/test_multichip.py:108``; the
energy table's standard deviations as ``diagnostics.compare`` holds
them) and within 1e-10 of each column's scale of the JAX run; in float32
within 1e-4 of each column's scale of the one-rank run (the bar of
``chip_smoke.py`` phase 19).  The solvers' iteration histories equal;
no particle dropped.  The slab ops: the window blocks and K6's twin
bitwise, the block scatter within 1e-14 of the largest value, the split
Anderson solve with equal iterations and its solution within 1e-12; an
eccapfim step whose fast-path guard trips on one rank only is redone on
the general path by both ranks, as one rank redoes it.
"""

import json
import os

import numpy as np
import pytest
import torch

from xpic_tpu.commands import particles_load as jload
from xpic_tpu_torch.commands import particles_load as tload
from xpic_tpu_torch.config import Config
from xpic_tpu_torch.diagnostics.compare import TABLES, read_table, table_errors
from xpic_tpu_torch.schemes import build_simulation

import test_torch_basic as TB
import test_torch_commands as TC
import test_torch_eccapfim as TF
import test_torch_ecsimcorr as TE
import torch_mesh_worker as W
from torch_shared_fixture import build_once, load_sims

torch.set_num_threads(1)

TABLE_ATOL, F32_TOL, JAX_TOL = 1e-11, 1e-4, 1e-10
SCATTER_TOL, ANDERSON_TOL = 1e-14, 1e-12
CMD_STEPS = 3
# The solver histories a rank's report holds where the scheme has them.
HISTORIES = ("ksp_history", "correct_ksp_history", "outer_history",
             "fallback_history")


def basic_doc(out):
    doc = TB.make_doc(out)
    del doc["SimulationBackup"]
    return doc


def commands_doc(out):
    doc = TC.base_doc(out, nt=CMD_STEPS)
    doc["StepPresets"] = [
        {"command": "InjectParticles", "ionized": "ions",
         "ejected": "electrons", "per_step_particles_num": 20,
         "coordinate": {"name": "CoordinateInCylinder", "radius": 0.5,
                        "height": 2.0},
         "momentum_i": {"name": "MaxwellianMomentum"},
         "momentum_e": {"name": "MaxwellianMomentum"}},
        {"command": "RemoveParticles", "particles": "electrons",
         "geometry": {"name": "CylinderGeometry", "radius": 1.8}},
        {"command": "FieldsDamping",
         "geometry": {"name": "BoxGeometry", "min": [0.5, 0.5, 1.0],
                      "max": [3.5, 3.5, 4.0], "coefficient": 0.8}},
    ]
    doc["Diagnostics"] = [
        {"diagnostic": "VelocityDistribution", "particles": "electrons",
         "projection": "vx_vy", "vmin": [-0.1, -0.1], "vmax": [0.1, 0.1],
         "dv": [0.01, 0.01]},
        {"diagnostic": "LogView", "level": "EachTimestep"},
        {"diagnostic": "DistributionMoment", "particles": "electrons",
         "moment": "density",
         "region": {"start": [0.5, 1.0, 1.5], "size": [2.0, 2.0, 2.5],
                    "suffix": "box"}},
        {"diagnostic": "FieldView", "field": "E"},
    ]
    return doc


# case: (config, environment, its dumps)
JOBS = {
    "basic": (basic_doc, {}, TB.DUMPS),
    "ecsimcorr-blocks": (TE.make_doc, {}, TE.DUMPS),
    "ecsimcorr-free": (TE.make_doc, {"XPIC_X64": "0", "XPIC_MASS": "free"},
                       TE.DUMPS),
    "eccapfim": (TF.make_doc, {}, TF.DUMPS),
    "commands": (commands_doc, {},
                 ("E", os.path.join("electrons", "vx_vy"),
                  os.path.join("electrons", "density_box"))),
}
# The charge-continuity floor of each config: the 2-norm of rho / dt.
CHARGE = {"basic": TB.CHARGE_SCALE, "ecsimcorr": np.sqrt(6 ** 3) / 1.5,
          "eccapfim": np.sqrt(6 ** 3) / 1.0}


def _build(root):
    for name, (doc, env, _) in JOBS.items():
        for sub, extra in (("one", {}), ("", {"Mesh": W.WORLD})):
            work = root / name / sub
            work.mkdir(parents=True, exist_ok=True)
            (work / "cfg.json").write_text(json.dumps(
                dict(doc(work / "out"), **extra)))
        try:
            W.run_cli(str(root / name / "one" / "cfg.json"), env,
                      str(root / name / "one" / "report.json"))
        finally:
            jload.seed(5489)
            tload.seed(5489)
    W.run_schemes(root, [(name, env) for name, (_, env, _) in JOBS.items()],
                  TF.make_doc(root / "unused"))


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    root = build_once(tmp_path_factory, "torch_mesh_scheme_runs", _build)
    runs = {}
    for name in JOBS:
        work = root / name
        runs[name] = {
            "one": work / "one" / "out", "two": work / "out",
            "ref": json.loads((work / "one" / "report.json").read_text()),
            "reports": [json.loads((work / f"report.json.rank{r}")
                                   .read_text()) for r in range(W.WORLD)]}
    ops = root / "ops"
    runs["ops"] = (dict(np.load(ops / "whole.npz")),
                   [dict(np.load(ops / f"rank{r}.npz"))
                    for r in range(W.WORLD)])
    return runs


def _hold_tables(one, two, n_cells, f32=False, charge=0.0):
    """Every table of the two-rank run against the one-rank run's:
    float64 within 1e-11 absolute (the s columns of the energy table as
    ``diagnostics.compare`` holds them), float32 within 1e-4 of each
    column's scale."""
    for table in TABLES:
        h1, rows1 = read_table(one / "temporal" / table)
        h2, rows2 = read_table(two / "temporal" / table)
        assert h1 == h2 and rows1.shape == rows2.shape, table
        assert np.isfinite(rows2).all(), table
        errs = table_errors(table, one, two, n_cells=n_cells,
                            charge_scale=charge)
        if f32:
            assert all(e <= F32_TOL for e in errs.values()), (table, errs)
            continue
        plain = [i for i, h in enumerate(h1)
                 if not (table == "energy.txt" and h.startswith("s"))]
        np.testing.assert_allclose(rows2[:, plain], rows1[:, plain], rtol=0,
                                   atol=TABLE_ATOL, err_msg=table)
        s_cols = {k: e for k, e in errs.items()
                  if table == "energy.txt" and k.startswith("s")}
        assert all(e <= TABLE_ATOL for e in s_cols.values()), s_cols


def _hold_dumps(one, two, dumps, tol):
    """Rank 0 writes the whole grid's files: step 0 byte for byte, later
    steps within ``tol`` of the largest value."""
    for dump in dumps:
        names = sorted(os.listdir(one / dump))
        assert sorted(os.listdir(two / dump)) == names and names, dump
        assert (two / dump / names[0]).read_bytes() == \
            (one / dump / names[0]).read_bytes(), dump
        for name in names[1:]:
            a = np.fromfile(two / dump / name, dtype=np.float32)
            b = np.fromfile(one / dump / name, dtype=np.float32)
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-30)


def _hold_convergence(one, two):
    """eccapfim's ConvergenceHistory: equal Time, Crank-Nicolson and
    outer iteration columns; the residual histories to the table's
    printed precision (1e-6 of each row's first entry)."""
    with open(one / "temporal" / "convergence_history.txt") as f1, \
            open(two / "temporal" / "convergence_history.txt") as f2:
        r1, r2 = f1.read().splitlines(), f2.read().splitlines()
    assert r1[0] == r2[0] and len(r1) == len(r2) > 1
    for a, b in zip(r1[1:], r2[1:]):
        a, b = a.split(), b.split()
        assert a[:3] == b[:3]
        ha, hb = np.array(a[3:], float), np.array(b[3:], float)
        assert ha.shape == hb.shape and np.abs(ha - hb).max() <= 1e-6 * ha[0]


@pytest.mark.parametrize("case", ["basic", "ecsimcorr-free",
                                  "ecsimcorr-blocks", "eccapfim"])
def test_tables_match_one_rank(mesh_runs, case):
    """Two ranks against the port's one-rank run of the same config:
    every table and dump, the solvers' iteration histories on both
    ranks, every particle kept; each rank reports gloo and its share of
    the exchange."""
    run = mesh_runs[case]
    f32 = case == "ecsimcorr-free"
    scheme = case.split("-")[0]
    _hold_tables(run["one"], run["two"], 6 ** 3, f32, CHARGE[scheme])
    _hold_dumps(run["one"], run["two"], JOBS[case][2],
                F32_TOL if f32 else TABLE_ATOL)
    if scheme == "eccapfim":
        _hold_convergence(run["one"], run["two"])
    ref = run["ref"]
    assert ref["dtype"] == ("float32" if f32 else "float64")
    for rank, rep in enumerate(run["reports"]):
        assert rep["rank"] == rank and rep["world"] == W.WORLD
        assert rep["backend"] == "gloo" and rep["dtype"] == ref["dtype"]
        held = [k for k in HISTORIES if k in ref]
        assert held and all(rep[k] == ref[k] for k in held), rep
        if scheme == "ecsimcorr":
            np.testing.assert_allclose(rep["consistency_history"],
                                       ref["consistency_history"],
                                       rtol=1e-5 if f32 else 1e-12)
        assert rep["count"] == ref["count"]
        assert rep["mesh"]["calls"]["halo_pad"] > 0
        assert rep["mesh"]["calls"]["halo_fold"] > 0


def _jax_runs(tmp_path_factory, scheme):
    """The JAX package's one-device run of the scheme's config (the
    output directory) and the solver histories its file keeps."""
    if scheme == "basic":
        root = build_once(tmp_path_factory, "torch_basic_runs",
                          TB._build_runs)
        return root / "jax" / "out", {}
    module, name = {"ecsimcorr": (TE, "torch_ecsimcorr_runs"),
                    "eccapfim": (TF, "torch_eccapfim_runs")}[scheme]
    root = build_once(tmp_path_factory, name, module._build_runs)
    return root / "jax" / "out", vars(load_sims(root / "sims.json")["jax"])


@pytest.mark.parametrize("scheme", ["basic", "ecsimcorr", "eccapfim"])
def test_tables_match_jax(mesh_runs, tmp_path_factory, scheme):
    """Two ranks against the JAX package's one-device run (both
    reference multi-device tests of ecsimcorr and eccapfim fail, ROADMAP
    C): every column within 1e-10 of its scale, and the same solver
    iterations."""
    case = "ecsimcorr-blocks" if scheme == "ecsimcorr" else scheme
    two = mesh_runs[case]["two"]
    jout, jsim = _jax_runs(tmp_path_factory, scheme)
    for table in TABLES:
        errs = table_errors(table, jout, two, n_cells=6 ** 3,
                            charge_scale=CHARGE[scheme])
        assert all(e <= JAX_TOL for e in errs.values()), (table, errs)
    for rep in mesh_runs[case]["reports"]:
        if scheme == "ecsimcorr":
            assert rep["ksp_history"] == jsim["ksp_history"]
            assert rep["correct_ksp_history"] == jsim["corr_history"]
        if scheme == "eccapfim":
            with open(jout / "temporal" / "convergence_history.txt") as fh:
                rows = fh.read().splitlines()[1:]
            assert rep["outer_history"] == [int(r.split()[2]) for r in rows]


def test_commands_match_one_rank(mesh_runs):
    """InjectParticles, RemoveParticles and a box FieldsDamping across
    both slabs, with VelocityDistribution, LogView, a DistributionMoment
    region and the E dumps, over two ranks: the tables (their source and
    sink columns included) within 1e-11, every file byte for byte at
    step 0 and within 1e-11 of the largest value after, the same counts
    and the same LogView table."""
    run = mesh_runs["commands"]
    one, two = run["one"], run["two"]
    _hold_tables(one, two, 8 * 8 * 10)
    _hold_dumps(one, two, JOBS["commands"][2], TABLE_ATOL)
    h, rows = read_table(two / "temporal" / "energy_conservation.txt")
    for col in ("Inj_ions", "Inj_electrons", "Rm_electrons", "Damped(E+B)"):
        assert np.abs(rows[:, h.index(col)]).max() > 0, col
    assert rows.shape[0] == CMD_STEPS + 1
    h1, rows1 = read_table(one / "temporal" / "log_EachTimestep.txt")
    h2, rows2 = read_table(two / "temporal" / "log_EachTimestep.txt")
    assert h1 == h2 and rows1.shape == rows2.shape
    n = run["ref"]["count"]
    assert n[1] == 20 * CMD_STEPS and 0 < n[0] < 8 * 8 * 10 * 10
    assert all(rep["count"] == n for rep in run["reports"])


def _joined(ranks, key, axis):
    return np.concatenate([r[key] for r in ranks], axis=axis)


def test_window_ops_on_slabs(mesh_runs):
    """eccapfim's window pieces on each slab of a periodic and a ghosted
    z bound: the [G, 3, 6, 6, 6] window blocks (2 ghost planes below, 3
    above) and K6's twin on them are the whole grid's rows, bit for bit;
    the block scatter folds its ghost planes within 1e-14 of the largest
    value (and drops those beyond a ghosted bound)."""
    whole, ranks = mesh_runs["ops"]
    for z_bound in ("periodic", "ghosted"):
        for part in ("E", "B", "K6E", "K6B"):
            key = f"windows_{part}_{z_bound}"
            np.testing.assert_array_equal(_joined(ranks, key, 0),
                                          whole[key])
        key = f"scatter_{z_bound}"
        got, ref = _joined(ranks, key, -3), whole[key]
        assert np.abs(got - ref).max() <= SCATTER_TOL * np.abs(ref).max()


def test_anderson_split(mesh_runs):
    """The Anderson solve of a nonlinear curl-curl system split over two
    slabs (its norms and Gram products reduced in one all-reduce an
    iteration): the whole grid's iterations, its residual history within
    1e-12 of the first entry and its solution within 1e-12 of the
    largest value."""
    whole, ranks = mesh_runs["ops"]
    assert bool(whole["anderson_converged"]) and whole["anderson_iters"] > 2
    for r in ranks:
        assert int(r["anderson_iters"]) == int(whole["anderson_iters"])
        h, ref = r["anderson_history"], whole["anderson_history"]
        assert h.shape == ref.shape
        assert np.abs(h - ref).max() <= ANDERSON_TOL * ref[0]
    got, ref = _joined(ranks, "anderson_x", -3), whole["anderson_x"]
    assert np.abs(got - ref).max() <= ANDERSON_TOL * np.abs(ref).max()


def test_eccapfim_fallback_on_one_rank(mesh_runs):
    """The fast path's guard trips on rank 0 alone (a row overflows its
    one crosser column; rank 1 takes the general path from the start):
    both ranks redo the step on the general path together, and the step
    is the one-rank step that tripped the same guard: the same outer
    iterations, E within 1e-12 of its largest value."""
    whole, ranks = mesh_runs["ops"]
    assert whole["fallback_history"].tolist() == [True]
    for r in ranks:
        assert r["fallback_history"].tolist() == [True]
        np.testing.assert_array_equal(r["fallback_outer"],
                                      whole["fallback_outer"])
    got, ref = _joined(ranks, "fallback_E", -3), whole["fallback_E"]
    assert np.abs(got - ref).max() <= ANDERSON_TOL * np.abs(ref).max()


def test_thin_slab_is_refused(tmp_path):
    """A slab thinner than the ghost planes the scheme reads across a
    slab face is refused when the simulation is built, before any rank
    joins: 2 planes under the width-6 windows of basic, ecsimcorr and
    eccapfim, 1 under ECSIM's charge deposit."""
    for doc, mesh in ((TB.make_doc, 3), (TE.make_doc, 3), (TF.make_doc, 3),
                      (TE.make_doc, 6)):
        d = dict(doc(tmp_path / "out"), Mesh=mesh)
        d.pop("SimulationBackup", None)
        if mesh == 6:
            d["Simulation"] = "ecsim"
        with pytest.raises(ValueError, match="thinner than the"):
            build_simulation(Config.from_json(d), device="cpu")
