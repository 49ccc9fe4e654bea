"""The port's explicit ``basic`` scheme, its Boris variants and its
VelocityDistribution, LogView and SimulationBackup diagnostics against
the JAX package, on the CPU in float64.

One JAX CLI run and one port CLI run of ``basic`` (``python -m xpic_tpu
cfg.json`` and ``python -m xpic_tpu_torch cfg.json --device cpu``) from
the same config with the reference's mt19937 particle load
(``XPIC_RNG=reference``): 6^3 cells of 0.05, dt 0.025, 8 electrons per
cell at T = 0.1 keV, 4 steps, E, B and the vx-vy velocity histogram
dumped every step, a LogView table at ``EachTimestep`` and a backup every
2 steps.  Both runs are built once per test run
(``torch_shared_fixture.build_once``); the JAX run is compile-bound.

* Every table column within 1e-10 of its scale
  (``diagnostics.compare``; the charge continuity norms, rounding noise
  of an exact conservation, against the 2-norm of rho / dt); the step-0
  dumps byte for byte, later dumps within 1e-6 of their largest value.
* The two backup directories hold the same files of the same sizes,
  fields within 1e-12 and particle sets (sorted) within 1e-12; each
  package loads the other's backup to the bytes written.
* The port's run alone against ``tests/test_basic_scheme.py``'s bounds;
  a port restart from its step-2 backup against its uninterrupted run.
"""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xpic_tpu.schemes as jschemes
import xpic_tpu_torch.schemes as tschemes
from xpic_tpu import particles as jparticles
from xpic_tpu import pushers as jpushers
from xpic_tpu.commands import particles_load as jload
from xpic_tpu.config import Config as JConfig
from xpic_tpu.diagnostics import simulation_backup as jbackup
from xpic_tpu.runtime import cli as jcli
from xpic_tpu.schemes.base import Species as JSpecies
from xpic_tpu_torch import particles as tparticles
from xpic_tpu_torch import pushers as tpushers
from xpic_tpu_torch.commands import particles_load as tload
from xpic_tpu_torch.config import Config as TConfig
from xpic_tpu_torch.diagnostics import simulation_backup as tbackup
from xpic_tpu_torch.diagnostics.compare import TABLES, read_table, table_errors
from xpic_tpu_torch.runtime import cli as tcli
from xpic_tpu_torch.schemes.base import Species as TSpecies

from torch_shared_fixture import build_once

torch.set_num_threads(1)

STEPS, SIDE, DT = 4, 6, 0.025
N_CELLS = SIDE ** 3
# Charge is conserved to rounding: its norms against the 2-norm of
# rho / dt (|q n| = 1 a cell).
CHARGE_SCALE = np.sqrt(N_CELLS) / DT
DUMPS = ("E", "B", os.path.join("electrons", "vx_vy"))
BACKUP_STEPS = (2, 4)


def make_doc(out_dir, load_from=None):
    doc = {
        "Simulation": "basic",
        "OutputDirectory": str(out_dir),
        "Geometry": {
            "x": SIDE * 0.05, "y": SIDE * 0.05, "z": SIDE * 0.05,
            "t": STEPS * DT, "dx": 0.05, "dy": 0.05, "dz": 0.05, "dt": DT,
            "diagnose_period": DT,
        },
        "Particles": [{"sort_name": "electrons", "Np": 8, "n": 1.0,
                       "q": -1.0, "m": 1.0, "T": 0.1}],
        "Presets": [
            {"command": "SetParticles", "particles": "electrons",
             "coordinate": {"name": "CoordinateInBox"},
             "momentum": {"name": "MaxwellianMomentum", "tov": True}},
        ],
        "Diagnostics": [
            {"diagnostic": "FieldView", "field": "E"},
            {"diagnostic": "FieldView", "field": "B"},
            {"diagnostic": "VelocityDistribution", "particles": "electrons",
             "projection": "vx_vy", "vmin": [-0.05, -0.05],
             "vmax": [0.05, 0.05], "dv": [0.005, 0.005]},
            {"diagnostic": "LogView", "level": "EachTimestep"},
        ],
        "SimulationBackup": {"diagnose_period": 2 * DT},
    }
    if load_from is not None:
        # The loaded backup holds the particles and B0.
        doc["Presets"] = []
        doc["SimulationBackup"]["load_from"] = load_from
    return doc


def _run(cli, schemes, cfg_path, argv):
    """``cli.main`` on ``cfg_path`` with the reference RNG; returns the
    live particle count before and after the main loop."""
    counts = []
    mp = pytest.MonkeyPatch()
    orig = schemes.build_simulation

    def capture(*args, **kwargs):
        sim = orig(*args, **kwargs)
        calculate = sim.calculate

        def counted():
            counts.append(sim.species[0].count())
            calculate()
            counts.append(sim.species[0].count())

        sim.calculate = counted
        return sim

    mp.setattr(schemes, "build_simulation", capture)
    mp.setenv("XPIC_RNG", "reference")
    try:
        assert cli.main([str(cfg_path), "--quiet", *argv]) == 0
    finally:
        mp.undo()
        jload.seed(5489)
        tload.seed(5489)
    return counts


def _build_runs(root):
    counts = {}
    for name, cli, schemes, argv in (
            ("jax", jcli, jschemes, []),
            ("torch", tcli, tschemes, ["--device", "cpu"])):
        (root / name).mkdir()
        cfg = root / name / "cfg.json"
        cfg.write_text(json.dumps(make_doc(root / name / "out")))
        counts[name] = _run(cli, schemes, cfg, argv)
    (root / "counts.json").write_text(json.dumps(counts))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Built once per test run, whatever the number of xdist workers."""
    root = build_once(tmp_path_factory, "torch_basic_runs", _build_runs)
    counts = json.loads((root / "counts.json").read_text())
    return {name: (root / name / "out", counts[name]) for name in counts}


@pytest.mark.parametrize("table", TABLES)
def test_tables_match(runs, table):
    (jout, _), (tout, _) = runs["jax"], runs["torch"]
    errs = table_errors(table, jout, tout, n_cells=N_CELLS,
                        charge_scale=CHARGE_SCALE)
    _, rows = read_table(tout / "temporal" / table)
    assert rows.shape[0] == STEPS + 1 and np.isfinite(rows).all()
    assert all(e <= 1e-10 for e in errs.values()), errs


@pytest.mark.parametrize("dump", DUMPS)
def test_dumps_match(runs, dump):
    """Step 0 byte for byte; later steps to 1e-6 of the largest value
    (float32 files of float64 values that agree to rounding)."""
    (jout, _), (tout, _) = runs["jax"], runs["torch"]
    names = sorted(os.listdir(jout / dump))
    assert sorted(os.listdir(tout / dump)) == names
    assert len(names) == STEPS + 1
    assert (tout / dump / names[0]).read_bytes() == \
        (jout / dump / names[0]).read_bytes()
    for name in names[1:]:
        a = np.fromfile(tout / dump / name, dtype=np.float32)
        b = np.fromfile(jout / dump / name, dtype=np.float32)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-6 * max(np.abs(b).max(), 1e-30)


def _records(d, name="electrons"):
    """A backup's particle records [N, 6], sorted row-wise."""
    rec = np.fromfile(d / name, dtype=np.float64).reshape(-1, 6)
    return rec[np.lexsort(rec.T[::-1])]


def _files(d):
    """A backup's files and their sizes; the LogView table's size is
    that of wall-clock times as text, so it has none."""
    return sorted((str(p.relative_to(d)),
                   None if p.name.startswith("log_") else p.stat().st_size)
                  for p in d.rglob("*") if p.is_file())


def test_backups_match(runs):
    """The rolling window keeps steps 2 and 4 in both; the same files of
    the same sizes (but the LogView table's); fields and particle sets
    within 1e-12."""
    (jout, _), (tout, _) = runs["jax"], runs["torch"]
    jb, tb = jout / "simulation_backup", tout / "simulation_backup"
    assert sorted(os.listdir(tb)) == sorted(os.listdir(jb)) == \
        [str(t) for t in BACKUP_STEPS]
    for t in BACKUP_STEPS:
        assert _files(tb / str(t)) == _files(jb / str(t))
        for field in ("E", "B", "B0"):
            a = tbackup.read_vec(str(tb / str(t) / field))
            b = jbackup.read_vec(str(jb / str(t) / field))
            assert np.abs(a - b).max() <= 1e-12 * max(np.abs(b).max(), 1.0)
        a, b = _records(tb / str(t)), _records(jb / str(t))
        assert a.shape == b.shape == (8 * N_CELLS, 6)
        assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max()
        assert (tb / str(t) / "electrons.numparts").read_bytes() == \
            (jb / str(t) / "electrons.numparts").read_bytes()


def _load_jax(doc, backup_dir, t):
    cfg = JConfig.from_json(doc)
    sim = jschemes.build_simulation(cfg)
    sim.species = [JSpecies(p, jparticles.make_empty(256), sim.geom)
                   for p in cfg.sorts]
    backup = jbackup.SimulationBackup(sim, 2)
    backup.out_dir = str(backup_dir)
    backup.load(t)
    arr = sim.species[0].arrays
    alive = np.asarray(arr.alive)
    rec = np.concatenate([np.asarray(arr.r)[alive], np.asarray(arr.p)[alive]],
                         axis=1)
    return ({f: np.asarray(getattr(sim, f)) for f in ("E", "B", "B0")},
            rec, sim.species[0].n)


def _load_torch(doc, backup_dir, t):
    cfg = TConfig.from_json(doc)
    sim = tschemes.build_simulation(cfg, device="cpu")
    sim.species = [TSpecies(p, tparticles.make_empty(256), sim.geom)
                   for p in cfg.sorts]
    backup = tbackup.SimulationBackup(sim, 2)
    backup.out_dir = str(backup_dir)
    backup.load(t)
    arr = sim.species[0].arrays
    alive = arr.alive.numpy()
    rec = np.concatenate([arr.r.numpy()[alive], arr.p.numpy()[alive]],
                         axis=1)
    return ({f: getattr(sim, f).numpy() for f in ("E", "B", "B0")},
            rec, sim.species[0].n)


@pytest.mark.parametrize("writer,loader", [("jax", "torch"),
                                           ("torch", "jax")],
                         ids=["jax_backup_in_torch", "torch_backup_in_jax"])
def test_backup_loads_in_the_other_package(runs, tmp_path, writer, loader):
    """The loaded fields and particle set equal the bytes written."""
    src = runs[writer][0] / "simulation_backup"
    load = _load_torch if loader == "torch" else _load_jax
    fields, rec, n = load(make_doc(tmp_path / "out"), src, 4)
    g = SIDE
    for f, F in fields.items():
        data = jbackup.read_vec(str(src / "4" / f)).reshape(g, g, g, 3)
        np.testing.assert_array_equal(F, np.moveaxis(data, -1, 0))
    assert n == rec.shape[0] == 8 * N_CELLS
    np.testing.assert_array_equal(rec[np.lexsort(rec.T[::-1])],
                                  _records(src / "4"))


def test_port_run_meets_the_basic_bounds(runs):
    """``tests/test_basic_scheme.py``'s bounds on the port's own run:
    charge conserved to rounding, no particle lost, the leapfrog energy
    error a step below 2e-5 of the kinetic energy."""
    tout, counts = runs["torch"]
    assert counts == [8 * N_CELLS] * 2
    h, rows = read_table(tout / "temporal" / "charge_conservation.txt")
    assert np.all(rows[:, h.index("N2dQ_tot")] < 1e-10)
    h, rows = read_table(tout / "temporal" / "energy_conservation.txt")
    eh, erows = read_table(tout / "temporal" / "energy.txt")
    wk0 = erows[0, eh.index("wK_electrons")]
    expect = 0.5 * (1.0 / 8) * counts[0] * 3 * 0.1 / 511.0
    np.testing.assert_allclose(wk0, expect, rtol=0.05)
    assert np.all(np.abs(rows[1:, h.index("dE+dB+dK")]) < 2e-5 * wk0)


def test_log_view_table(runs):
    """The ``EachTimestep`` table: the JAX run's header (``basic`` times
    no phases: the step and the previous step's diagnostics), one row a
    step, every time and share non-negative."""
    (jout, _), (tout, _) = runs["jax"], runs["torch"]
    path = os.path.join("temporal", "log_EachTimestep.txt")
    header, rows = read_table(tout / path)
    assert header == read_table(jout / path)[0]
    assert header[:3] == ["Time", "step", "step_%"]
    assert rows.shape == (STEPS, len(header))
    assert np.all(rows >= 0.0)
    np.testing.assert_array_equal(rows[:, 0], np.arange(1, STEPS + 1))


def test_restart_matches_the_uninterrupted_run(runs, tmp_path):
    """The port loads its own step-2 backup (``load_from: 2``) and runs
    steps 3 and 4: their rows equal the uninterrupted run's within 1e-10
    of each column's scale."""
    tout, _ = runs["torch"]
    out = tmp_path / "out"
    shutil.copytree(tout / "simulation_backup" / "2",
                    out / "simulation_backup" / "2")
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(make_doc(out, load_from=2)))
    assert tcli.main([str(cfg), "--quiet", "--device", "cpu"]) == 0
    for table in TABLES:
        _, rows = read_table(out / "temporal" / table)
        np.testing.assert_array_equal(rows[:, 0], [2, 3, 4])
        for t in (3, 4):
            errs = table_errors(table, tout, out, n_cells=N_CELLS,
                                charge_scale=CHARGE_SCALE, step=t)
            assert all(e <= 1e-10 for e in errs.values()), (table, t, errs)


def test_boris_variants_match_jax():
    """``update_r`` and the four rotation variants on the same inputs,
    within 1e-14 of the largest velocity (|theta| < 1, where C2 is real)."""
    rng = np.random.default_rng(4)
    p = rng.standard_normal((256, 3))
    B = rng.standard_normal((256, 3))
    dt, qm = 0.1, -1.0
    r = np.asarray(jpushers.update_r(dt, jnp.asarray(p), jnp.asarray(B)))
    np.testing.assert_array_equal(
        tpushers.update_r(dt, torch.tensor(p), torch.tensor(B)).numpy(), r)
    assert set(tpushers.BORIS_VARIANTS) == set(jpushers.BORIS_VARIANTS)
    for name, update in tpushers.BORIS_VARIANTS.items():
        want = np.asarray(jpushers.BORIS_VARIANTS[name](
            dt, qm, jnp.asarray(p), jnp.asarray(B)))
        got = update(dt, qm, torch.tensor(p), torch.tensor(B)).numpy()
        assert np.isfinite(want).all(), name
        assert np.abs(got - want).max() <= 1e-14 * np.abs(want).max(), name
