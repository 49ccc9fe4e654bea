"""The config-driven ECSIM run of the port (``python -m xpic_tpu_torch
cfg.json``) against the JAX package's (``python -m xpic_tpu cfg.json``),
both on the CPU in float64, from the same config with the reference's
mt19937 particle load (``XPIC_RNG=reference``): 6^3 cells, 8 particles
per cell, 4 steps, a uniform B0 of 0.2 along z, the field and density
dumps every step.

Both packages assemble matL in float64, and the port sums in other
orders: the two agree to rounding, so
the tables (printed to 7 digits) are compared column by column within
1e-10 of each column's scale (``xpic_tpu_torch.diagnostics.compare``:
the largest magnitude, except for the cancelled energy differences and
standard deviations), the step-0 dumps byte for byte, later dumps to
1e-6 of their largest magnitude (float32 files), and the KSP iteration
histories exactly.
"""

import json
import os

import numpy as np
import pytest
import torch

import xpic_tpu.schemes as jschemes
import xpic_tpu_torch.schemes as tschemes
from xpic_tpu.commands import particles_load as jload
from xpic_tpu.runtime import cli as jcli
from xpic_tpu_torch.commands import particles_load as tload
from xpic_tpu_torch.config import Config
from xpic_tpu_torch.diagnostics.compare import TABLES, read_table, table_errors
from xpic_tpu_torch.ops.binning import bin_state
from xpic_tpu_torch.runtime import cli as tcli
from xpic_tpu_torch.runtime import step_profile
from xpic_tpu_torch.schemes import build_simulation

torch.set_num_threads(1)

STEPS = 4
DUMPS = ("E", "B", os.path.join("electrons", "density"))


def make_doc(out_dir, scheme="ecsim"):
    return {
        "Simulation": scheme,
        "OutputDirectory": str(out_dir),
        "Geometry": {
            "x": 3.0, "y": 3.0, "z": 3.0, "t": STEPS * 1.5,
            "dx": 0.5, "dy": 0.5, "dz": 0.5, "dt": 1.5,
            "diagnose_period": 1.5,
        },
        "Particles": [{"sort_name": "electrons", "Np": 8, "n": 1.0,
                       "q": -1.0, "m": 1.0, "T": 0.1}],
        "Presets": [
            {"command": "SetParticles", "particles": "electrons",
             "coordinate": {"name": "CoordinateInBox"},
             "momentum": {"name": "MaxwellianMomentum", "tov": True}},
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


def _run(cli, schemes, cfg_path, argv, monkeypatch):
    """``cli.main`` on ``cfg_path`` with the reference RNG; returns the
    simulation it built."""
    built = []
    orig = schemes.build_simulation

    def capture(*args, **kwargs):
        built.append(orig(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(schemes, "build_simulation", capture)
    monkeypatch.setenv("XPIC_RNG", "reference")
    try:
        assert cli.main([str(cfg_path), "--quiet", *argv]) == 0
    finally:
        monkeypatch.undo()
        jload.seed(5489)
        tload.seed(5489)
    return built[0]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    outs = {}
    for name, cli, schemes, argv in (
            ("jax", jcli, jschemes, []),
            ("torch", tcli, tschemes, ["--device", "cpu"])):
        root = tmp_path_factory.mktemp(name)
        cfg = root / "cfg.json"
        cfg.write_text(json.dumps(make_doc(root / "out")))
        mp = pytest.MonkeyPatch()
        sim = _run(cli, schemes, cfg, argv, mp)
        outs[name] = (root / "out", list(sim.ksp_history))
    return outs


@pytest.mark.parametrize("table", TABLES)
def test_tables_match(runs, table):
    """Every column within 1e-10 of its scale (``diagnostics.compare``:
    the column's largest magnitude, or the total energy for the
    energy-conservation columns, and the squared s columns against the
    field's mean square), with equal headers and row counts."""
    (jout, _), (tout, _) = runs["jax"], runs["torch"]
    errs = table_errors(table, jout, tout, n_cells=6 ** 3)
    _, rows = read_table(tout / "temporal" / table)
    assert rows.shape[0] == STEPS + 1 and np.isfinite(rows).all()
    assert all(e <= 1e-10 for e in errs.values()), errs


@pytest.mark.parametrize("dump", DUMPS)
def test_dumps_match(runs, dump):
    """Step 0 byte for byte; later steps to 1e-6 of the largest value
    (the float32 rounding of float64 fields that agree to ~1e-14)."""
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


def test_ksp_history_matches(runs):
    (_, hj), (_, ht) = runs["jax"], runs["torch"]
    assert ht == hj
    assert len(ht) == STEPS and all(0 < it < 100 for it in ht)


def test_cli_without_device_needs_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(make_doc(tmp_path / "out")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main([str(cfg), "--quiet"])
    assert not (tmp_path / "out").exists()


def test_float64_on_the_card_is_refused(tmp_path):
    cfg = Config.from_json(make_doc(tmp_path / "out"))
    with pytest.raises(ValueError, match="XPIC_X64=0"):
        build_simulation(cfg, device="cuda", dtype=torch.float64)


def test_dtype_follows_xpic_x64(tmp_path, monkeypatch):
    cfg = Config.from_json(make_doc(tmp_path / "out"))
    monkeypatch.delenv("XPIC_X64", raising=False)
    assert build_simulation(cfg, device="cpu").dtype == torch.float64
    monkeypatch.setenv("XPIC_X64", "0")
    sim = build_simulation(cfg, device="cpu")
    assert sim.dtype == torch.float32 and sim.E.dtype == torch.float32


@pytest.mark.parametrize("scheme", ["basic"])
def test_unported_schemes_raise(tmp_path, scheme):
    cfg = Config.from_json(make_doc(tmp_path / "out", scheme))
    with pytest.raises(NotImplementedError, match=scheme):
        build_simulation(cfg, device="cpu")


def test_unknown_scheme_raises(tmp_path):
    cfg = Config.from_json(make_doc(tmp_path / "out", "pic"))
    with pytest.raises(ValueError, match="unknown simulation scheme"):
        build_simulation(cfg, device="cpu")


@pytest.mark.parametrize("slots,max_load,grown", [
    (24, 20, 24), (24, 21, 32), (96, 84, 96), (96, 85, 112)])
def test_check_load_grows_k_within_its_margin(tmp_path, slots, max_load,
                                              grown):
    """K grows when a cell comes within max(4, K // 8) of it, to hold
    max_load + 2 * margin: the JAX package's rule below K = 40."""
    sim = build_simulation(Config.from_json(make_doc(tmp_path / "out")),
                           device="cpu")
    sim.initialize()
    sp = sim.species[0]
    n = sp.count()
    sp.state = bin_state(sp.arrays, sim.geom, slots)
    assert sp.slots == slots and sp.count() == n
    sim.check_load(sp, torch.tensor([max_load, 0, 0]))
    assert sp.slots == grown and sp.state.valid.shape[1] == grown
    assert sp.count() == n
    with pytest.raises(RuntimeError, match="dropped"):
        sim.check_load(sp, torch.tensor([grown, 1, 0]))


def test_step_profile_times_every_phase_and_diagnostic(tmp_path,
                                                      monkeypatch):
    """``runtime.step_profile`` on the CPU: every phase and diagnostic
    timed, the run complete; no device time without a card."""
    monkeypatch.setenv("XPIC_X64", "0")
    sim = build_simulation(Config.from_json(make_doc(tmp_path / "out")),
                           device="cpu")
    out = step_profile.profile_run(sim)
    assert out["steps_timed"] == STEPS - step_profile.WINDOW
    assert set(out["phases_ms"]) == set(step_profile.PHASES)
    assert set(out["diagnostics_ms"]) == {
        "Energy", "ChargeConservation", "MomentumConservation",
        "FieldView[E]", "FieldView[B]", "DistributionMoment[density]"}
    assert out["window"]["runs"] == step_profile.WINDOW
    assert out["window"]["device_ms"] is None
    assert len(out["ksp_history"]) == STEPS
    _, rows = read_table(tmp_path / "out" / "temporal" / "energy.txt")
    assert rows.shape[0] == STEPS + 1


@pytest.mark.parametrize("section,entry", [
    ("StepPresets", {"command": "FieldsDamping"}),
    ("Presets", {"command": "InjectParticles"}),
    ("Diagnostics", {"diagnostic": "VelocityDistribution"}),
    ("SimulationBackup", {"period": 1}),
], ids=["FieldsDamping", "InjectParticles", "VelocityDistribution",
        "SimulationBackup"])
def test_unported_commands_and_diagnostics_raise(tmp_path, section, entry):
    doc = make_doc(tmp_path / "out")
    if section == "SimulationBackup":
        doc[section] = entry
    else:
        doc[section] = list(doc.get(section, [])) + [entry]
    sim = build_simulation(Config.from_json(doc), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sim.initialize()
