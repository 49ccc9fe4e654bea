"""The port's step presets FieldsDamping, InjectParticles and
RemoveParticles, the Energy table's source and sink columns, the
VelocityDistribution histogram, TableFunction and the backup's rolling
window against the JAX package, on the CPU in float64.

The commands and diagnostics are called directly on initialised
simulations of both packages, built from one config with the same seed
and taking no step, so no JAX push is compiled: the fields are set from
numpy, the particles come from the same loader draws.  The mirror
machine of ``tests/test_commands.py`` runs through the port alone.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xpic_tpu.commands import particles_load as jload
from xpic_tpu.config import Config as JConfig
from xpic_tpu.diagnostics.velocity_distribution import _project as jproject
from xpic_tpu.particles import from_numpy as jfrom_numpy
from xpic_tpu.schemes import build_simulation as jbuild
from xpic_tpu.utils.table_function import TableFunction as JTableFunction
from xpic_tpu_torch.commands import particles_load as tload
from xpic_tpu_torch.config import Config as TConfig
from xpic_tpu_torch.diagnostics.compare import read_table, table_errors
from xpic_tpu_torch.diagnostics.simulation_backup import SimulationBackup
from xpic_tpu_torch.diagnostics.velocity_distribution import (
    _project as tproject,
)
from xpic_tpu_torch.particles import from_numpy as tfrom_numpy
from xpic_tpu_torch.schemes import build_simulation as tbuild
from xpic_tpu_torch.utils.table_function import (
    TableFunction as TTableFunction,
)

torch.set_num_threads(1)


def base_doc(out_dir, scheme="basic", nt=2, dt=0.5, nz=10):
    """``tests/test_commands.py``'s box (8 x 8 x ``nz`` cells of 0.5) with
    electrons and empty ions; the electrons loaded in the whole box."""
    return {
        "Simulation": scheme,
        "OutputDirectory": str(out_dir),
        "Geometry": {
            "x": 4.0, "y": 4.0, "z": nz * 0.5, "t": nt * dt,
            "dx": 0.5, "dy": 0.5, "dz": 0.5, "dt": dt,
            "diagnose_period": 1,
        },
        "Particles": [
            {"sort_name": "electrons", "Np": 10, "n": 1.0, "q": -1.0,
             "m": 1.0, "T": 0.02},
            {"sort_name": "ions", "Np": 10, "n": 1.0, "q": 1.0,
             "m": 100.0, "T": 0.02},
        ],
        "Presets": [
            {"command": "SetParticles", "particles": "electrons",
             "coordinate": {"name": "CoordinateInBox"},
             "momentum": {"name": "MaxwellianMomentum"}},
        ],
        "StepPresets": [],
        "Diagnostics": [],
    }


def init_both(tmp_path, step_presets=(), diagnostics=(), seed=11):
    """The JAX and the port simulation of one config, initialised from
    the same loader seed; random E and B, B0 zero, set from numpy."""
    sims = []
    for name, Config, build, load, kw in (
            ("jax", JConfig, jbuild, jload, {}),
            ("torch", TConfig, tbuild, tload, {"device": "cpu"})):
        doc = base_doc(tmp_path / name)
        doc["StepPresets"] = list(step_presets)
        doc["Diagnostics"] = list(diagnostics)
        load.seed(seed)
        sim = build(Config.from_json(doc), **kw)
        sim.initialize()
        sims.append(sim)
    jsim, tsim = sims
    rng = np.random.default_rng(3)
    for f in ("E", "B"):
        F = rng.standard_normal(np.shape(jsim.E))
        setattr(jsim, f, jnp.asarray(F))
        setattr(tsim, f, torch.tensor(F))
    return jsim, tsim


def live(arrays):
    """(r, p) of the live particles of a flat view, as numpy."""
    alive = np.asarray(arrays.alive)
    return np.asarray(arrays.r)[alive], np.asarray(arrays.p)[alive]


def field_energy(E, B, B0):
    return 0.5 * float(np.sum(np.asarray(E) ** 2)
                       + np.sum((np.asarray(B) - np.asarray(B0)) ** 2))


@pytest.mark.parametrize("geometry", [
    {"name": "BoxGeometry", "min": [1.0, 1.0, 1.0], "max": [3.0, 3.0, 4.0],
     "coefficient": 0.8},
    {"name": "CylinderGeometry", "radius": 1.2, "coefficient": 0.8},
], ids=["box", "cylinder"])
def test_fields_damping_matches_jax(tmp_path, geometry):
    """The damping factors bitwise; the damped fields within 1e-14 and
    the damped energy within 1e-12, which closes against the field
    energy's drop."""
    jsim, tsim = init_both(tmp_path, [{"command": "FieldsDamping",
                                       "geometry": geometry}])
    jcmd, tcmd = jsim.step_presets[0], tsim.step_presets[0]
    np.testing.assert_array_equal(tcmd.factor.numpy(), np.asarray(jcmd.factor))
    assert tcmd.factor.min() < 1.0
    e0 = field_energy(tsim.E, tsim.B, tsim.B0)
    jcmd.execute(1)
    tcmd.execute(1)
    e1 = field_energy(tsim.E, tsim.B, tsim.B0)
    assert tcmd.get_damped_energy() > 0.0
    np.testing.assert_allclose(tcmd.get_damped_energy(),
                               jcmd.get_damped_energy(), rtol=1e-12)
    np.testing.assert_allclose(tcmd.get_damped_energy(), e0 - e1, rtol=1e-12)
    for f in ("E", "B"):
        np.testing.assert_allclose(getattr(tsim, f).numpy(),
                                   np.asarray(getattr(jsim, f)),
                                   rtol=0, atol=1e-14)


def test_inject_particles_matches_jax(tmp_path):
    """Two steps of paired injection: the particles bitwise the JAX
    package's, the counts, and the energies within 1e-12."""
    jsim, tsim = init_both(tmp_path, [{
        "command": "InjectParticles", "ionized": "ions",
        "ejected": "electrons", "per_step_particles_num": 40,
        "coordinate": {"name": "CoordinateInCylinder", "radius": 1.0,
                       "height": 5.0},
        "momentum_i": {"name": "MaxwellianMomentum"},
        "momentum_e": {"name": "MaxwellianMomentum"}}])
    n_e = tsim.get_named_particles("electrons").count()
    for t in (1, 2):
        jcmd, tcmd = jsim.step_presets[0], tsim.step_presets[0]
        jcmd.execute(t)
        tcmd.execute(t)
        assert tcmd.get_ionized_energy() > 0.0
        np.testing.assert_allclose(tcmd.get_ionized_energy(),
                                   jcmd.get_ionized_energy(), rtol=1e-12)
        np.testing.assert_allclose(tcmd.get_ejected_energy(),
                                   jcmd.get_ejected_energy(), rtol=1e-12)
    ions = tsim.get_named_particles("ions")
    assert ions.count() == ions.n == 80
    assert tsim.get_named_particles("electrons").count() == n_e + 80
    for name in ("ions", "electrons"):
        for got, want in zip(live(tsim.get_named_particles(name).arrays),
                             live(jsim.get_named_particles(name).arrays)):
            np.testing.assert_array_equal(got, want)


def test_remove_particles_matches_jax(tmp_path):
    """The survivors and the removed energy of a keep-cylinder."""
    jsim, tsim = init_both(tmp_path, [{
        "command": "RemoveParticles", "particles": "electrons",
        "geometry": {"name": "CylinderGeometry", "radius": 1.0}}])
    sp = tsim.species[0]
    n0 = sp.count()
    jsim.step_presets[0].execute(1)
    tsim.step_presets[0].execute(1)
    assert 0 < sp.count() == sp.n == jsim.species[0].count() < n0
    np.testing.assert_allclose(tsim.step_presets[0].get_removed_energy(),
                               jsim.step_presets[0].get_removed_energy(),
                               rtol=1e-12)
    for got, want in zip(live(sp.arrays), live(jsim.species[0].arrays)):
        np.testing.assert_array_equal(got, want)
    r = live(sp.arrays)[0]
    assert np.all(np.hypot(r[:, 0] - 2.0, r[:, 1] - 2.0) < 1.0 + 1e-12)


def test_energy_source_and_sink_columns_match_jax(tmp_path):
    """The mirror machine's three step presets once, then the Energy
    diagnostic: the same header, Damped(E+B), Inj_* and Rm_* among it,
    every column within 1e-12 of its scale."""
    jsim, tsim = init_both(tmp_path, [
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
    ])
    for sim in (jsim, tsim):
        for command in sim.step_presets:
            command.execute(1)
        sim.diagnostics[0].diagnose(1)
        sim.diagnostics[0].finalize()
    header, rows = read_table(tmp_path / "torch" / "temporal"
                              / "energy_conservation.txt")
    assert {"Damped(E+B)", "Inj_ions", "Inj_electrons",
            "Rm_electrons"} <= set(header)
    assert header[-1] == "dE+dB+dK" and np.isfinite(rows).all()
    for table in ("energy.txt", "energy_conservation.txt"):
        errs = table_errors(table, tmp_path / "jax", tmp_path / "torch",
                            n_cells=8 * 8 * 10)
        assert all(e <= 1e-12 for e in errs.values()), (table, errs)


@pytest.mark.parametrize("projection", ["vx_vy", "vz_vxy", "vr_vphi"])
def test_velocity_distribution_matches_jax(tmp_path, projection):
    """Each projector, and the histogram of the loaded electrons plus
    hand-placed particles in range, out of range and outside the region,
    within 1e-12 of the largest bin.  No velocity lies on a bin edge:
    XLA:CPU divides by a constant through its reciprocal, so its floor
    differs from the correctly rounded quotient's there."""
    info = {"diagnostic": "VelocityDistribution", "particles": "electrons",
            "projection": projection, "vmin": [-0.3, -0.3],
            "vmax": [0.3, 0.3], "dv": [0.05, 0.025],
            "region": {"start": [0.5, 0.5, 0.5], "size": [3.0, 3.0, 4.0]}}
    jsim, tsim = init_both(tmp_path, diagnostics=[info])
    jvd, tvd = jsim.diagnostics[-1], tsim.diagnostics[-1]
    r, p = live(tsim.species[0].arrays)
    extra_r = np.array([[2.3, 1.9, 2.0], [3.0, 1.0, 2.0], [0.1, 2.0, 2.0],
                        [2.2, 2.1, 2.0]])
    extra_p = np.array([[0.051, 0.026, -0.1037], [-0.29, 0.21, 0.013],
                        [0.011, 0.012, 0.013], [0.55, 0.01, 0.011]])
    r, p = np.concatenate([r, extra_r]), np.concatenate([p, extra_p])
    pr, pp = np.array([[3.0, 2.0, 0.0]]), np.array([[0.3, 0.4, 0.5]])
    for got, want in zip(tproject(projection, torch.tensor(pr),
                                  torch.tensor(pp), 4.0, 4.0),
                         jproject(projection, jnp.asarray(pr),
                                  jnp.asarray(pp), 4.0, 4.0)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-15)
    want = np.asarray(jvd._collect(jfrom_numpy(r, p)))
    got = tvd.collect(tfrom_numpy(r, p)).numpy()
    assert got.shape == want.shape == (24, 12)
    assert want.max() > 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * want.max())


def test_table_function_matches_jax(tmp_path):
    """The same file bytes, the same header read back, and linear
    interpolation (exact on a linear function) equal to JAX's, clamped
    at both ends."""
    x = np.linspace(-2.0, 3.0, 51)
    paths = {}
    for name, cls in (("jax", JTableFunction), ("torch", TTableFunction)):
        tf = cls.from_arrays(-2.0, 0.1, 3.0 * x + 1.0)
        paths[name] = str(tmp_path / f"{name}.bin")
        tf.save(paths[name])
    with open(paths["jax"], "rb") as a, open(paths["torch"], "rb") as b:
        assert a.read() == b.read()
    jtf, ttf = JTableFunction(paths["torch"]), TTableFunction(paths["jax"])
    assert (ttf.xmin, ttf.xmax, ttf.dx) == (jtf.xmin, jtf.xmax, jtf.dx)
    q = np.array([-2.5, -2.0, -1.37, 0.0, 0.123, 2.99, 3.0, 4.0])
    got = ttf.get_value(q).numpy()
    np.testing.assert_allclose(got, np.asarray(jtf.get_value(q)),
                               rtol=0, atol=1e-15)
    inner = (q >= -2.0) & (q <= 3.0)
    np.testing.assert_allclose(got[inner], 3.0 * q[inner] + 1.0, atol=1e-12)
    assert got[0] == got[1] and got[-1] == got[-2]
    ttf.scale_values(2.0)
    ttf.scale_coordinates(0.5)
    np.testing.assert_allclose(ttf.get_value(torch.tensor([0.5])).numpy(),
                               [2.0 * (3.0 * 1.0 + 1.0)], rtol=1e-15)


def _port_sim(tmp_path):
    doc = base_doc(tmp_path / "out")
    tload.seed(100)
    sim = tbuild(TConfig.from_json(doc), device="cpu")
    sim.initialize()
    return sim


def test_backup_rolling_window(tmp_path):
    """num_periods_being_kept = 2 (simulation_backup.cpp:46)."""
    sim = _port_sim(tmp_path)
    backup = SimulationBackup(sim, period=1)
    for t in range(1, 5):
        backup.diagnose(t)
    kept = sorted(n for n in os.listdir(backup.out_dir) if n.isdigit())
    assert kept == ["3", "4"]
    sim.finalize()


def test_backup_save_sources(tmp_path):
    """``save_sources: true`` copies the port's package tree into
    <backup>/src, without bytecode caches."""
    sim = _port_sim(tmp_path)
    backup = SimulationBackup.from_json(sim, {"save_sources": True})
    src = os.path.join(backup.out_dir, "src")
    assert os.path.isfile(os.path.join(src, "config.py"))
    assert os.path.isfile(
        os.path.join(src, "diagnostics", "simulation_backup.py"))
    assert os.path.isfile(os.path.join(src, "csrc", "rebin_place.cu"))
    assert not any("__pycache__" in d for d, _, _ in os.walk(src))
    sim.finalize()


def test_mirror_machine_end_to_end(tmp_path):
    """``tests/test_commands.py``'s mirror machine through the port
    (ecsimcorr, open z, two coils, paired injection, outside-cylinder
    removal, cylinder damping; 3 steps, float64): the Damped/Inj/Rm
    columns present and finite, injection seen, ions alive, E finite."""
    nt, dt = 3, 0.5
    doc = base_doc(tmp_path / "mirror", scheme="ecsimcorr", nt=nt, dt=dt,
                   nz=12)
    doc["Geometry"]["da_boundary_z"] = "DM_BOUNDARY_GHOSTED"
    doc["Presets"] = [
        {"command": "SetMagneticField",
         "field": {"name": "SetCoilsField",
                   "coils": [{"z0": 1.0, "R": 1.5, "I": 0.05},
                             {"z0": 5.0, "R": 1.5, "I": 0.05}]}},
        {"command": "SetParticles",
         "particles": "electrons",
         "coordinate": {"name": "CoordinateInCylinder", "radius": 1.0,
                        "height": 4.0},
         "momentum": {"name": "MaxwellianMomentum"}},
    ]
    doc["StepPresets"] = [
        {"command": "InjectParticles",
         "ionized": "ions", "ejected": "electrons",
         "per_step_particles_num": 20,
         "coordinate": {"name": "CoordinateInCylinder", "radius": 0.5,
                        "height": 2.0},
         "momentum_i": {"name": "MaxwellianMomentum"},
         "momentum_e": {"name": "MaxwellianMomentum"}},
        {"command": "RemoveParticles",
         "particles": "electrons",
         "geometry": {"name": "CylinderGeometry", "radius": 1.8}},
        {"command": "FieldsDamping",
         "geometry": {"name": "CylinderGeometry", "radius": 1.6,
                      "coefficient": 0.8}},
    ]
    tload.seed(14)
    sim = tbuild(TConfig.from_json(doc), device="cpu")
    sim.initialize()
    assert float(sim.B0[2].max()) > 0.0
    sim.calculate()
    sim.finalize()

    header, rows = read_table(tmp_path / "mirror" / "temporal"
                              / "energy_conservation.txt")
    for col in ("Damped(E+B)", "Inj_ions", "Inj_electrons", "Rm_electrons",
                "dE+dB+dK"):
        assert col in header, f"missing column {col}"
    assert rows.shape[0] == nt + 1 and np.isfinite(rows).all()
    assert np.any(rows[:, header.index("Inj_ions")] > 0.0)
    assert sim.get_named_particles("ions").count() > 0
    assert bool(torch.isfinite(sim.E).all())
