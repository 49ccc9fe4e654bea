"""The plain twins of the port's mass-apply and slot-gather kernels
(``ops/mass_kernel.py``, ``ops/ecsim_kernel.py``) against the JAX
package, on the CPU, from the same numpy inputs; plus the two other
pieces the config-driven run adds below the scheme (``deposit_scalar``
and the uniform ``SetMagneticField``).

Against the Pallas kernels (interpret mode) in float32 the tolerance is
that of the JAX suite's own kernel tests (sums in another order); against
the XLA chain in float64 the two compute the same expression, to 1e-13.
The particle helpers the config-driven run adds are held equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xpic_tpu.config import Geometry
from xpic_tpu.ops import gather_scatter as jgs
from xpic_tpu.ops import mass_free as jmf
from xpic_tpu.ops.ecsim_blocks import gather_slots as jax_gather_slots
from xpic_tpu.ops.pallas_ecsim import ecsim_gather_pallas
from xpic_tpu.ops.pallas_mass import mass_apply_slots_pallas
from xpic_tpu_torch import kernels
from xpic_tpu_torch.config import Geometry as TGeometry
from xpic_tpu_torch.ops import gather_scatter as tgs
from xpic_tpu_torch.ops import mass_free as tmf
from xpic_tpu_torch.ops.ecsim_blocks import gather_slots
from xpic_tpu_torch.ops.ecsim_kernel import ecsim_gather, ecsim_gather_plain
from xpic_tpu_torch.ops.mass_kernel import (
    mass_apply_slots,
    mass_apply_slots_plain,
)

torch.set_num_threads(1)

GEOM_KW = dict(dx=0.5, dy=0.4, dz=0.6, dt=1.5, nx=4, ny=4, nz=4, nt=1)
K = 16
Q, M, MPW = -1.0, 1.0, 0.1


def _inputs(seed=0):
    """Cell-relative positions t [G, K, 3], B at the slots (|B| ~ 0.2, so
    the rotation terms count), a slot mask, the packed operands [G, 8, K]
    built the way ``mass_operands`` builds them, and slot values
    xg [G, 3, 12]."""
    rng = np.random.default_rng(seed)
    G = 4 * 4 * 4
    valid = rng.random((G, K)) < 0.7
    t = np.where(valid[..., None], rng.random((G, K, 3)), 0.5)
    B_p = 0.2 * rng.standard_normal((G, K, 3))
    b = B_p * (0.5 * GEOM_KW["dt"] * Q / M)
    coef = (0.5 * GEOM_KW["dt"] ** 2 * MPW * Q * Q / M) / (
        1.0 + np.sum(b * b, axis=-1))
    coef = np.where(valid, coef, 0.0)
    packed = np.concatenate(
        [np.moveaxis(t, -1, 1), np.moveaxis(b, -1, 1), coef[:, None, :],
         np.zeros((G, 1, K))], axis=1)
    xg = rng.standard_normal((G, 3, 12))
    return t, B_p, valid, packed, xg


def test_mass_twin_matches_pallas_kernel_f32():
    _, _, _, packed, xg = _inputs()
    ref = np.asarray(mass_apply_slots_pallas(
        jnp.asarray(xg, jnp.float32), jnp.asarray(packed, jnp.float32),
        interpret=True))
    got = mass_apply_slots_plain(
        torch.tensor(xg, dtype=torch.float32),
        torch.tensor(packed, dtype=torch.float32)).numpy()
    assert got.dtype == np.float32 and got.shape == (64, 3, 12)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())


def test_mass_twin_matches_xla_chain_f64():
    _, _, _, packed, xg = _inputs(1)
    P = jnp.asarray(packed)
    wn, ws = jmf._axis_hats_planes((P[:, 0], P[:, 1], P[:, 2]))
    comps = jmf._component_factors(wn, ws)
    u = tuple(jmf._gather_component(jnp.asarray(xg)[:, c], *comps[c])
              for c in range(3))
    y = jmf._rotate(u, (P[:, 3], P[:, 4], P[:, 5]), P[:, 6])
    ref = np.asarray(jnp.stack(
        [jmf._deposit_component(y[c], *comps[c]) for c in range(3)], axis=1))
    got = mass_apply_slots(torch.tensor(xg), torch.tensor(packed)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-13 * np.abs(ref).max())


def test_mass_apply_matches_jax_f64():
    """The whole matrix-free apply (slot gather, the twin, deposit) for
    two species against ``xpic_tpu.ops.mass_free.mass_apply``."""
    geom = Geometry(**GEOM_KW)
    ops_j, ops_t = [], []
    for seed in (2, 3):
        t, B_p, valid, _, _ = _inputs(seed)
        op = jmf.mass_operands(jnp.asarray(t), jnp.asarray(B_p),
                               jnp.asarray(valid), q=Q, m=M, mpw=MPW,
                               dt=geom.dt)
        ops_j.append(op)
        ops_t.append(tmf.mass_operands(
            torch.tensor(t), torch.tensor(B_p), torch.tensor(valid), q=Q,
            m=M, mpw=MPW, dt=geom.dt))
    x = np.random.default_rng(4).standard_normal((3,) + geom.shape)
    ref = np.asarray(jmf.mass_apply(jnp.asarray(x), ops_j, geom))
    got = tmf.mass_apply(torch.tensor(x), ops_t, TGeometry(**GEOM_KW))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-13 * np.abs(ref).max())


def test_gather_twin_matches_pallas_kernel_f32():
    geom = Geometry(**GEOM_KW)
    t, _, _, _, _ = _inputs(5)
    F = np.random.default_rng(6).standard_normal((3,) + geom.shape)
    Fg = np.asarray(jax_gather_slots(jnp.asarray(F, jnp.float32), geom))
    ref = np.asarray(ecsim_gather_pallas(jnp.asarray(t, jnp.float32),
                                         jnp.asarray(Fg), interpret=True))
    got = ecsim_gather_plain(torch.tensor(t, dtype=torch.float32),
                             torch.tensor(Fg)).numpy()
    assert got.dtype == np.float32 and got.shape == (64, K, 3)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-6)


def test_gather_vector_slots_matches_jax_f64():
    geom = Geometry(**GEOM_KW)
    t, _, _, _, _ = _inputs(7)
    F = np.random.default_rng(8).standard_normal((3,) + geom.shape)
    ref = np.asarray(jmf.gather_vector_slots(jnp.asarray(F),
                                             jnp.asarray(t), geom))
    tgeom = TGeometry(**GEOM_KW)
    got = tmf.gather_vector_slots(torch.tensor(F), torch.tensor(t), tgeom)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-13 * np.abs(ref).max())
    twin = ecsim_gather(torch.tensor(t), gather_slots(torch.tensor(F),
                                                      tgeom))
    assert torch.equal(twin, got)


@pytest.mark.parametrize("stag,order,width", [(False, 2, 4), (True, 1, 3)],
                         ids=["charge", "moment"])
def test_deposit_scalar_matches_jax(stag, order, width):
    geom = Geometry(**GEOM_KW)
    t, _, valid, _, _ = _inputs(9)
    vals = np.random.default_rng(10).standard_normal(valid.shape)
    kw = dict(order=order, width=width, anchor=-1, stag=stag)
    ref = np.asarray(jgs.deposit_scalar(jnp.asarray(vals), jnp.asarray(t),
                                        jnp.asarray(valid), geom, **kw))
    got = tgs.deposit_scalar(torch.tensor(vals), torch.tensor(t),
                             torch.tensor(valid), TGeometry(**GEOM_KW), **kw)
    assert got.shape == geom.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-14 * np.abs(ref).max())


@pytest.mark.parametrize("field", [
    {"name": "SetUniformField", "value": [0.0, 0.1, 0.2]},
    {"name": "SetApproximateMirrorField", "D": 1.0, "R": 0.5, "I": 2.0},
    {"name": "SetCoilsField", "coils": [{"z0": 0.5, "R": 0.4, "I": 1.0}]},
], ids=lambda f: f["name"])
def test_set_magnetic_field_matches_jax(field):
    from xpic_tpu.commands.set_magnetic_field import \
        SetMagneticField as JSetField
    from xpic_tpu.config import Config as JConfig
    from xpic_tpu_torch.commands.set_magnetic_field import SetMagneticField
    from xpic_tpu_torch.config import Config

    doc = {"Simulation": "ecsim", "Geometry": {
        "x": 2.0, "y": 1.6, "z": 2.4, "t": 1.5, "dx": 0.5, "dy": 0.4,
        "dz": 0.6, "dt": 1.5}}
    info = {"command": "SetMagneticField", "field": field}

    class Sim:
        pass

    outs = []
    for cls, cfg, zeros in (
            (JSetField, JConfig.from_json(doc),
             lambda s: jnp.zeros(s)),
            (SetMagneticField, Config.from_json(doc),
             lambda s: torch.zeros(s, dtype=torch.float64))):
        sim = Sim()
        sim.cfg, sim.geom = cfg, cfg.geometry
        shape = (3,) + cfg.geometry.shape
        sim.B0, sim.B = zeros(shape), zeros(shape)
        cls.from_json(sim, info).execute(0)
        outs.append((np.asarray(sim.B0), np.asarray(sim.B)))
    (rb0, rb), (gb0, gb) = outs
    scale = max(np.abs(rb0).max(), 1e-300)
    assert np.abs(gb0 - rb0).max() <= 1e-14 * scale
    assert np.abs(gb - rb).max() <= 1e-14 * scale


def test_particle_helpers_match_jax():
    """``from_numpy``, ``append`` (fills dead slots, then grows by whole
    buckets), ``apply_boundaries`` on a periodic / reflective / open box
    and ``kinetic_energy``, against ``xpic_tpu.particles``: equal, the
    energy to 1e-14."""
    from xpic_tpu import particles as jp
    from xpic_tpu.config import SortParameters as JSort
    from xpic_tpu_torch import particles as tp
    from xpic_tpu_torch.config import SortParameters as TSort

    kw = dict(GEOM_KW, bounds=("periodic", "reflective", "none"))
    rng = np.random.default_rng(12)
    L = np.array(Geometry(**kw).L)
    r0, r1 = rng.random((300, 3)) * L, rng.random((100, 3)) * L
    p0, p1 = rng.standard_normal((300, 3)), rng.standard_normal((100, 3))
    keep = np.arange(320) % 7 != 0  # 63 dead slots for 100 arrivals
    move = rng.uniform(-0.3, 0.3, (384, 3)) * L
    sort = dict(sort_name="e", Np=5, n=1.0, q=-1.0, m=2.0)

    def run(P, to, geom, params):
        sp = P.from_numpy(r0, p0, capacity=320)
        sp = P.ParticleArrays(r=sp.r, p=sp.p, alive=sp.alive & to(keep))
        sp = P.append(sp, r1, p1, bucket=64)
        sp = P.apply_boundaries(
            P.ParticleArrays(r=sp.r + to(move), p=sp.p, alive=sp.alive), geom)
        return (np.asarray(sp.r), np.asarray(sp.p), np.asarray(sp.alive),
                float(P.kinetic_energy(sp, params)))

    ref = run(jp, jnp.asarray, Geometry(**kw), JSort(**sort))
    got = run(tp, torch.tensor, TGeometry(**kw), TSort(**sort))
    assert ref[0].shape == (384, 3) and 0 < ref[2].sum() < 363
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(a, b)
    assert abs(got[3] - ref[3]) <= 1e-14 * ref[3]  # sums in another order


def test_cpu_wrappers_count_no_launch():
    kernels.reset_counts()
    t, _, _, packed, xg = _inputs()
    mass_apply_slots(torch.tensor(xg, dtype=torch.float32),
                     torch.tensor(packed, dtype=torch.float32))
    ecsim_gather(torch.tensor(t, dtype=torch.float32),
                 torch.zeros((64, 3, 12)))
    assert kernels.LAUNCHES["mass_apply"] == 0
    assert kernels.LAUNCHES["slot_gather"] == 0


def test_other_devices_raise():
    xg = torch.empty((8, 3, 12), device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        mass_apply_slots(xg, torch.empty((8, 8, 16), device="meta"))
    with pytest.raises(RuntimeError, match="unsupported device"):
        ecsim_gather(torch.empty((8, 16, 3), device="meta"), xg)
