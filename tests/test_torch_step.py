"""The port's ECSIM slice as a whole against the JAX package:
``ecsim_multi_step``, 3 steps at 8^3 x 10 ppc from the same numpy state.

Under the suite's 8 virtual devices the jitted JAX step takes the global
rebin; the port takes the neighbor exchange for f32.  Both take the
assembled mass route in f64 and the matrix-free one in f32.  Slot order
inside a cell therefore differs, so particles are compared as per-cell
multisets.  f64 checks the algorithm (1e-12), f32 the working type
(1e-4).  slots = 24 keeps every cell below capacity, so no path drops a
particle and the multisets are comparable.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xpic_tpu.config import Geometry
from xpic_tpu.ops.binning import bin_state as jax_bin_state
from xpic_tpu.parallel.step import ecsim_multi_step as jax_multi_step
from xpic_tpu.parallel.step import ecsim_step_binned as jax_step
from xpic_tpu.particles import ParticleArrays
from xpic_tpu_torch import kernels
from xpic_tpu_torch.config import Geometry as TGeometry
from xpic_tpu_torch.convert import state_from_numpy, to_numpy
from xpic_tpu_torch.ops.binning import bin_state
from xpic_tpu_torch.parallel.step import ecsim_multi_step, ecsim_step_binned

torch.set_num_threads(1)

N_SIDE, PPC, SLOTS, STEPS = 8, 10, 24, 3
KW = dict(q=-1.0, m=1.0, mpw=1.0 / PPC, maxit=100)
GEOM_KW = dict(dx=0.5, dy=0.5, dz=0.5, dt=1.5, nx=N_SIDE, ny=N_SIDE,
               nz=N_SIDE, nt=1)


def _inputs():
    geom = Geometry(**GEOM_KW)
    rng = np.random.default_rng(0)
    n = geom.n_cells * PPC
    r = rng.random((n, 3)) * np.array(geom.L)
    p = rng.standard_normal((n, 3)) * 0.014
    shape = (3,) + geom.shape
    E = rng.standard_normal(shape) * 1e-3
    B = 0.2 + 0.05 * rng.standard_normal(shape)
    return geom, E, B, B.copy(), r, p


def cell_multisets(r, p, alive, geom):
    """Rows (cell, r, p) of the live particles, sorted by cell then
    position: equal per-cell multisets give equal arrays."""
    r, p, alive = (np.asarray(a, np.float64) for a in (r, p, alive))
    live = alive > 0
    r, p = r[live], p[live]
    c = np.floor(r / np.array([geom.dx, geom.dy, geom.dz])).astype(int)
    cell = (c[:, 2] * geom.ny + c[:, 1]) * geom.nx + c[:, 0]
    order = np.lexsort((r[:, 2], r[:, 1], r[:, 0], cell))
    return cell[order], np.concatenate([r, p], axis=1)[order]


@pytest.fixture(scope="module", params=["float64", "float32"])
def runs(request):
    geom, E, B, B0, r, p = _inputs()
    npd = np.dtype(request.param)
    jd = jnp.float64 if npd == np.float64 else jnp.float32
    sp = ParticleArrays(r=jnp.asarray(r, jd), p=jnp.asarray(p, jd),
                        alive=jnp.ones(len(r), bool))
    Ej, Bj, spj, itj = jax_multi_step(
        jnp.asarray(E, jd), jnp.asarray(B, jd), jnp.asarray(B0, jd), sp,
        geom, SLOTS, n_steps=STEPS, **KW)
    ref = (np.asarray(Ej), np.asarray(Bj),
           cell_multisets(spj.r, spj.p, spj.alive, geom), np.asarray(itj))

    kernels.reset_counts()
    td = torch.float64 if npd == np.float64 else torch.float32
    tgeom = TGeometry(**GEOM_KW)
    Et, Bt, B0t, spt = state_from_numpy(E, B, B0, r, p, np.ones(len(r)),
                                        device="cpu", dtype=td)
    Et, Bt, spt, itt = ecsim_multi_step(Et, Bt, B0t, spt, tgeom, SLOTS,
                                        n_steps=STEPS, **KW)
    spn = to_numpy(spt)
    got = (to_numpy(Et), to_numpy(Bt),
           cell_multisets(spn.r, spn.p, spn.alive, geom), itt.numpy())
    return request.param, geom, ref, got


def _tol(dtype):
    return 1e-12 if dtype == "float64" else 1e-4


def test_fields_match(runs):
    dtype, _, ref, got = runs
    for a, b in zip(got[:2], ref[:2]):
        assert a.dtype == b.dtype == np.dtype(dtype)
        assert np.abs(a - b).max() <= _tol(dtype) * np.abs(b).max()
    assert np.isfinite(got[0]).all() and np.isfinite(got[1]).all()


def test_particles_match(runs):
    dtype, geom, ref, got = runs
    (cell_r, rows_r), (cell_g, rows_g) = ref[2], got[2]
    assert len(cell_g) == len(cell_r) == geom.n_cells * PPC
    assert np.array_equal(cell_g, cell_r)
    scale = np.abs(rows_r).max(axis=0)
    assert (np.abs(rows_g - rows_r) <= _tol(dtype) * scale).all()


def test_ksp_iterations_match(runs):
    _, _, ref, got = runs
    assert got[3].tolist() == ref[3].tolist()
    assert (got[3] > 0).all() and (got[3] < KW["maxit"]).all()


def test_cpu_run_launches_no_kernel(runs):
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_warm_started_step_matches_jax():
    """Two f64 steps, the second warm-started with the first's
    ``(Ep, rhs)`` (``return_adv`` / ``prev``).  The JAX reference takes
    its cold first step as ``prev = (0, 0)``, which reproduces the cold
    predictor exactly (``advance_phase``), so both JAX steps share one
    compiled program."""
    geom, E, B, B0, r, p = _inputs()
    sp = ParticleArrays(r=jnp.asarray(r), p=jnp.asarray(p),
                        alive=jnp.ones(len(r), bool))
    st = jax_bin_state(sp, geom, SLOTS)
    kw = dict(q=KW["q"], m=KW["m"], mpw=KW["mpw"], maxit=KW["maxit"],
              return_adv=True)
    zero = jnp.zeros_like(jnp.asarray(E))
    E1, B1, st, _, it1, adv = jax_step(jnp.asarray(E), jnp.asarray(B),
                                       jnp.asarray(B0), st, geom,
                                       prev=(zero, zero), **kw)
    E2, B2, _, _, it2, _ = jax_step(E1, B1, jnp.asarray(B0), st, geom,
                                    prev=adv, **kw)
    kw = {k: v for k, v in kw.items() if k != "return_adv"}

    tgeom = TGeometry(**GEOM_KW)
    Et, Bt, B0t, spt = state_from_numpy(E, B, B0, r, p, np.ones(len(r)),
                                        device="cpu", dtype=torch.float64)
    stt = bin_state(spt, tgeom, SLOTS)
    Et, Bt, stt, _, jt1, advt = ecsim_step_binned(Et, Bt, B0t, stt, tgeom,
                                                  return_adv=True, **kw)
    Et, Bt, _, _, jt2 = ecsim_step_binned(Et, Bt, B0t, stt, tgeom,
                                          prev=advt, **kw)
    assert [jt1, jt2] == [int(it1), int(it2)]
    for a, b in ((Et, E2), (Bt, B2)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-12 * np.abs(b).max()
