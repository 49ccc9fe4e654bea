"""The port's binned state and migration against the JAX package.

The neighbor exchange's plain twins (``extract_plain``/``place_plain``)
must reproduce the JAX exchange with its Pallas kernels in interpret
mode bit for bit: ``(r, p, valid, load)`` and the guard's decisions.
The JAX exchange packs several cells per 128-lane row; the port does
not, and the result must not depend on it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xpic_tpu.config import Geometry
from xpic_tpu.ops import binning as JB
from xpic_tpu.ops import neighbor_rebin as JNR
from xpic_tpu.particles import ParticleArrays as JParticles
from xpic_tpu_torch.convert import binned_from_numpy, state_from_numpy
from xpic_tpu_torch.ops import binning as TB
from xpic_tpu_torch.ops import neighbor_rebin as TNR

torch.set_num_threads(1)

GEOM = Geometry(dx=0.5, dy=0.5, dz=0.5, dt=1.5, nx=8, ny=6, nz=4, nt=1)


def _species(geom, vth, seed, ppc=20, dtype=np.float32):
    rng = np.random.default_rng(seed)
    n = geom.n_cells * ppc
    r = (rng.random((n, 3)) * np.array(geom.L)).astype(dtype)
    p = (rng.standard_normal((n, 3)) * vth).astype(dtype)
    return r, p


def _jax_binned(r, p, geom, slots):
    sp = JParticles(r=jnp.asarray(r), p=jnp.asarray(p),
                    alive=jnp.ones(len(r), bool))
    return JB.bin_state(sp, geom, slots)


def _port(st):
    return binned_from_numpy(np.asarray(st.r), np.asarray(st.p),
                             np.asarray(st.valid), device="cpu")


def _same_state(tst, jst, load_t=None, load_j=None):
    assert np.array_equal(tst.valid.numpy(), np.asarray(jst.valid))
    assert np.array_equal(tst.r.numpy(), np.asarray(jst.r))
    assert np.array_equal(tst.p.numpy(), np.asarray(jst.p))
    if load_t is not None:
        assert [int(v) for v in load_t] == [int(v) for v in load_j]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bin_unbin_and_drift_match(dtype):
    geom = Geometry(dx=0.5, dy=0.5, dz=0.5, dt=1.5, nx=6, ny=6, nz=6, nt=1,
                    bounds=("open", "periodic", "reflective"))
    r, p = _species(geom, 0.3, seed=1, ppc=10, dtype=dtype)
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    z = np.zeros((3,) + geom.shape)
    *_, sp = state_from_numpy(z, z, z, r, p, np.ones(len(r), bool),
                              device="cpu", dtype=tdt)
    jst = _jax_binned(r, p, geom, 16)
    tst = TB.bin_state(sp, geom, 16)
    _same_state(tst, jst)
    jflat, tflat = JB.unbin_state(jst, geom), TB.unbin_state(tst, geom)
    assert np.array_equal(tflat.r.numpy(), np.asarray(jflat.r))
    assert np.array_equal(tflat.alive.numpy(), np.asarray(jflat.alive))
    _same_state(TB._drift_impl(tst, geom), JB._drift_impl(jst, geom))
    s_t, l_t = TB._rebin_global(TB._drift_impl(tst, geom), geom)
    s_j, l_j = JB._rebin_global(JB._drift_impl(jst, geom), geom)
    _same_state(s_t, s_j, l_t, l_j)


@pytest.fixture(scope="module")
def storm_steps():
    """Two drift + neighbor-rebin steps of a thermal state through the
    JAX exchange (interpret mode), with each step's input."""
    r, p = _species(GEOM, 0.05, seed=3)
    st = _jax_binned(r, p, GEOM, 40)
    steps = []
    for _ in range(2):
        st = JB._drift_impl(st, GEOM)
        ok, _, _ = JNR.neighbor_guard_stats(st, GEOM)
        out, load = JNR.rebin_neighbor(st, GEOM, interpret=True)
        steps.append((st, bool(ok), out, load))
        st = out
    return steps


def test_neighbor_twin_bitwise_over_steps(storm_steps):
    for st, ok, out, load in storm_steps:
        tst = _port(st)
        assert bool(TNR.neighbor_guard_stats(tst, GEOM)[0]) == ok
        s_t, l_t = TNR.rebin_neighbor(tst, GEOM)
        _same_state(s_t, out, l_t, load)


def test_extract_and_place_twins_each_axis(storm_steps):
    """Each axis pass's extract and place twins against the JAX kernels
    on the same buffer (AT = 16, so the JAX side packs 8 cells a row)."""
    st, *_ = storm_steps[0]
    G, K = st.valid.shape
    AT = JNR._buffer_cols(K)
    rng = np.random.default_rng(0)
    buf = np.zeros((G, 8, AT), np.float32)
    live = rng.random((G, AT)) < 0.5
    for a, n in enumerate((GEOM.nx, GEOM.ny, GEOM.nz)):
        home = np.asarray(JNR._home_coord(GEOM, a)).reshape(G, 1)
        step = rng.integers(-1, 2, (G, AT))
        buf[:, a] = (home + step) % n + rng.random((G, AT), np.float32)
    buf[:, 3:6] = rng.standard_normal((G, 3, AT))
    buf[:, 6] = live
    buf[:, :6] *= live[:, None, :]
    pack = JNR._pack_factor(GEOM.nx, AT)
    Pj = jnp.asarray(buf.reshape(G // pack, pack, 8, AT).transpose(0, 2, 1, 3)
                     .reshape(G // pack, 8, pack * AT))
    for axis_ch, grid_axis, n_ax, _ in JNR._axes(GEOM):
        home = JNR._home_coord_packed(GEOM, axis_ch, pack)[:, None]
        oj, uj, dj = JNR._extract_pass(Pj, home, axis_ch=axis_ch, n_ax=n_ax,
                                       seg=AT, pack=pack, interpret=True)
        ot, ut, dt_ = TNR.extract_plain(torch.as_tensor(buf), GEOM, axis_ch)

        def unpack(x, w):
            return np.asarray(x).reshape(G // pack, 8, pack, w) \
                .transpose(0, 2, 1, 3).reshape(G, 8, w)

        assert np.array_equal(ot.numpy(), unpack(oj, AT))
        assert np.array_equal(ut.numpy(), unpack(uj, 8))
        assert np.array_equal(dt_.numpy(), unpack(dj, 8))
        up_r = JNR._roll_cells(uj, GEOM, grid_axis, +1, pack, interpret=True)
        dn_r = JNR._roll_cells(dj, GEOM, grid_axis, -1, pack, interpret=True)
        pj = JNR._place_pass(oj, up_r, dn_r, seg=AT, pack=pack,
                             interpret=True)
        pt = TNR.place_plain(ot, ut, dt_, GEOM, axis_ch)
        assert np.array_equal(pt.numpy(), unpack(pj, AT))


def test_guard_far_movers_falls_back():
    geom = Geometry(dx=0.5, dy=0.5, dz=0.5, dt=1.5, nx=8, ny=8, nz=8, nt=1)
    r, p = _species(geom, 2.0, seed=3)
    st = JB._drift_impl(_jax_binned(r, p, geom, 40), geom)
    tst = _port(st)
    assert int(TNR.far_mover_count(tst, geom)) == \
        int(JNR.far_mover_count(st, geom)) > 0
    assert [int(v) for v in TNR.neighbor_guard_stats(tst, geom)] == \
        [int(v) for v in JNR.neighbor_guard_stats(st, geom)]
    s_t, l_t = TB._rebin_neighbor_guarded(tst, geom)
    s_j, l_j = JB._rebin_global(st, geom)
    _same_state(s_t, s_j, l_t, l_j)


def test_guard_transit_overflow_falls_back():
    """K = 40 (AT = 16): per-origin counts fit but a cell's buffer
    overflows in transit after the x pass; the guard must see it."""
    geom = Geometry(dx=1.0, dy=1.0, dz=1.0, dt=1.0, nx=8, ny=6, nz=4, nt=1)
    tx, ty, tz = 4, 2, 1
    rows, vels = [], []
    for x0, vx in ((tx, 0.0), (tx - 1, 1.0), (tx + 1, -1.0)):
        for k in range(8):
            rows.append([x0 + 0.5, ty + 0.3 + 0.02 * k, tz + 0.5])
            vels.append([vx, 1.0, 0.0])
    st = JB._drift_impl(_jax_binned(np.array(rows, np.float32),
                                    np.array(vels, np.float32), geom, 40),
                        geom)
    tst = _port(st)
    assert TNR._buffer_cols(40) == 16
    ok_j = JNR.neighbor_guard_stats(st, geom)
    ok_t = TNR.neighbor_guard_stats(tst, geom)
    assert [int(v) for v in ok_t] == [int(v) for v in ok_j]
    assert not bool(ok_t[0])
    s_t, l_t = TNR.rebin_neighbor(tst, geom)
    s_j, l_j = JNR.rebin_neighbor(st, geom, interpret=True)
    _same_state(s_t, s_j, l_t, l_j)
    assert int(l_t[1]) > 0
    s_t, l_t = TB._rebin_neighbor_guarded(tst, geom)
    s_j, l_j = JB._rebin_global(st, geom)
    _same_state(s_t, s_j, l_t, l_j)
    assert int(l_t[1]) == 0


def test_guard_matches_on_storm():
    """Hot storm (v dt/dx ~ 15%): the guard's verdict equals JAX's and
    the exchange outcome, both ways."""
    r, p = _species(GEOM, 0.05, seed=11)
    st = _jax_binned(r, p, GEOM, 40)
    verdicts = []
    for _ in range(4):
        st = JB._drift_impl(st, GEOM)
        tst = _port(st)
        ok_j = JNR.neighbor_guard_stats(st, GEOM)
        ok_t = TNR.neighbor_guard_stats(tst, GEOM)
        assert [int(v) for v in ok_t] == [int(v) for v in ok_j]
        s_t, l_t = TNR.rebin_neighbor(tst, GEOM)
        assert bool(ok_t[0]) == (int(l_t[1]) == 0)
        verdicts.append(bool(ok_t[0]))
        st, _ = JB._rebin_global(st, GEOM)
    assert not all(verdicts)


def test_full_axis_traversal_is_far_on_reflective_axis():
    geom = Geometry(dx=1.0, dy=1.0, dz=1.0, dt=1.0, nx=6, ny=4, nz=4, nt=1,
                    bounds=("reflective", "periodic", "periodic"))
    st = _jax_binned(np.array([[0.5, 1.5, 1.5]], np.float32),
                     np.zeros((1, 3), np.float32), geom, 8)
    r2 = st.r.at[:, :, 0].set(jnp.where(st.valid, geom.nx - 0.5,
                                        st.r[:, :, 0]))
    st = dataclasses.replace(st, r=r2)
    tst = _port(st)
    assert int(TNR.far_mover_count(tst, geom)) == 1
    assert not bool(TNR.neighbor_guard_stats(tst, geom)[0])
    s_t, l_t = TB._rebin_neighbor_guarded(tst, geom)
    s_j, l_j = JB._rebin_global(st, geom)
    _same_state(s_t, s_j, l_t, l_j)
