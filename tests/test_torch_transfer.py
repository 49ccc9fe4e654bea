"""The port's particle<->grid transfers and matrix-free mass operator
against the JAX package (f64, 1e-12 relative)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xpic_tpu.config import Geometry
from xpic_tpu.ops import gather_scatter as jgs
from xpic_tpu.ops import mass_free as jmf
from xpic_tpu_torch.ops import gather_scatter as tgs
from xpic_tpu_torch.ops import mass_free as tmf

torch.set_num_threads(1)

Q, M, MPW, DT = -1.0, 1.0, 0.1, 1.5
BOUNDS = [("periodic",) * 3, ("ghosted", "periodic", "reflective")]


def _close(got, ref, tol=1e-12):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(1e-300, float(np.abs(ref).max()))
    assert np.abs(got - ref).max() <= tol * scale


@pytest.fixture(scope="module", params=BOUNDS, ids=lambda b: b[0])
def case(request):
    geom = Geometry(dx=0.5, dy=0.4, dz=0.6, dt=DT, nx=6, ny=5, nz=4, nt=1,
                    bounds=request.param)
    rng = np.random.default_rng(7)
    G, K = geom.n_cells, 8
    cells = np.stack(np.unravel_index(np.arange(G), geom.shape)[::-1], -1)
    rg = cells[:, None, :] + rng.random((G, K, 3))
    return dict(
        geom=geom,
        rg=rg,
        valid=rng.random((G, K)) < 0.8,
        F=rng.standard_normal((3,) + geom.shape),
        x=rng.standard_normal((3,) + geom.shape),
        vals=rng.standard_normal((G, K, 3)),
        B_p=rng.standard_normal((G, K, 3)),
        v=rng.standard_normal((G, K, 3)) * 0.1,
    )


def _both(case):
    geom = case["geom"]
    tj = jgs.cell_t(geom, jnp.asarray(case["rg"]))
    tt = tgs.cell_t(geom, torch.as_tensor(case["rg"]))
    _close(tt, tj, 0)
    return geom, tj, tt


def test_gather_vector(case):
    geom, tj, tt = _both(case)
    for stagger in (jgs.B_STAGGER, jgs.E_STAGGER):
        ref = jgs.gather_vector(jnp.asarray(case["F"]), tj,
                                jnp.asarray(case["valid"]), geom, order=1,
                                width=3, anchor=-1, stagger=stagger)
        got = tgs.gather_vector(torch.as_tensor(case["F"]), tt,
                                torch.as_tensor(case["valid"]), geom,
                                order=1, width=3, anchor=-1, stagger=stagger)
        _close(got, ref)


def test_deposit_vector(case):
    geom, tj, tt = _both(case)
    ref = jgs.deposit_vector(jnp.asarray(case["vals"]), tj,
                             jnp.asarray(case["valid"]), geom, order=2,
                             width=4, anchor=-1)
    got = tgs.deposit_vector(torch.as_tensor(case["vals"]), tt,
                             torch.as_tensor(case["valid"]), geom, order=2,
                             width=4, anchor=-1)
    _close(got, ref)


def test_blocks_to_grid(case):
    geom = case["geom"]
    blk = np.random.default_rng(8).standard_normal((geom.n_cells, 3, 3, 3,
                                                    3))
    _close(tgs.blocks_to_grid(torch.as_tensor(blk), geom, 3, -1),
           jgs.blocks_to_grid(jnp.asarray(blk), geom, 3, -1))


def test_slot_transfers(case):
    geom, tj, tt = _both(case)
    _close(tmf.deposit_vector_slots(torch.as_tensor(case["vals"]), tt, geom),
           jmf.deposit_vector_slots(jnp.asarray(case["vals"]), tj, geom))
    _close(tmf.gather_vector_slots(torch.as_tensor(case["F"]), tt, geom),
           jmf.gather_vector_slots(jnp.asarray(case["F"]), tj, geom))


def test_mass_operator(case):
    geom, tj, tt = _both(case)
    kw = dict(q=Q, m=M, mpw=MPW, dt=DT)
    Bj, Bt = jnp.asarray(case["B_p"]), torch.as_tensor(case["B_p"])
    vj, vt = jnp.asarray(case["valid"]), torch.as_tensor(case["valid"])
    opj = jmf.mass_operands(tj, Bj, vj, **kw)
    opt = tmf.mass_operands(tt, Bt, vt, **kw)
    _close(opt.packed, opj.packed)
    _close(tmf.mass_trace(opt), jmf.mass_trace(opj))
    _close(tmf.mass_apply(torch.as_tensor(case["x"]), (opt, opt), geom),
           jmf.mass_apply(jnp.asarray(case["x"]), (opj, opj), geom))
    _close(tmf.implicit_current(Bt, torch.as_tensor(case["v"]), vt, **kw),
           jmf.implicit_current(Bj, jnp.asarray(case["v"]), vj, **kw))
