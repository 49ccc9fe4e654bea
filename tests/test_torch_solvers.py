"""The port's Krylov solvers and Chebyshev preconditioner against the JAX
package.  GMRES must take the same iterations and agree to 1e-12 in
f64; the Chebyshev twin must match the JAX Pallas kernel (interpret
mode) to 1e-5 relative in f32 and the XLA recurrence to 1e-12 in f64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xpic_tpu.config import Geometry
from xpic_tpu.ops.pallas_stencil import cheb_matM_inv_pallas
from xpic_tpu.solvers import cg as jcg
from xpic_tpu.solvers import gmres as jgmres
from xpic_tpu.solvers import spectral as jspectral
from xpic_tpu_torch.ops.stencil_kernel import cheb_matM_inv_plain
from xpic_tpu_torch.solvers import cg as tcg
from xpic_tpu_torch.solvers import gmres as tgmres
from xpic_tpu_torch.solvers.spectral import (
    make_matM_preconditioner,
    matM_bounds,
)

torch.set_num_threads(1)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _nonsymmetric():
    rng = np.random.default_rng(1)
    n = 40
    A = np.eye(n) * 4 + 0.5 * rng.standard_normal((n, n))
    return A, rng.standard_normal(n), dict(rtol=1e-9, atol=1e-12, maxit=200,
                                           restart=20)


def _multidim():
    rng = np.random.default_rng(2)
    shape = (3, 4, 4, 4)
    diag = 3.0 + rng.random(shape)
    return diag, rng.standard_normal(shape), dict(rtol=1e-10, atol=1e-13,
                                                  maxit=50)


@pytest.mark.parametrize("case", ["nonsymmetric", "multidim",
                                  "preconditioned"])
def test_gmres_matches_jax(case):
    if case == "multidim":
        diag, b, kw = _multidim()
        mj = lambda x: jnp.asarray(diag) * x  # noqa: E731
        dt_ = torch.as_tensor(diag)
        mt = lambda x: dt_ * x  # noqa: E731
        pj = pt = None
    else:
        A, b, kw = _nonsymmetric()
        mj = lambda x: jnp.asarray(A) @ x  # noqa: E731
        At = torch.as_tensor(A)
        mt = lambda x: At @ x  # noqa: E731
        pj = pt = None
        if case == "preconditioned":
            d = np.diag(A)
            pj = lambda v: v / jnp.asarray(d)  # noqa: E731
            dt_ = torch.tensor(d)
            pt = lambda v: v / dt_  # noqa: E731
    ref = jgmres(mj, jnp.asarray(b), M_inv=pj, **kw)
    got = tgmres(mt, torch.as_tensor(b), M_inv=pt, **kw)
    assert got.converged and bool(ref.converged)
    assert got.iterations == int(ref.iterations)
    assert _rel(got.x.numpy(), ref.x) <= 1e-12


def test_cg_matches_jax():
    rng = np.random.default_rng(0)
    n = 40
    A = rng.standard_normal((n, n))
    A = A @ A.T + n * np.eye(n)
    b = rng.standard_normal(n)
    ref = jcg(lambda x: jnp.asarray(A) @ x, jnp.asarray(b), rtol=1e-10,
              atol=1e-12, maxit=200)
    At = torch.as_tensor(A)
    got = tcg(lambda x: At @ x, torch.as_tensor(b), rtol=1e-10, atol=1e-12,
              maxit=200)
    assert got.converged and got.iterations == int(ref.iterations)
    assert _rel(got.x.numpy(), ref.x) <= 1e-12


BOUNDS = [("periodic",) * 3, ("ghosted", "periodic", "reflective")]


@pytest.mark.parametrize("bounds", BOUNDS, ids=lambda b: b[0])
def test_cheb_plain_matches_pallas_f32(bounds):
    geom = Geometry(dx=0.5, dy=0.4, dz=0.6, dt=1.5, nx=16, ny=8, nz=8,
                    nt=1, bounds=bounds)
    rng = np.random.default_rng(11)
    rhs = rng.standard_normal((3,) + geom.shape).astype(np.float32)
    ref = jax.jit(lambda r, s: cheb_matM_inv_pallas(
        r, s, geom=geom, degree=12, dt=geom.dt, interpret=True))(
        jnp.asarray(rhs), jnp.float32(0.37))
    got = cheb_matM_inv_plain(torch.as_tensor(rhs),
                              torch.tensor(0.37, dtype=torch.float32),
                              geom=geom, degree=12, dt=geom.dt)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("bounds", BOUNDS, ids=lambda b: b[0])
def test_cheb_plain_matches_xla_f64(bounds):
    geom = Geometry(dx=0.5, dy=0.4, dz=0.6, dt=1.5, nx=6, ny=5, nz=4,
                    nt=1, bounds=bounds)
    rng = np.random.default_rng(12)
    rhs = rng.standard_normal((3,) + geom.shape)
    ref = jspectral.make_matM_preconditioner(geom, geom.dt,
                                             dtype=jnp.float64)(
        jnp.asarray(rhs), 0.37)
    shift = torch.tensor(0.37, dtype=torch.float64)
    got = make_matM_preconditioner(geom, geom.dt)(torch.as_tensor(rhs),
                                                  shift)
    assert _rel(got.numpy(), ref) <= 1e-12


@pytest.mark.parametrize("shift", [0.0, 0.37])
def test_matM_bounds_match_jax(shift):
    geom = Geometry(dx=0.5, dy=0.4, dz=0.6, dt=1.5, nx=6, ny=5, nz=4, nt=1)
    assert matM_bounds(geom, geom.dt, shift) == \
        jspectral.matM_bounds(geom, geom.dt, shift)
