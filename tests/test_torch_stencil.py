"""The port's grid operators and splines against the JAX package (f64)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xpic_tpu.config import Geometry
from xpic_tpu.ops import splines as jsp
from xpic_tpu.ops import stencil as jst
from xpic_tpu_torch.ops import splines as tsp
from xpic_tpu_torch.ops import stencil as tst

torch.set_num_threads(1)

KINDS = ("periodic", "ghosted")
BOUNDS = list(itertools.product(KINDS, repeat=3))


def _close(got, ref, tol=1e-14):
    got = got.numpy()
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * scale


@pytest.mark.parametrize("order", range(6))
def test_splines_match(order):
    s = np.linspace(-3.5, 3.5, 301)
    _close(tsp.spline(order)(torch.as_tensor(s)),
           jsp.spline(order)(jnp.asarray(s)))
    assert tsp.shape_width(order) == jsp.shape_width(order)


@pytest.mark.parametrize("bounds", BOUNDS, ids=lambda b: "-".join(b))
def test_stencil_ops_match(bounds):
    rng = np.random.default_rng(5)
    shape = (3, 4, 5, 6)
    F = rng.standard_normal(shape)
    f = rng.standard_normal(shape[1:])
    steps = (0.5, 0.4, 0.3)
    Ft, Fj = torch.as_tensor(F), jnp.asarray(F)
    ft, fj = torch.as_tensor(f), jnp.asarray(f)
    for axis, (b, by) in itertools.product(
            "xyz", itertools.product(KINDS, (-1, 0, 1, 2))):
        _close(tst.shift(Ft, axis, by, b), jst.shift(Fj, axis, by, b))
    for name in ("curl_positive", "curl_negative", "divergence_positive",
                 "divergence_negative"):
        _close(getattr(tst, name)(Ft, steps, bounds),
               getattr(jst, name)(Fj, steps, bounds))
    for name in ("gradient_positive", "gradient_negative"):
        _close(getattr(tst, name)(ft, steps, bounds),
               getattr(jst, name)(fj, steps, bounds))


def test_geometry_copied():
    from xpic_tpu_torch.config import Geometry as TGeometry

    kw = dict(dx=0.5, dy=0.4, dz=0.3, dt=1.5, nx=8, ny=6, nz=4, nt=2)
    g, t = Geometry(**kw), TGeometry(**kw)
    assert (t.shape, t.n_cells, t.L, t.cell_steps) == \
        (g.shape, g.n_cells, g.L, g.cell_steps)
