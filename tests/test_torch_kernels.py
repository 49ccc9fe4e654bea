"""Each hand-written CUDA kernel against its plain PyTorch twin on the
card (marked ``gpu``; skipped where there is no CUDA device).

The rebin kernels must match their twins bit for bit through the whole
exchange at AT = 16 and AT = 32; the Chebyshev kernel to 1e-5 relative
(nvcc contracts multiply-adds into FMAs, which round once).
"""

import numpy as np
import pytest
import torch

from xpic_tpu_torch import kernels
from xpic_tpu_torch.config import Geometry
from xpic_tpu_torch.convert import state_from_numpy
from xpic_tpu_torch.ops import neighbor_rebin as NR
from xpic_tpu_torch.ops.binning import bin_state, drift_state
from xpic_tpu_torch.ops.stencil_kernel import (
    cheb_matM_inv,
    cheb_matM_inv_plain,
)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kernels.load()
    return torch.device("cuda", 0)


def _state(geom, ppc, vth, slots, dev):
    rng = np.random.default_rng(4)
    n = geom.n_cells * ppc
    r = rng.random((n, 3)) * np.array(geom.L)
    p = rng.standard_normal((n, 3)) * vth
    z = np.zeros(1)
    *_, sp = state_from_numpy(z, z, z, r, p, np.ones(n, bool), device=dev,
                              dtype=torch.float32)
    return drift_state(bin_state(sp, geom, slots), geom)


@pytest.mark.parametrize("ppc,slots", [(20, 40), (50, 80)],
                         ids=["AT16", "AT32"])
@pytest.mark.parametrize("shape", [(32, 32, 32), (8, 6, 4)],
                         ids=["32cube", "8x6x4"])
def test_rebin_kernels_match_twins(dev, ppc, slots, shape):
    nx, ny, nz = shape
    geom = Geometry(dx=0.5, dy=0.5, dz=0.5, dt=1.5, nx=nx, ny=ny, nz=nz,
                    nt=1)
    st = _state(geom, ppc, 0.05, slots, dev)
    before = dict(kernels.LAUNCHES)
    s_k, l_k = NR.rebin_neighbor(st, geom)
    s_p, l_p = NR.rebin_neighbor(st, geom, plain=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["rebin_extract"] == before["rebin_extract"] + 3
    assert kernels.LAUNCHES["rebin_place"] == before["rebin_place"] + 3
    assert torch.equal(s_k.valid, s_p.valid)
    assert torch.equal(s_k.r, s_p.r) and torch.equal(s_k.p, s_p.p)
    assert torch.equal(l_k, l_p)
    # each axis pass on its own, both roll directions
    _, _, buf, _ = NR.partition_movers(st, geom)
    for axis in range(3):
        ok, uk, dk = NR.rebin_extract(buf, geom, axis)
        op, up, dp = NR.extract_plain(buf, geom, axis)
        assert torch.equal(ok, op) and torch.equal(uk, up) \
            and torch.equal(dk, dp)
        assert torch.equal(NR.rebin_place(ok, uk, dk, geom, axis),
                           NR.place_plain(op, up, dp, geom, axis))
        buf = NR.place_plain(op, up, dp, geom, axis)


@pytest.mark.parametrize("bounds", [("periodic",) * 3,
                                    ("ghosted", "periodic", "reflective")],
                         ids=lambda b: b[0])
def test_cheb_kernel_matches_twin(dev, bounds):
    geom = Geometry(dx=0.5, dy=0.4, dz=0.6, dt=1.5, nx=32, ny=32, nz=32,
                    nt=1, bounds=bounds)
    rng = np.random.default_rng(5)
    rhs = torch.tensor(rng.standard_normal((3,) + geom.shape),
                       dtype=torch.float32, device=dev)
    shift = torch.tensor(0.37, dtype=torch.float32, device=dev)
    got = cheb_matM_inv(rhs, shift, geom=geom, degree=12, dt=geom.dt)
    ref = cheb_matM_inv_plain(rhs, shift, geom=geom, degree=12, dt=geom.dt)
    rel = float((got - ref).abs().max() / ref.abs().max())
    assert rel <= 1e-5


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    geom = Geometry(dx=0.5, dy=0.5, dz=0.5, dt=1.5, nx=4, ny=4, nz=4, nt=1)
    rhs64 = torch.zeros((3, 4, 4, 4), dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        cheb_matM_inv(rhs64, 0.0, geom=geom, degree=2, dt=geom.dt)
    buf = torch.zeros((geom.n_cells, 8, 12), device=dev)
    with pytest.raises(ValueError):
        NR.rebin_extract(buf, geom, 0)
