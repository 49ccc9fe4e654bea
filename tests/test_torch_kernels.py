"""Each hand-written CUDA kernel against its plain PyTorch twin on the
card (marked ``gpu``; skipped where there is no CUDA device).

The rebin kernels must match their twins bit for bit through the whole
exchange at AT = 16, 32 and 128; the Chebyshev kernel to 1e-5 relative
(nvcc contracts multiply-adds into FMAs, which round once); the mass
apply to 1e-5 of max |Y| (its K-sums run in another order than the
twin's), the slot gather to 2e-6 of max |E_p|, the segment-field
gather to 1e-5 of max |E_p| and max |B_p| (FMAs, and the segment
weights applied in another order), and the ECSIM fill to 1e-5 of
max |L| and of max |Islot| (its slot sums run in slot order, the twin's
in batched products).

    python -m pytest --noconftest -o addopts="" tests/test_torch_kernels.py -q
"""

import numpy as np
import pytest
import torch

from xpic_tpu_torch import kernels
from xpic_tpu_torch.config import Geometry
from xpic_tpu_torch.convert import state_from_numpy
from xpic_tpu_torch.ops import neighbor_rebin as NR
from xpic_tpu_torch.ops.binning import bin_state, drift_state
from xpic_tpu_torch.ops.ecsim_kernel import (
    ecsim_fill,
    ecsim_fill_plain,
    ecsim_gather,
    ecsim_gather_plain,
)
from xpic_tpu_torch.ops.implicit_esirkepov import gather_window_blocks
from xpic_tpu_torch.ops.mass_kernel import (
    mass_apply_slots,
    mass_apply_slots_plain,
)
from xpic_tpu_torch.ops.segment_kernel import (
    segment_fields,
    segment_fields_plain,
)
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


@pytest.mark.parametrize("ppc,slots", [(20, 40), (50, 80), (130, 200)],
                         ids=["AT16", "AT32", "AT128"])
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
    G = geom.n_cells
    xg = torch.zeros((G, 3, 12), device=dev)
    packed = torch.zeros((G, 8, 16), device=dev)
    with pytest.raises(TypeError):
        mass_apply_slots(xg.double(), packed.double())
    with pytest.raises(ValueError):
        mass_apply_slots(xg[:, :, :8].contiguous(), packed)
    with pytest.raises(ValueError):
        mass_apply_slots(xg, packed[:, :7].contiguous())
    with pytest.raises(ValueError):
        mass_apply_slots(xg, packed.transpose(0, 2).contiguous()
                         .transpose(0, 2))
    t = torch.zeros((G, 16, 3), device=dev)
    with pytest.raises(TypeError):
        ecsim_gather(t.double(), xg)
    with pytest.raises(ValueError):
        ecsim_gather(t, xg[:G // 2])
    with pytest.raises(ValueError):
        ecsim_gather(t[:, :, :2].contiguous(), xg)


def _slot_inputs(G, K, dev, seed):
    """Packed mass operands [G, 8, K] of a species with |B| ~ 0.2 and
    empty slots (coef 0, t at the cell centre), slot values xg, and the
    positions t [G, K, 3]."""
    rng = np.random.default_rng(seed)
    valid = rng.random((G, K)) < 0.6
    t = np.where(valid[..., None], rng.random((G, K, 3)), 0.5)
    b = -0.75 * 0.2 * rng.standard_normal((G, K, 3))
    coef = np.where(valid, 0.0225 / (1.0 + np.sum(b * b, axis=-1)), 0.0)
    packed = np.concatenate(
        [np.moveaxis(t, -1, 1), np.moveaxis(b, -1, 1), coef[:, None, :],
         np.zeros((G, 1, K))], axis=1)
    xg = rng.standard_normal((G, 3, 12))

    def f32(a):  # concatenate keeps the moved axes' strides
        return torch.tensor(np.ascontiguousarray(a), dtype=torch.float32,
                            device=dev)

    return f32(packed), f32(xg), f32(t)


@pytest.mark.parametrize("K", [80, 96, 200])
def test_mass_apply_kernel_matches_twin(dev, K):
    packed, xg, _ = _slot_inputs(16 ** 3, K, dev, seed=K)
    before = kernels.LAUNCHES["mass_apply"]
    got = mass_apply_slots(xg, packed)
    ref = mass_apply_slots_plain(xg, packed)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mass_apply"] == before + 1
    assert got.shape == ref.shape == (16 ** 3, 3, 12)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("K", [80, 96])
def test_slot_gather_kernel_matches_twin(dev, K):
    _, xg, t = _slot_inputs(16 ** 3, K, dev, seed=K + 1)
    before = kernels.LAUNCHES["slot_gather"]
    got = ecsim_gather(t, xg)
    ref = ecsim_gather_plain(t, xg)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["slot_gather"] == before + 1
    assert got.shape == ref.shape == (16 ** 3, K, 3)
    assert float((got - ref).abs().max()) <= 2e-6 * float(ref.abs().max())


@pytest.mark.parametrize("kp", [8, 32, 40])
@pytest.mark.parametrize("shape", [(16, 16, 16), (8, 6, 4)],
                         ids=["16cube", "8x6x4"])
def test_segment_fields_kernel_matches_twin(dev, kp, shape):
    """K' = kp columns of a [G, 40, 3] move, read in place (kp < 40) or
    whole; moves up to 0.9 cell a axis, the first 3 slots at rest."""
    nx, ny, nz = shape
    geom = Geometry(dx=0.5, dy=0.4, dz=0.6, dt=1.5, nx=nx, ny=ny, nz=nz,
                    nt=1)
    G = geom.n_cells
    rng = np.random.default_rng(kp)

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    E = f32(rng.standard_normal((3,) + geom.shape))
    B = f32(rng.standard_normal((3,) + geom.shape))
    t0 = f32(rng.random((G, 40, 3)))
    move = rng.uniform(-0.9, 0.9, (G, 40, 3))
    move[:, :3] = 0.0
    tn = t0 + f32(move)
    Eblk, Bblk = gather_window_blocks(E, geom), gather_window_blocks(B, geom)
    before = kernels.LAUNCHES["segment_fields"]
    got = segment_fields(Eblk, Bblk, t0[:, :kp], tn[:, :kp])
    ref = segment_fields_plain(Eblk, Bblk, t0[:, :kp], tn[:, :kp])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["segment_fields"] == before + 1
    for g, r in zip(got, ref):
        assert g.shape == (G, kp, 3)
        assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max())


def _fill_inputs(G, K, dev, seed, empty_cell=None):
    """t, v, B_p [G, K, 3] (|b| ~ 0.2 at q/m = -1, dt = 1.5) and valid
    [G, K] with 70 % live slots; every slot of ``empty_cell`` invalid."""
    rng = np.random.default_rng(seed)
    valid = rng.random((G, K)) < 0.7
    if empty_cell is not None:
        valid[empty_cell] = False

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    return (f32(rng.random((G, K, 3))),
            f32(0.05 * rng.standard_normal((G, K, 3))),
            f32(0.25 * rng.standard_normal((G, K, 3))),
            torch.tensor(valid, device=dev))


@pytest.mark.parametrize("K", [16, 80, 96, 112, 200])
def test_ecsim_fill_kernel_matches_twin(dev, K):
    """L and Islot within 1e-5 of their largest magnitudes, K past the
    kernel's 32-slot chunk included; cell 3 has no live slot."""
    t, v, B_p, valid = _fill_inputs(16 ** 3, K, dev, seed=K, empty_cell=3)
    kw = dict(q=-1.0, m=1.0, mpw=0.02, dt=1.5)
    before = kernels.LAUNCHES["ecsim_fill"]
    L, Islot = ecsim_fill(t, v, B_p, valid, **kw)
    L_p, Islot_p = ecsim_fill_plain(t, v, B_p, valid, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ecsim_fill"] == before + 1
    assert L.shape == (16 ** 3, 3, 12, 3, 12)
    assert Islot.shape == (16 ** 3, 3, 12)
    assert float((L - L_p).abs().max()) <= 1e-5 * float(L_p.abs().max())
    assert float((Islot - Islot_p).abs().max()) <= \
        1e-5 * float(Islot_p.abs().max())
    assert not bool(L[3].any()) and not bool(Islot[3].any())


def test_ecsim_fill_wrapper_rejects_what_the_kernel_does_not_take(dev):
    t, v, B_p, valid = _fill_inputs(64, 16, dev, seed=1)
    kw = dict(q=-1.0, m=1.0, mpw=0.02, dt=1.5)
    with pytest.raises(TypeError):
        ecsim_fill(t.double(), v.double(), B_p.double(), valid, **kw)
    with pytest.raises(ValueError):  # valid not bool
        ecsim_fill(t, v, B_p, valid.float(), **kw)
    with pytest.raises(ValueError):  # B_p of another K
        ecsim_fill(t, v, B_p[:, :8].contiguous(), valid, **kw)
    big = torch.zeros((4, 513, 3), device=dev)
    with pytest.raises(ValueError):  # K past 512
        ecsim_fill(big, big, big, torch.ones((4, 513), dtype=torch.bool,
                                             device=dev), **kw)


def test_segment_fields_wrapper_rejects_what_the_kernel_does_not_take(dev):
    geom = Geometry(dx=0.5, dy=0.5, dz=0.5, dt=1.5, nx=4, ny=4, nz=4, nt=1)
    G = geom.n_cells
    blk = torch.zeros((G, 3, 6, 6, 6), device=dev)
    t = torch.zeros((G, 16, 3), device=dev)
    with pytest.raises(TypeError):
        segment_fields(blk.double(), blk, t, t)
    with pytest.raises(TypeError):
        segment_fields(blk, blk, t.double(), t.double())
    with pytest.raises(ValueError):
        segment_fields(blk[: G // 2], blk, t, t)
    with pytest.raises(ValueError):  # slots not contiguous
        segment_fields(blk, blk, t[:, ::2], t[:, ::2])
    with pytest.raises(ValueError):  # different row strides
        segment_fields(blk, blk, t[:, :8], t[:, :8].contiguous())
