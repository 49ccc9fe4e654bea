"""Each hand-written CUDA kernel against its plain PyTorch twin on the
card (marked ``gpu``; skipped where there is no CUDA device).

The rebin kernels must match their twins bit for bit through the whole
exchange at AT = 16, 32 and 128; the Chebyshev kernel to 1e-5 relative
(nvcc contracts multiply-adds into FMAs, which round once) from 8^3 to
64^3, bitwise from run to run, in one launch an apply; the mass
apply to 1e-5 of max |Y| (its K-sums run in another order than the
twin's), the slot gather to 2e-6 of max |E_p|, the segment-field
gather to 1e-5 of max |E_p| and max |B_p| (FMAs, and the segment
weights applied in another order), and the ECSIM fill to 1e-5 of
max |L| and of max |Islot| (its slot sums run on tensor cores in
3xTF32, the twin's in batched float32 products), two calls bitwise
equal.  The primitive-rate probes match their twins
bitwise for copy, roll8 and select16, and within 1e-5 of max |out| for
fma16, fma64 (FMA contraction) and reduce16 (another summation order).
The four kernels with a float64 instantiation (Chebyshev, slot gather,
segment fields, fill) are also held against their twins in float64, on
the same inputs cast, within 1e-12 of the output's max; the wrappers
take float64 and refuse float16 and bfloat16.  The Chebyshev kernel's
slab form (a deep-ghost exchange and a cooperative launch a segment,
ceil(11 / min(11, t)) of each an apply on t planes) and the place
kernel's ghost-plane z pass give the whole-grid kernels' bits on one
rank's slab of the whole grid.

    python -m pytest --noconftest -o addopts="" tests/test_torch_kernels.py -q
"""

import numpy as np
import pytest
import torch

from xpic_tpu_torch import kernels
from xpic_tpu_torch.benchmarks.prims import BITWISE, PRIMS, prim, prim_plain
from xpic_tpu_torch.benchmarks.profile_prims import make_input
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
from xpic_tpu_torch.ops.implicit_esirkepov import (
    gather_window_blocks,
    split_segments,
)
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

from torch_mesh_worker import one_rank_mesh

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
        if axis == 2:
            # The z pass on a slab's ghost planes: one rank's slab of a
            # periodic grid takes its own boundary planes as ghosts, and
            # the kernel's ghost-plane form gives the periodic pass.
            plane = nx * ny
            ug = torch.cat([uk[-plane:], uk])
            dg = torch.cat([dk, dk[:plane]])
            assert torch.equal(NR.rebin_place(ok, ug, dg, geom, 2, True),
                               NR.rebin_place(ok, uk, dk, geom, 2))
            assert torch.equal(NR.rebin_place(ok, ug, dg, geom, 2, True),
                               NR.place_plain(op, ug, dg, geom, 2, True))
        buf = NR.place_plain(op, up, dp, geom, axis)


@pytest.mark.parametrize("bounds", [("periodic",) * 3,
                                    ("ghosted", "periodic", "reflective")],
                         ids=lambda b: b[0])
def test_cheb_kernel_matches_twin(dev, bounds):
    """Within 1e-5 relative in float32 (``cheb_step``) and 1e-12 in
    float64 (``cheb_step_f64``), one launch of each an apply."""
    geom = Geometry(dx=0.5, dy=0.4, dz=0.6, dt=1.5, nx=32, ny=32, nz=32,
                    nt=1, bounds=bounds)
    rng = np.random.default_rng(5)
    rhs32 = torch.tensor(rng.standard_normal((3,) + geom.shape),
                         dtype=torch.float32, device=dev)
    for dtype, name, tol in ((torch.float32, "cheb_step", 1e-5),
                             (torch.float64, "cheb_step_f64", 1e-12)):
        rhs = rhs32.to(dtype)
        shift = torch.tensor(0.37, dtype=dtype, device=dev)
        before = kernels.LAUNCHES[name]
        got = cheb_matM_inv(rhs, shift, geom=geom, degree=12, dt=geom.dt)
        ref = cheb_matM_inv_plain(rhs, shift, geom=geom, degree=12,
                                  dt=geom.dt)
        assert kernels.LAUNCHES[name] == before + 1
        assert got.dtype == dtype
        rel = float((got - ref).abs().max() / ref.abs().max())
        assert rel <= tol, name
        # The slab form (``cheb_sweep``: a segment of sweeps a launch, one
        # ghost exchange a segment) on one rank's slab of the whole grid:
        # its own boundary planes as ghosts on a periodic z, none on the
        # reflective one; the one-launch bits on t = 1, 3, 8, 11, 16 and
        # the whole 32 planes, in ceil(11 / min(11, t)) launches and
        # exchanges.
        sweep = name.replace("cheb_step", "cheb_sweep")
        for t in (1, 3, 8, 11, 16, 32):
            tgeom = Geometry(dx=0.5, dy=0.4, dz=0.6, dt=1.5, nx=32, ny=32,
                             nz=t, nt=1, bounds=bounds)
            whole = got if t == geom.nz else cheb_matM_inv(
                rhs[:, :t].contiguous(), shift, geom=tgeom, degree=12,
                dt=geom.dt)
            mesh = one_rank_mesh(t, bounds[2] == "periodic")
            before = kernels.LAUNCHES[sweep]
            slab = cheb_matM_inv(rhs[:, :t].contiguous(), shift,
                                 geom=tgeom.slab(mesh), degree=12,
                                 dt=geom.dt)
            segments = -(-11 // min(11, t))
            assert kernels.LAUNCHES[sweep] == before + segments, (sweep, t)
            assert mesh.calls["cheb_ghosts"] == segments, (sweep, t)
            assert torch.equal(slab, whole), (sweep, t)


def test_cheb_kernel_one_launch_at_every_size(dev):
    """One cooperative launch an apply, from the 8^3 field to 64^3 (more
    elements than the card holds threads at once) and a non-cubic field,
    with periodic and with ghosted, periodic, reflective axes, at degrees
    1, 2 and 12: within 1e-5 relative of the twin, and bitwise equal from
    one apply to the next."""
    rng = np.random.default_rng(7)
    shift = torch.tensor(0.37, dtype=torch.float32, device=dev)
    for nx, ny, nz in [(8, 8, 8), (16, 16, 16), (32, 32, 32), (64, 64, 64),
                       (40, 24, 12)]:
        for bounds in [("periodic",) * 3,
                       ("ghosted", "periodic", "reflective")]:
            geom = Geometry(dx=0.5, dy=0.4, dz=0.6, dt=1.5, nx=nx, ny=ny,
                            nz=nz, nt=1, bounds=bounds)
            rhs = torch.tensor(rng.standard_normal((3,) + geom.shape),
                               dtype=torch.float32, device=dev)
            for degree in (1, 2, 12):
                kw = dict(geom=geom, degree=degree, dt=geom.dt)
                case = (nx, ny, nz, bounds[0], degree)
                before = kernels.LAUNCHES["cheb_step"]
                got = cheb_matM_inv(rhs, shift, **kw)
                assert kernels.LAUNCHES["cheb_step"] == before + 1, case
                again = cheb_matM_inv(rhs, shift, **kw)
                ref = cheb_matM_inv_plain(rhs, shift, **kw)
                rel = float((got - ref).abs().max() / ref.abs().max())
                assert rel <= 1e-5, case
                assert torch.equal(got, again), case


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    """float64 goes to the float64 kernels (Chebyshev, slot gather), and
    is refused by the kernels without one (mass apply); float16 and
    bfloat16 are refused by all; so is a mix of dtypes."""
    geom = Geometry(dx=0.5, dy=0.5, dz=0.5, dt=1.5, nx=4, ny=4, nz=4, nt=1)
    rhs64 = torch.zeros((3, 4, 4, 4), dtype=torch.float64, device=dev)
    assert cheb_matM_inv(rhs64, 0.0, geom=geom, degree=2,
                         dt=geom.dt).dtype == torch.float64
    for half in (torch.float16, torch.bfloat16):
        with pytest.raises(TypeError):
            cheb_matM_inv(rhs64.to(half), 0.0, geom=geom, degree=2,
                          dt=geom.dt)
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
    with pytest.raises(TypeError):  # float64 t, float32 slot values
        ecsim_gather(t.double(), xg)
    assert ecsim_gather(t.double(), xg.double()).dtype == torch.float64
    for half in (torch.float16, torch.bfloat16):
        with pytest.raises(TypeError):
            ecsim_gather(t.to(half), xg.to(half))
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
    """Y within 1e-5 of max |Y| at K and at the extra K of its row (1,
    33: a ragged last round; 112: the CLI's K), on an odd cell count (the
    last warp's second cell is absent), with cell 3 holding no live slot
    (Y exactly 0 there); two calls bitwise equal."""
    extra = {80: (1, 33), 96: (112,), 200: ()}[K]
    for k in (K, *extra):
        G = 16 ** 3 - 1
        packed, xg, _ = _slot_inputs(G, k, dev, seed=k)
        packed[3, 6] = 0.0  # coef 0: no live slot in cell 3
        before = kernels.LAUNCHES["mass_apply"]
        got = mass_apply_slots(xg, packed)
        again = mass_apply_slots(xg, packed)
        ref = mass_apply_slots_plain(xg, packed)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["mass_apply"] == before + 2
        assert got.shape == ref.shape == (G, 3, 12)
        assert torch.equal(got, again), k
        assert not bool(got[3].any()), k
        assert float((got - ref).abs().max()) <= 1e-5 * float(
            ref.abs().max()), k


@pytest.mark.parametrize("K", [80, 96])
def test_slot_gather_kernel_matches_twin(dev, K):
    """Within 2e-6 of max |E_p| in float32, 1e-12 in float64 (the same
    inputs cast)."""
    _, xg32, t32 = _slot_inputs(16 ** 3, K, dev, seed=K + 1)
    for dtype, name, tol in ((torch.float32, "slot_gather", 2e-6),
                             (torch.float64, "slot_gather_f64", 1e-12)):
        xg, t = xg32.to(dtype), t32.to(dtype)
        before = kernels.LAUNCHES[name]
        got = ecsim_gather(t, xg)
        ref = ecsim_gather_plain(t, xg)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[name] == before + 1
        assert got.shape == ref.shape == (16 ** 3, K, 3)
        assert got.dtype == dtype
        assert float((got - ref).abs().max()) <= \
            tol * float(ref.abs().max()), name


@pytest.mark.parametrize("kp", [8, 32, 40])
@pytest.mark.parametrize("shape", [(16, 16, 16), (8, 6, 4)],
                         ids=["16cube", "8x6x4"])
def test_segment_fields_kernel_matches_twin(dev, kp, shape):
    """K' = kp columns of a [G, 40, 3] move, read in place (kp < 40) or
    whole; moves up to 0.9 cell a axis, the first 3 slots at rest, cell 1
    wholly at rest, every slot of cell 2 in 4 segments, cell 4 a mix
    of 1 to 4 in one row and cell 5 moves of 1.1 to 2.5 cells a axis
    (segments longer than a cell: the kernel's whole-window branch); two
    calls bitwise equal; within 1e-5 of the twin's max in float32, 1e-12
    in float64 (the same inputs cast)."""
    nx, ny, nz = shape
    geom = Geometry(dx=0.5, dy=0.4, dz=0.6, dt=1.5, nx=nx, ny=ny, nz=nz,
                    nt=1)
    G = geom.n_cells
    rng = np.random.default_rng(kp)

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    E = f32(rng.standard_normal((3,) + geom.shape))
    B = f32(rng.standard_normal((3,) + geom.shape))
    t0 = rng.random((G, 40, 3))
    move = rng.uniform(-0.9, 0.9, (G, 40, 3))
    move[:, :3] = 0.0
    # Cells whose rows are all at rest (one segment a slot), all cross
    # three faces (4 segments: t0 just below the faces at 1/2, moved by
    # 0.3, 0.25 and 0.2 cell, so the three crossings differ), and a mix
    # of 1 to 4 segments in one row of 32.
    move[1] = 0.0
    t0[2] = (0.45, 0.4, 0.35)
    move[2] = (0.3, 0.25, 0.2)
    mixed = rng.integers(0, 4, 40)  # faces crossed by each slot of cell 4
    t0[4] = 0.3
    move[4] = 0.0
    for k, n in enumerate(mixed):
        move[4, k, :n] = 0.4 + 0.05 * np.arange(n)
    # Long moves; slots 0 and 1 each leave a segment over 2 cells long on
    # one axis, so the window offsets of S2 at its ends lie 2 or more
    # apart.
    move[5] = rng.uniform(1.1, 2.5, (40, 3)) * rng.choice([-1.0, 1.0],
                                                          (40, 3))
    t0[5, :2] = ((0.45, 0.5, 0.5), (0.5, 0.55, 0.5))
    move[5, :2] = ((2.5, 0.0, 0.0), (0.0, -2.3, 0.0))
    t0, tn = f32(t0), f32(t0 + move)
    Eblk, Bblk = gather_window_blocks(E, geom), gather_window_blocks(B, geom)
    for dtype, name, tol in ((torch.float64, "segment_fields_f64", 1e-12),
                             (torch.float32, "segment_fields", 1e-5)):
        win = (Eblk.to(dtype), Bblk.to(dtype))
        a, b = t0.to(dtype)[:, :kp], tn.to(dtype)[:, :kp]
        before = kernels.LAUNCHES[name]
        got = segment_fields(*win, a, b)
        again = segment_fields(*win, a, b)
        ref = segment_fields_plain(*win, a, b)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[name] == before + 2
        for g, a_, r in zip(got, again, ref):
            assert g.shape == (G, kp, 3) and g.dtype == dtype
            assert torch.equal(g, a_)
            assert float((g - r).abs().max()) <= \
                tol * float(r.abs().max()), name
    if kp == 32 and shape == (16, 16, 16):
        _segment_fields_f64_ring(dev, rng)
    segs = (split_segments(t0[:, :kp], tn[:, :kp]).diff(dim=-1) != 0).sum(-1)
    assert bool((segs[1] == 1).all()) and bool((segs[2] == 4).all())
    assert set(segs[4].tolist()) == set((1 + mixed[:kp]).tolist())
    assert len(set(segs[4].tolist())) == (4 if kp >= 32 else 3), kp
    taus = split_segments(t0[5, :kp], tn[5, :kp])
    longest = ((tn[5, :kp] - t0[5, :kp])[:, None, :]
               * taus.diff(dim=-1)[..., None]).abs().amax(dim=(1, 2))
    assert float(longest[0]) >= 2.4 and float(longest[1]) >= 2.2


def _segment_fields_f64_ring(dev, rng):
    """The float64 kernel's ring of window stages: G = 9001 cells (a
    prime, so no multiple of the persistent grid's stride, and more than
    two strides), K' = 32 of 40 and K' = 40 (two slot groups, the second
    of 8), every slot of cell 0 at rest (one segment a slot, the fewest:
    tau runs from 0 to 1, so no slot has none), cell 1 crossing three
    faces a slot, the others moves up to 0.9 cell a axis; within 1e-12 of
    the twin's max, two calls bitwise equal."""
    G, K = 9001, 40

    def f64(a):
        return torch.tensor(a, dtype=torch.float64, device=dev)

    Eblk = f64(rng.standard_normal((G, 3, 6, 6, 6)))
    Bblk = f64(rng.standard_normal((G, 3, 6, 6, 6)))
    t0 = rng.random((G, K, 3))
    move = rng.uniform(-0.9, 0.9, (G, K, 3))
    move[0] = 0.0
    t0[1] = (0.45, 0.4, 0.35)
    move[1] = (0.3, 0.25, 0.2)
    t0, tn = f64(t0), f64(t0 + move)
    for kp in (32, K):
        a, b = t0[:, :kp], tn[:, :kp]
        before = kernels.LAUNCHES["segment_fields_f64"]
        got = segment_fields(Eblk, Bblk, a, b)
        again = segment_fields(Eblk, Bblk, a, b)
        ref = segment_fields_plain(Eblk, Bblk, a, b)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["segment_fields_f64"] == before + 2
        for g, a_, r in zip(got, again, ref):
            assert g.shape == (G, kp, 3) and g.dtype == torch.float64
            assert torch.equal(g, a_), kp
            assert float((g - r).abs().max()) <= \
                1e-12 * float(r.abs().max()), kp
            assert float((g[:2] - r[:2]).abs().max()) <= \
                1e-12 * float(r[:2].abs().max()), kp


def _fill_inputs(G, K, dev, seed, empty_cell=None, edges=False):
    """t, v, B_p [G, K, 3] (|b| ~ 0.2 at q/m = -1, dt = 1.5) and valid
    [G, K] with 70 % live slots; every slot of ``empty_cell`` invalid.
    With ``edges``: cell 5's only live slot is its last, cells 6 and 7
    have exactly 8 and 9 live slots (the kernel's steps of 8; as many as
    K allows), cell 8's live slots are a prefix (the rebin's layout) and
    every slot of cell 9 is live."""
    rng = np.random.default_rng(seed)
    valid = rng.random((G, K)) < 0.7
    if empty_cell is not None:
        valid[empty_cell] = False
    if edges:
        valid[5:9] = False
        valid[5, K - 1] = True
        for cell, n in ((6, 8), (7, 9)):
            valid[cell, rng.choice(K, min(n, K), replace=False)] = True
        valid[8, :max(1, 7 * K // 10)] = True
        valid[9] = True

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    return (f32(rng.random((G, K, 3))),
            f32(0.05 * rng.standard_normal((G, K, 3))),
            f32(0.25 * rng.standard_normal((G, K, 3))),
            torch.tensor(valid, device=dev))


@pytest.mark.parametrize("K", [16, 80, 96, 112, 200])
def test_ecsim_fill_kernel_matches_twin(dev, K):
    """L and Islot within 1e-5 of their largest magnitudes (float64, the
    same inputs cast: 1e-12) and two calls bitwise equal, K past the
    kernel's 32-slot tile included, and from the K = 16 case also K = 1,
    7 and 512 and the float64 kernel's edges (``_fill_f64_tiles``); cell
    3 has no live slot, and cells 5-9 hold the edges of
    ``_fill_inputs``."""
    kw = dict(q=-1.0, m=1.0, mpw=0.02, dt=1.5)
    for k in (K, 1, 7, 512) if K == 16 else (K,):
        inputs = _fill_inputs(16 ** 3, k, dev, seed=k, empty_cell=3,
                              edges=True)
        for dtype, name, tol in ((torch.float32, "ecsim_fill", 1e-5),
                                 (torch.float64, "ecsim_fill_f64", 1e-12)):
            t, v, B_p = (x.to(dtype) for x in inputs[:3])
            valid = inputs[3]
            case = (k, name)
            before = kernels.LAUNCHES[name]
            L, Islot = ecsim_fill(t, v, B_p, valid, **kw)
            L_2, Islot_2 = ecsim_fill(t, v, B_p, valid, **kw)
            L_p, Islot_p = ecsim_fill_plain(t, v, B_p, valid, **kw)
            torch.cuda.synchronize()
            assert kernels.LAUNCHES[name] == before + 2
            assert L.shape == (16 ** 3, 3, 12, 3, 12) and L.dtype == dtype
            assert Islot.shape == (16 ** 3, 3, 12)
            assert torch.equal(L, L_2) and torch.equal(Islot, Islot_2), case
            assert float((L - L_p).abs().max()) <= \
                tol * float(L_p.abs().max()), case
            assert float((Islot - Islot_p).abs().max()) <= \
                tol * float(Islot_p.abs().max()), case
            assert not bool(L[3].any()) and not bool(Islot[3].any())
            # each edge cell against its own twin, at its own scale
            for cell in range(5, 10):
                assert float((L[cell] - L_p[cell]).abs().max()) <= \
                    tol * float(L_p[cell].abs().max()), (case, cell)
                assert float((Islot[cell] - Islot_p[cell]).abs().max()) \
                    <= tol * float(Islot_p[cell].abs().max()), (case, cell)
    if K == 16:
        _fill_f64_tiles(dev, kw)


def _fill_f64_tiles(dev, kw):
    """The float64 kernel's k-steps of 4 live slots and tiles of 32:
    cells with 0, 1, 3, 5 and 33 live slots (n_live not a multiple of 4
    or of 32) at K = 45 and 77 (not multiples of 32); each such cell
    within 1e-12 of its own twin's max, the empty one exactly 0, the
    whole within 1e-12 and two calls bitwise equal."""
    for K in (45, 77):
        t, v, B_p, valid = _fill_inputs(16 ** 3, K, dev, seed=K)
        rng = np.random.default_rng(K)
        counts = (0, 1, 3, 5, 33)
        live = valid.cpu().numpy()
        for cell, n in enumerate(counts):
            live[cell] = False
            live[cell, rng.choice(K, n, replace=False)] = True
        valid = torch.tensor(live, device=dev)
        t, v, B_p = t.double(), v.double(), B_p.double()
        L, Islot = ecsim_fill(t, v, B_p, valid, **kw)
        L_2, Islot_2 = ecsim_fill(t, v, B_p, valid, **kw)
        L_p, Islot_p = ecsim_fill_plain(t, v, B_p, valid, **kw)
        torch.cuda.synchronize()
        assert torch.equal(L, L_2) and torch.equal(Islot, Islot_2), K
        for got, ref in ((L, L_p), (Islot, Islot_p)):
            assert float((got - ref).abs().max()) <= \
                1e-12 * float(ref.abs().max()), K
            assert not bool(got[0].any()), K
            for cell in range(1, len(counts)):
                assert float((got[cell] - ref[cell]).abs().max()) <= \
                    1e-12 * float(ref[cell].abs().max()), (K, cell)


def test_ecsim_fill_wrapper_rejects_what_the_kernel_does_not_take(dev):
    t, v, B_p, valid = _fill_inputs(64, 16, dev, seed=1)
    kw = dict(q=-1.0, m=1.0, mpw=0.02, dt=1.5)
    L, Islot = ecsim_fill(t.double(), v.double(), B_p.double(), valid, **kw)
    assert L.dtype == Islot.dtype == torch.float64
    with pytest.raises(TypeError):  # float64 t, float32 v and B_p
        ecsim_fill(t.double(), v, B_p, valid, **kw)
    for half in (torch.float16, torch.bfloat16):
        with pytest.raises(TypeError):
            ecsim_fill(t.to(half), v.to(half), B_p.to(half), valid, **kw)
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
    got = segment_fields(blk.double(), blk.double(), t.double(), t.double())
    assert all(x.dtype == torch.float64 for x in got)
    for half in (torch.float16, torch.bfloat16):
        with pytest.raises(TypeError):
            segment_fields(blk.to(half), blk.to(half), t.to(half),
                           t.to(half))
    with pytest.raises(ValueError):
        segment_fields(blk[: G // 2], blk, t, t)
    with pytest.raises(ValueError):  # slots not contiguous
        segment_fields(blk, blk, t[:, ::2], t[:, ::2])
    with pytest.raises(ValueError):  # different row strides
        segment_fields(blk, blk, t[:, :8], t[:, :8].contiguous())
    flat = torch.zeros(blk.numel() + 1, device=dev)
    with pytest.raises(ValueError):  # windows off a 16-byte boundary
        segment_fields(flat[1:].view(blk.shape), blk, t, t)


@pytest.mark.parametrize("name", PRIMS)
def test_prims_kernel_matches_twin(dev, name):
    x = make_input(512, dev, seed=1)
    before = kernels.LAUNCHES["prims"]
    got = prim(x, name)
    ref = prim_plain(x, name)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["prims"] == before + 1
    assert got.shape == ref.shape == (512, 8, 128)
    if name in BITWISE:
        assert torch.equal(got, ref)
    else:
        assert float((got - ref).abs().max()) <= \
            1e-5 * float(ref.abs().max())


def test_prims_wrapper_rejects_what_the_kernel_does_not_take(dev):
    x = make_input(4, dev)
    with pytest.raises(TypeError):
        prim(x.double(), "copy")
    with pytest.raises(ValueError):  # 64 columns
        prim(x[:, :, :64].contiguous(), "copy")
    with pytest.raises(ValueError):  # not contiguous
        prim(x.transpose(0, 1).contiguous().transpose(0, 1), "copy")
    with pytest.raises(ValueError):  # 4 bytes off a float4 boundary
        prim(x.reshape(-1)[1:1 + 3 * 1024].view(3, 8, 128), "copy")
    with pytest.raises(ValueError):
        prim(x, "fma32")
