"""The two gloo ranks of ``tests/test_torch_mesh.py``'s op checks.

``run(root)`` starts two CPU ranks (``torch.multiprocessing``, spawn),
joined by gloo.  Each rank runs the port's ops on its z slab of seeded
states and writes what it got to ``root/rank<r>.npz``; rank 0 also runs
the same ops on the whole grid (no mesh) into ``root/whole.npz``.  The
states have movers across both slab faces and across the periodic wrap
at z = 0.  The tests join the slabs and compare.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.multiprocessing as mp

WORLD = 2
# The grid of the op checks: 3 planes a slab, the fewest that the
# float32 neighbour exchange takes.
NX, NY, NZ = 4, 4, 6
K, PPC = 24, 8
DT, D = 1.5, 0.5
# The collective-volume pin: one ECSIM step at these z extents.
HALO_NZ = (8, 16)


def geometry(nz=NZ, z_bound="periodic"):
    from xpic_tpu_torch.config import Geometry

    return Geometry(dx=D, dy=D, dz=D, dt=DT, nx=NX, ny=NY, nz=nz, nt=4,
                    bounds=("periodic", "periodic", z_bound))


def drifted_state(geom, dtype, seed, drift=True):
    """A binned state [G, K] after one drift of up to 0.6 cell an axis,
    before its migration: movers on every face, the periodic wrap among
    them (``drift=False``: the state before the drift)."""
    from xpic_tpu_torch.ops.binning import bin_state, drift_state
    from xpic_tpu_torch.particles import ParticleArrays

    rng = np.random.default_rng(seed)
    n = geom.n_cells * PPC
    r = rng.random((n, 3)) * np.array(geom.L)
    p = (rng.random((n, 3)) - 0.5) * (0.4 * D / DT) * 2.0
    sp = ParticleArrays(r=torch.tensor(r, dtype=dtype),
                        p=torch.tensor(p, dtype=dtype),
                        alive=torch.ones(n, dtype=torch.bool))
    st = bin_state(sp, geom, K)
    return drift_state(st, geom) if drift else st


def slab_rows(st, geom, mesh):
    """The rows of a whole-grid binned state that a rank's slab holds."""
    from xpic_tpu_torch.ops.binning import BinnedState

    G = geom.n_cells // mesh.world
    rows = slice(mesh.rank * G, (mesh.rank + 1) * G)
    return BinnedState(r=st.r[rows], p=st.p[rows], valid=st.valid[rows])


def zslab(F, mesh):
    n = F.shape[-3] // mesh.world
    return F.narrow(-3, mesh.rank * n, n).contiguous()


def ops(geom, mesh, whole: bool):
    """Every op check on ``geom`` (the whole grid when ``whole``, else the
    rank's slab): a dict of numpy arrays."""
    from xpic_tpu_torch.ops import neighbor_rebin as NR
    from xpic_tpu_torch.ops.binning import _rebin_global
    from xpic_tpu_torch.ops.ecsim_blocks import deposit_slot_sums, \
        gather_slots
    from xpic_tpu_torch.ops.ecsim_kernel import ecsim_fill
    from xpic_tpu_torch.ops.gather_scatter import B_STAGGER, cell_t, \
        gather_vector
    from xpic_tpu_torch.ops.mass_free import deposit_vector_slots
    from xpic_tpu_torch.ops.stencil import curl_negative, curl_positive
    from xpic_tpu_torch.ops.stencil_kernel import cheb_matM_inv_plain, \
        cheb_matM_inv_slab_plain
    from xpic_tpu_torch.parallel.step import advance_phase

    g = geometry()
    rng = np.random.default_rng(11)
    F = torch.tensor(rng.standard_normal((3, NZ, NY, NX)))
    rhs = torch.tensor(rng.standard_normal((3, NZ, NY, NX)))
    Islot = torch.tensor(rng.standard_normal((g.n_cells, 3, 12)))
    vals = torch.tensor(rng.standard_normal((g.n_cells, K, 3)))

    def local(T, rows=False):
        if whole:
            return T
        if rows:
            G = g.n_cells // mesh.world
            return T[mesh.rank * G:(mesh.rank + 1) * G]
        return zslab(T, mesh)

    def state(st):
        return st if whole else slab_rows(st, g, mesh)

    out = {}
    steps, bounds = geom.cell_steps, geom.bounds
    m = None if whole else mesh
    out["curl_positive"] = curl_positive(local(F), steps, bounds, m)
    out["curl_negative"] = curl_negative(local(F), steps, bounds, m)
    out["gather_slots"] = gather_slots(local(F), geom)
    out["deposit_slot_sums"] = deposit_slot_sums(local(Islot, True), geom)
    for dtype in (torch.float64, torch.float32):
        key = f"cheb_{str(dtype)[-7:]}"
        if whole:
            out[key] = cheb_matM_inv_plain(rhs.to(dtype), 0.3, geom=geom,
                                           degree=12, dt=DT)
        else:
            out[key] = cheb_matM_inv_slab_plain(local(rhs).to(dtype), 0.3,
                                                geom=geom, degree=12, dt=DT)

    # The migrations: the float64 global sort and the float32 exchange.
    st64 = state(drifted_state(g, torch.float64, 3))
    s_g, load = _rebin_global(st64, geom)
    out.update(sort_r=s_g.r, sort_p=s_g.p, sort_valid=s_g.valid,
               sort_load=load)
    st32 = state(drifted_state(g, torch.float32, 4))
    ok, _, _ = NR.neighbor_guard_stats(st32, geom)
    if not whole:
        ok = mesh.allreduce_max((~ok).to(torch.int32)) == 0
    s_n, load = NR.rebin_neighbor(st32, geom)
    out.update(nb_ok=ok, nb_r=s_n.r, nb_p=s_n.p, nb_valid=s_n.valid,
               nb_load=load)

    # Deposits and the field solve on the migrated float64 state.
    t = cell_t(geom, s_g.r)
    out["deposit_vector_slots"] = deposit_vector_slots(
        torch.where(s_g.valid[..., None], local(vals, True), 0.0), t, geom)
    B = local(torch.tensor(rng.standard_normal((3, NZ, NY, NX)))) * 0.1
    E = local(torch.tensor(rng.standard_normal((3, NZ, NY, NX)))) * 0.1
    B_p = gather_vector(B, t, s_g.valid, geom, order=1, width=3, anchor=-1,
                        stagger=B_STAGGER)
    L, Isl = ecsim_fill(t, s_g.p, B_p, s_g.valid, q=-1.0, m=1.0,
                        mpw=1.0 / PPC, dt=DT)
    currI = deposit_slot_sums(Isl, geom)
    sol, _ = advance_phase(E, B, torch.zeros_like(B), currI, L, geom,
                           tol=1e-7, maxit=100)
    out.update(gmres_x=sol.x, gmres_iters=np.int64(sol.iterations))
    return {k: (v.numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in out.items()}


def ghosted(mesh_for):
    """A ghosted z bound (no neighbour below rank 0 or above the last):
    the curl-curl, the Chebyshev twin and the slot-sum deposit."""
    from xpic_tpu_torch.ops.ecsim_blocks import deposit_slot_sums
    from xpic_tpu_torch.ops.stencil import curl_negative, curl_positive
    from xpic_tpu_torch.ops.stencil_kernel import cheb_matM_inv_plain, \
        cheb_matM_inv_slab_plain

    g = geometry(z_bound="ghosted")
    mesh = mesh_for()
    geom = g if mesh is None else g.slab(mesh)
    rng = np.random.default_rng(12)
    F = torch.tensor(rng.standard_normal((3, NZ, NY, NX)))
    Islot = torch.tensor(rng.standard_normal((g.n_cells, 3, 12)))
    if mesh is not None:
        F = zslab(F, mesh)
        G = geom.n_cells
        Islot = Islot[mesh.rank * G:(mesh.rank + 1) * G]
    steps, bounds = g.cell_steps, g.bounds
    cheb = cheb_matM_inv_plain if mesh is None else cheb_matM_inv_slab_plain
    return {
        "curlcurl_ghosted": curl_negative(
            curl_positive(F, steps, bounds, mesh), steps, bounds,
            mesh).numpy(),
        "cheb_ghosted": cheb(F, 0.3, geom=geom, degree=12, dt=DT).numpy(),
        "deposit_ghosted": deposit_slot_sums(Islot, geom).numpy(),
    }


def fused(geom, mesh, whole: bool):
    """Three float64 steps (blocks route) and two float32 steps (free
    route) of ``ecsim_multi_step`` from seeded states."""
    from xpic_tpu_torch.ops.binning import unbin_state
    from xpic_tpu_torch.parallel.step import ecsim_multi_step

    g = geometry()
    out = {}
    for dtype, steps, seed in ((torch.float64, 3, 5), (torch.float32, 2, 6)):
        key = str(dtype)[-7:]
        st = drifted_state(g, dtype, seed, drift=False)
        sp = unbin_state(st if whole else slab_rows(st, g, mesh), geom)
        rng = np.random.default_rng(seed)
        E = torch.tensor(rng.standard_normal((3, NZ, NY, NX)) * 0.01,
                         dtype=dtype)
        B0 = torch.zeros_like(E)
        B0[2] = 0.2
        if not whole:
            E, B0 = zslab(E, mesh), zslab(B0, mesh)
        E1, B1, _, iters = ecsim_multi_step(
            E, B0.clone(), B0, sp, geom, K, q=-1.0, m=1.0, mpw=1.0 / PPC,
            n_steps=steps)
        out[f"fused_E_{key}"] = E1.numpy()
        out[f"fused_B_{key}"] = B1.numpy()
        out[f"fused_iters_{key}"] = iters.numpy()
    return out


def halo_bytes(mesh_for):
    """The bytes one float64 ECSIM step sends on each z extent of
    ``HALO_NZ`` (2 ranks)."""
    from xpic_tpu_torch.parallel.step import ecsim_step_binned

    out = []
    for nz in HALO_NZ:
        g = geometry(nz)
        mesh = mesh_for(nz)
        geom = g.slab(mesh)
        st = slab_rows(drifted_state(g, torch.float64, 8), g, mesh)
        E = torch.zeros((3, geom.nz, NY, NX), dtype=torch.float64)
        B = torch.zeros_like(E)
        B[2] = 0.2
        mesh.reset_counts()
        ecsim_step_binned(E, B, B.clone(), st, geom, q=-1.0, m=1.0,
                          mpw=1.0 / PPC)
        out.append(mesh.bytes_sent)
    return np.array(out)


def particle_load(cfg_doc, root, mesh_n):
    """The binned state that initialising ``cfg_doc`` (with the reference
    RNG) loads on this rank, over ``mesh_n`` ranks."""
    from xpic_tpu_torch.commands import particles_load
    from xpic_tpu_torch.config import Config
    from xpic_tpu_torch.schemes import build_simulation

    doc = dict(cfg_doc, OutputDirectory=str(root), Diagnostics=[])
    if mesh_n > 1:
        doc["Mesh"] = mesh_n
    os.environ["XPIC_RNG"] = "reference"
    particles_load.use_reference_rng()
    try:
        sim = build_simulation(Config.from_json(doc), device="cpu")
        sim.initialize()
        st = sim.species[0].state
        out = {"r": st.r.numpy(), "p": st.p.numpy(), "valid":
               st.valid.numpy(), "K": np.int64(sim.species[0].slots)}
        sim.finalize()
    finally:
        del os.environ["XPIC_RNG"]
        particles_load.seed(5489)
    return out


def _rank(rank, init, root, cfg_doc):
    from xpic_tpu_torch.parallel.mesh import make_mesh
    from xpic_tpu_torch.runtime import distributed

    torch.set_num_threads(1)
    distributed.join(init, rank, WORLD, device="cpu")
    try:
        mesh = make_mesh(WORLD, NZ)
        geom = geometry().slab(mesh)
        res = ops(geom, mesh, whole=False)
        res.update(fused(geom, mesh, whole=False))
        res["halo_bytes"] = halo_bytes(lambda nz: make_mesh(WORLD, nz))
        res.update(ghosted(lambda: make_mesh(WORLD, NZ, "ghosted")))
        res.update({f"load_{k}": v for k, v in particle_load(
            cfg_doc, os.path.join(root, f"load{rank}"), WORLD).items()})
        if rank == 0:
            g = geometry()
            ref = ops(g, None, whole=True)
            ref.update(fused(g, None, whole=True))
            ref.update(ghosted(lambda: None))
            ref.update({f"load_{k}": v for k, v in particle_load(
                cfg_doc, os.path.join(root, "load_whole"), 1).items()})
            np.savez(os.path.join(root, "whole.npz"), **ref)
        np.savez(os.path.join(root, f"rank{rank}.npz"), **res)
    finally:
        distributed.leave()


def run(root, cfg_doc) -> None:
    """Start the two ranks and wait for them (raises when one fails)."""
    from xpic_tpu_torch.runtime.distributed import free_port

    init = f"tcp://127.0.0.1:{free_port()}"
    mp.spawn(_rank, args=(init, str(root), cfg_doc), nprocs=WORLD,
             join=True)

