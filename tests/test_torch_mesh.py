"""The port's ECSIM path over two ``torch.distributed`` ranks (gloo, CPU),
one z slab each, against the one-rank port and the JAX package.

One fixture, built once a test run (``torch_shared_fixture.build_once``),
starts the ranks twice:

* ``runtime.cli.main`` on ``test_torch_cli.py``'s config (6^3, 8
  particles per cell, B0 = 0.2 z, 4 steps, float64, the reference RNG)
  with ``"Mesh": 2``: the single process starts its two ranks, and each
  writes its ``--report``;
* ``tests/torch_mesh_worker.py``: the op checks on seeded states (movers
  across both slab faces and the periodic wrap), each rank's slab
  results and rank 0's whole-grid results as numpy files.

The one-rank port and JAX runs are ``test_torch_cli.py``'s
(``torch_cli_runs``).  Bars: the tables within 1e-11 absolute of the
one-rank run (the JAX suite's multi-device bar,
``tests/test_multichip.py:108``) and within 1e-10 of each column's scale
of the JAX run (``diagnostics.compare``); the dumps byte for byte at
step 0 and within 1e-11 of the largest value after; equal KSP
histories.  The ops: gathers, curls, the Chebyshev twin and the
migrations bitwise, deposits within 1e-14 of the largest value, GMRES
iterations equal and its solution within 1e-12.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from xpic_tpu.commands import particles_load as jload
from xpic_tpu_torch.commands import particles_load as tload
from xpic_tpu_torch.config import Config
from xpic_tpu_torch.convert import join_state, split_state
from xpic_tpu_torch.diagnostics.compare import TABLES, read_table, table_errors
from xpic_tpu_torch.parallel import mesh as pmesh
from xpic_tpu_torch.runtime import cli as tcli
from xpic_tpu_torch.runtime import distributed
from xpic_tpu_torch.schemes import build_simulation

import torch_mesh_worker as W
from test_torch_cli import DUMPS, STEPS, _build_runs, make_doc
from torch_shared_fixture import build_once

torch.set_num_threads(1)

# Values of one slab against the whole grid: bitwise, or within a
# relative bar of the largest magnitude.
BITWISE = ("curl_positive", "curl_negative", "gather_slots", "cheb_float64",
           "cheb_float32", "curlcurl_ghosted", "cheb_ghosted")
DEPOSITS = ("deposit_slot_sums", "deposit_vector_slots", "deposit_ghosted")
DEPOSIT_TOL, GMRES_TOL, TABLE_ATOL = 1e-14, 1e-12, 1e-11
# Keys of per-cell arrays (joined along G) rather than fields (along z).
ROWS = ("gather_slots", "sort_", "nb_", "load_")


def _build(root):
    out = root / "cli"
    out.mkdir()
    cfg = out / "cfg.json"
    cfg.write_text(json.dumps(dict(make_doc(out / "out"), Mesh=W.WORLD)))
    os.environ["XPIC_RNG"] = "reference"
    try:
        assert tcli.main([str(cfg), "--quiet", "--device", "cpu",
                          "--report", str(out / "report.json")]) == 0
    finally:
        del os.environ["XPIC_RNG"]
        jload.seed(5489)
        tload.seed(5489)
    (root / "ops").mkdir()
    W.run(root / "ops", make_doc(root / "unused"))


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    root = build_once(tmp_path_factory, "torch_mesh_runs", _build)
    one = build_once(tmp_path_factory, "torch_cli_runs", _build_runs)
    ksp = json.loads((one / "ksp.json").read_text())
    reports = [json.loads((root / "cli" / f"report.json.rank{r}")
                          .read_text()) for r in range(W.WORLD)]
    return {"mesh": root / "cli" / "out", "torch": one / "torch" / "out",
            "jax": one / "jax" / "out", "ksp": ksp, "reports": reports}


@pytest.fixture(scope="module")
def op_runs(mesh_runs, tmp_path_factory):
    root = build_once(tmp_path_factory, "torch_mesh_runs", _build) / "ops"
    whole = dict(np.load(root / "whole.npz"))
    ranks = [dict(np.load(root / f"rank{r}.npz")) for r in range(W.WORLD)]
    return whole, ranks


def _joined(ranks, key):
    axis = 0 if key.startswith(ROWS) else -3
    return np.concatenate([r[key] for r in ranks], axis=axis)


@pytest.mark.parametrize("table", TABLES)
def test_tables_match_one_rank(mesh_runs, table):
    """Two ranks against the port's one-rank run: every entry within
    1e-11 absolute, equal headers and row counts.  The energy table's
    standard deviations sX = sqrt(<X^2> - <X>^2) are the root of a
    cancelled difference (sB of the uniform B at step 0 is the root of
    one ulp of wB), so those columns are held as ``diagnostics.compare``
    holds them: squared, within 1e-11 of their scale."""
    h1, rows1 = read_table(mesh_runs["torch"] / "temporal" / table)
    h2, rows2 = read_table(mesh_runs["mesh"] / "temporal" / table)
    assert h1 == h2 and rows1.shape == rows2.shape == (STEPS + 1,
                                                       rows1.shape[1])
    plain = [i for i, h in enumerate(h1)
             if not (table == "energy.txt" and h.startswith("s"))]
    np.testing.assert_allclose(rows2[:, plain], rows1[:, plain], rtol=0,
                               atol=TABLE_ATOL)
    errs = table_errors(table, mesh_runs["torch"], mesh_runs["mesh"],
                        n_cells=6 ** 3)
    assert all(e <= TABLE_ATOL for e in errs.values()), errs


@pytest.mark.parametrize("table", TABLES)
def test_tables_match_jax(mesh_runs, table):
    """Two ranks against the JAX package's one-device run: every column
    within 1e-10 of its scale (``test_torch_cli.py``'s bar)."""
    errs = table_errors(table, mesh_runs["jax"], mesh_runs["mesh"],
                        n_cells=6 ** 3)
    assert all(e <= 1e-10 for e in errs.values()), errs


@pytest.mark.parametrize("dump", DUMPS)
def test_dumps_match_one_rank(mesh_runs, dump):
    """Rank 0 writes the whole grid: step 0 byte for byte, later steps
    within 1e-11 of the largest value; the other rank writes nothing."""
    one, two = mesh_runs["torch"] / dump, mesh_runs["mesh"] / dump
    names = sorted(os.listdir(one))
    assert sorted(os.listdir(two)) == names and len(names) == STEPS + 1
    assert (two / names[0]).read_bytes() == (one / names[0]).read_bytes()
    for name in names[1:]:
        a = np.fromfile(two / name, dtype=np.float32)
        b = np.fromfile(one / name, dtype=np.float32)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-11 * np.abs(b).max()


def test_ksp_history_and_reports(mesh_runs):
    """Equal KSP histories on both ranks and the one-rank run; each rank
    reports the gloo backend, its share of the exchange and every
    particle."""
    one = mesh_runs["ksp"]["torch"]
    for rank, rep in enumerate(mesh_runs["reports"]):
        assert rep["rank"] == rank and rep["world"] == W.WORLD
        assert rep["ksp_history"] == one and len(one) == STEPS
        assert rep["backend"] == "gloo" and rep["device"] == "cpu"
        assert rep["count"] == [8 * 6 ** 3]
        assert rep["mesh"]["bytes_sent"] > 0
        assert rep["mesh"]["calls"]["halo_pad"] > 0
        assert rep["mesh"]["calls"]["halo_fold"] > 0


@pytest.mark.parametrize("key", BITWISE)
def test_ops_bitwise(op_runs, key):
    """Curls, the slot gather and the Chebyshev twin on padded slabs
    (float64 and float32), and the curl-curl and the Chebyshev twin with
    a ghosted z bound (zeros beyond the edge ranks): the whole grid's
    bits."""
    whole, ranks = op_runs
    np.testing.assert_array_equal(_joined(ranks, key), whole[key])


@pytest.mark.parametrize("key", DEPOSITS)
def test_deposits(op_runs, key):
    """The slot-sum deposits fold the ghost planes' sums (and drop those
    beyond a ghosted z bound): within 1e-14 of the largest value."""
    whole, ranks = op_runs
    got, ref = _joined(ranks, key), whole[key]
    assert np.abs(got - ref).max() <= DEPOSIT_TOL * np.abs(ref).max()
    assert not np.array_equal(got, np.zeros_like(got))


def test_gmres_on_matA(op_runs):
    """GMRES on matA (the float64 fill's blocks, the slab Chebyshev
    preconditioner, all-reduced inner products): equal iterations, the
    solution within 1e-12 of its largest value."""
    whole, ranks = op_runs
    assert all(int(r["gmres_iters"]) == int(whole["gmres_iters"])
               for r in ranks)
    got, ref = _joined(ranks, "gmres_x"), whole["gmres_x"]
    assert np.abs(got - ref).max() <= GMRES_TOL * np.abs(ref).max()


@pytest.mark.parametrize("route", ["sort", "nb"])
def test_migration_bitwise(op_runs, route):
    """The cross-rank global sort (float64) and the float32 neighbour
    exchange (its guard passed on both ranks): every cell's slots hold
    the whole grid's bits; the ranks' loads add up to the whole grid's
    (largest load, particles lost, particles moved)."""
    whole, ranks = op_runs
    if route == "nb":
        assert all(bool(r["nb_ok"]) for r in ranks) and bool(whole["nb_ok"])
    for part in ("r", "p", "valid"):
        key = f"{route}_{part}"
        np.testing.assert_array_equal(_joined(ranks, key), whole[key])
    loads = np.stack([r[f"{route}_load"] for r in ranks])
    ref = whole[f"{route}_load"]
    assert loads[:, 0].max() == ref[0] and loads[:, 1:].sum(0).tolist() \
        == ref[1:].tolist()


def test_particle_load_bitwise(op_runs):
    """Every rank draws the whole reference-RNG stream and keeps its slab:
    the slabs' binned states are the one-rank load, bit for bit, at the
    same K."""
    whole, ranks = op_runs
    for part in ("r", "p", "valid"):
        key = f"load_{part}"
        np.testing.assert_array_equal(_joined(ranks, key), whole[key])
    assert all(int(r["load_K"]) == int(whole["load_K"]) for r in ranks)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fused_multi_step(op_runs, dtype):
    """``ecsim_multi_step`` on the slabs (float64: the blocks route, 3
    steps; float32: the free route, 2 steps): equal iterations, fields
    within 1e-13 (float64) or 1e-4 (float32) of the largest value."""
    whole, ranks = op_runs
    tol = 1e-13 if dtype == "float64" else 1e-4
    it = whole[f"fused_iters_{dtype}"]
    assert all(np.array_equal(r[f"fused_iters_{dtype}"], it) for r in ranks)
    for f in ("E", "B"):
        key = f"fused_{f}_{dtype}"
        got, ref = _joined(ranks, key), whole[key]
        assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def test_collective_volume_stays_o_halo(op_runs):
    """The bytes one ECSIM step sends grow by less than 1.5x from nz = 8
    to nz = 16 on two ranks: the halos, the folds and the migration's
    leavers scale with the cut surface, not the volume
    (``tests/test_multichip.py:283``).  A Chebyshev apply on a slab of
    t = 3 planes makes ceil(11 / 3) = 4 ghost exchanges."""
    _, ranks = op_runs
    for r in ranks:
        small, large = r["halo_bytes"]
        assert 0 < small and large < 1.5 * small
        assert int(r["cheb_exchanges"]) == 4


def test_one_rank_step_makes_no_collective(tmp_path, monkeypatch):
    """With one rank no op calls the mesh or torch.distributed: a step
    leaves the mesh's counters at 0."""
    def refuse(*args, **kwargs):
        raise AssertionError("a collective on one rank")

    for name in ("all_reduce", "all_gather", "gather", "batch_isend_irecv"):
        monkeypatch.setattr(dist, name, refuse)
    sim = build_simulation(Config.from_json(make_doc(tmp_path / "out")),
                           device="cpu")
    try:
        sim.initialize()
        sim.timestep_implementation(1)
    finally:
        tload.seed(5489)
    assert sim.geom.mesh is None and sim.mesh.world == 1
    assert sim.mesh.bytes_sent == 0 and not sim.mesh.calls


@pytest.mark.parametrize("change", [
    {"Mesh": {"z": 2, "y": 2}},
    {"Mesh": {"z": 2, "y": 1, "x": 2}},
    {"Mesh": 2, "SimulationBackup": {"diagnose_period": 1.5}},
    {"Mesh": 2, "SimulationBackup": {"diagnose_period": 1.5,
                                     "load_from": 2}},
], ids=["zy_mesh", "zyx_mesh", "backup", "backup_load"])
def test_next_slice_is_refused(tmp_path, change):
    """What the next slices bring (ROADMAP A11b: the (z, y) and (z, y, x)
    meshes, SimulationBackup over ranks, writing or loading) is refused
    at build time, before any rank joins."""
    cfg = Config.from_json(dict(make_doc(tmp_path / "out"), **change))
    with pytest.raises(NotImplementedError, match="ROADMAP A11b"):
        build_simulation(cfg, device="cpu")


def test_mesh_must_divide_nz(tmp_path):
    with pytest.raises(ValueError, match="does not divide"):
        Config.from_json(dict(make_doc(tmp_path / "out"), Mesh=4))


def test_split_and_join_state(tmp_path):
    """``convert.split_state`` and ``join_state``: slabs of fields and
    binned states join back to the global state; a flat species splits
    by its particles' cells, every particle in one slab."""
    rng = np.random.default_rng(0)
    g = Config.from_json(make_doc(tmp_path)).geometry
    F = rng.standard_normal((3, g.nz, g.ny, g.nx))
    binned = (rng.random((g.n_cells, 4, 3)), rng.random((g.n_cells, 4, 3)),
              rng.random((g.n_cells, 4)) > 0.5)
    r = rng.random((50, 3)) * np.array(g.L)
    flat = (r, rng.random((50, 3)), np.ones(50, bool))
    parts = split_state(3, fields=[F], binned=binned, flat=flat, geom=g,
                        dtype=torch.float64)
    assert [p["fields"][0].shape[1] for p in parts] == [2, 2, 2]
    back = join_state(parts)
    np.testing.assert_array_equal(back["fields"][0], F)
    for a, b in zip(back["binned"], binned):
        np.testing.assert_array_equal(a, b)
    zs = [p["flat"][0][:, 2] for p in parts]
    assert sum(len(z) for z in zs) == 50
    for rank, z in enumerate(zs):
        assert ((z >= rank) & (z < rank + 1)).all()  # 2 planes of 0.5


def test_halo_fold_is_the_adjoint_of_halo_pad():
    """On one process with no group: a mesh of one rank around a periodic
    axis pads with its own planes and folds onto them, the adjoint pair
    <pad(x), y> = <x, fold(y)>."""
    m = pmesh.SlabMesh(0, 1, 4, True, None)
    m.exchange = lambda to_up, to_dn, kind: (to_up.clone(), to_dn.clone())
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((2, 4, 3, 3)))
    y = torch.tensor(rng.standard_normal((2, 7, 3, 3)))
    px = m.halo_pad(x, 1, 2)
    assert px.shape == y.shape
    torch.testing.assert_close(px[:, 0], x[:, 3])
    torch.testing.assert_close(px[:, 5:], x[:, :2])
    torch.testing.assert_close(torch.sum(px * y),
                               torch.sum(x * m.halo_fold(y, 1, 2)))


def test_launched_group_and_backend(monkeypatch):
    """A rank joins from the ``XPIC_*`` variables or ``torchrun``'s; the
    backend is gloo on the CPU and when ranks share a card, NCCL when
    each rank has a card of its own."""
    for var in ("XPIC_NUM_PROCESSES", "XPIC_COORDINATOR", "XPIC_PROCESS_ID",
                "WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.launched_group() is None
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1234")
    assert distributed.launched_group() == ("tcp://localhost:1234", 3, 4)
    monkeypatch.setenv("XPIC_NUM_PROCESSES", "2")
    monkeypatch.setenv("XPIC_PROCESS_ID", "1")
    monkeypatch.setenv("XPIC_COORDINATOR", "127.0.0.1:999")
    assert distributed.launched_group() == ("tcp://127.0.0.1:999", 1, 2)
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert distributed.choose_backend(cpu, False) == "gloo"
    assert distributed.choose_backend(cuda, True) == "gloo"
    assert distributed.choose_backend(cuda, False) == "nccl"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert distributed.rank_device(1, 2) == (torch.device("cuda", 0), True)
    assert distributed.rank_device(1, 2, "cpu") == (cpu, False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.rank_device(0, 2)
