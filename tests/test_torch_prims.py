"""The calibration path of the PyTorch port against the JAX package's.

Each plain twin of the primitive-rate probes (``xpic_tpu_torch.benchmarks
.prims``) is held against the Pallas probe kernel of
``benchmarks/profile_pallas_prims.py`` run in interpret mode on the same
numpy input (seed 0, uniform on [0, 16), G = 8 cells in blocks of 4):
bitwise for copy, roll8 and select16 (adds in the same order, and
selects), within 1e-5 of max |out| for fma16, fma64 and reduce16 (XLA
and PyTorch round the multiply-add chains and sum the rows in other
orders).  That script runs its whole benchmark when imported, so its six
``k_*`` functions are read with ``ast`` and executed on their own.

The port's two entry points print the JAX scripts' keys (read with
``ast`` from their ``res[...]`` assignments) plus ``device`` (and, for
the roofline calibration, ``note``); without CUDA they exit non-zero
unless asked for the CPU.  ``turns`` imports another checkout's
Chebyshev apply beside this tree's without replacing it or building
into it, and without CUDA it exits non-zero.
"""

import ast
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from xpic_tpu_torch import config, kernels
from xpic_tpu_torch.benchmarks import prims as P
from xpic_tpu_torch.benchmarks import profile_prims, profile_roofcal, turns
from xpic_tpu_torch.config import Geometry
from xpic_tpu_torch.ops import stencil_kernel

REPO = Path(__file__).resolve().parent.parent
JAX_PRIMS = REPO / "benchmarks" / "profile_pallas_prims.py"
JAX_ROOFCAL = REPO / "benchmarks" / "profile_roofcal.py"
G, BG = 8, 4
PRIM_TOL = 1e-5


def _jax_probe_kernels():
    """The ``k_*`` kernels of the JAX script, executed with BG blocks."""
    tree = ast.parse(JAX_PRIMS.read_text())
    defs = [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name.startswith("k_")]
    ns = {"jnp": jnp, "pltpu": pltpu, "BG": BG, "C": P.ROWS}
    exec(compile(ast.Module(body=defs, type_ignores=[]), str(JAX_PRIMS),
                 "exec"), ns)
    return {d.name[2:]: ns[d.name] for d in defs}


@pytest.fixture(scope="module")
def jax_probes():
    probes = _jax_probe_kernels()
    assert tuple(probes) == P.PRIMS
    return probes


@pytest.fixture(scope="module")
def probe_input():
    return np.random.default_rng(0).uniform(
        0.0, 16.0, (G, P.ROWS, P.COLS)).astype(np.float32)


@pytest.mark.parametrize("name", P.PRIMS)
def test_twin_matches_the_jax_probe(jax_probes, probe_input, name):
    shape = (G, P.ROWS, P.COLS)
    spec = pl.BlockSpec((BG, P.ROWS, P.COLS), lambda i: (i, 0, 0))
    ref = np.asarray(pl.pallas_call(
        jax_probes[name], grid=(G // BG,), in_specs=[spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
        interpret=True)(jnp.asarray(probe_input)))
    kernels.reset_counts()
    got = P.prim(torch.from_numpy(probe_input), name).numpy()
    assert kernels.LAUNCHES["prims"] == 0  # the CPU takes the twin
    assert got.dtype == ref.dtype == np.float32 and got.shape == shape
    if name in P.BITWISE:
        np.testing.assert_array_equal(got, ref)
    else:
        assert np.abs(got - ref).max() <= PRIM_TOL * np.abs(ref).max()


def _jax_keys(path):
    """The keys a JAX script assigns in ``res[...]``; ``res[name + "_ms"]``
    in a loop over ``(name, kernel)`` pairs gives one key a name."""
    tree = ast.parse(path.read_text())
    loops = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.For) and isinstance(node.target, ast.Tuple)
                and isinstance(node.iter, ast.List)):
            var = node.target.elts[0].id
            loops[var] = [e.elts[0].value for e in node.iter.elts]
    keys = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Name)
                and node.value.id == "res"
                and isinstance(node.ctx, ast.Store)):
            continue
        key = node.slice
        if isinstance(key, ast.Constant):
            keys.add(key.value)
        else:
            assert isinstance(key, ast.BinOp) and isinstance(key.op, ast.Add)
            keys.update(n + key.right.value for n in loops[key.left.id])
    return keys


@pytest.mark.parametrize("script,ref,extra", [
    (profile_prims, JAX_PRIMS, {"device"}),
    (profile_roofcal, JAX_ROOFCAL, {"device", "note"}),
], ids=["prims", "roofcal"])
def test_entry_points_print_the_jax_keys(capsys, script, ref, extra):
    assert script.main(["--device", "cpu", "--cells", "64"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    res = json.loads(lines[-1])
    jax_keys = _jax_keys(ref)
    assert len(jax_keys) >= 9
    assert set(res) == jax_keys | extra
    assert res["device"] == "cpu"
    assert all(v > 0 for k, v in res.items() if k not in ("device", "note"))


@pytest.mark.parametrize("script", [profile_prims, profile_roofcal],
                         ids=["prims", "roofcal"])
def test_entry_points_do_not_fall_back_to_the_cpu(monkeypatch, script):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--device", "cuda:0"]):
        with pytest.raises(SystemExit) as exc:
            script.main(argv)
        assert exc.value.code not in (0, None)


def test_wrapper_raises_for_other_devices_and_probes():
    x = torch.empty((4, P.ROWS, P.COLS), device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        P.prim(x, "copy")
    with pytest.raises(ValueError, match="unknown probe"):
        P.prim(torch.zeros((1, P.ROWS, P.COLS)), "fma32")


def test_cheb_turns_imports_the_other_tree_apart(monkeypatch):
    names, case = turns.CASES["cheb_step"]
    other = turns.load_other(str(REPO), names)
    sk, kern = other["ops.stencil_kernel"], other["kernels"]
    assert sk is not stencil_kernel and kern is not kernels
    assert sys.modules[stencil_kernel.__name__] is stencil_kernel
    assert kern.BUILD_DIR != kernels.BUILD_DIR
    this = {"ops.stencil_kernel": stencil_kernel, "config": config}
    cpu = torch.device("cpu")
    assert torch.equal(case(other, cpu, 4)(), case(this, cpu, 4)())
    geom = Geometry(dx=0.5, dy=0.5, dz=0.5, dt=1.5, nx=4, ny=4, nz=4, nt=1)
    rhs = torch.tensor(np.random.default_rng(0).standard_normal(
        (3, 4, 4, 4)))
    kw = dict(geom=geom, degree=12, dt=geom.dt)
    assert torch.equal(sk.cheb_matM_inv(rhs, 0.37, **kw),
                       stencil_kernel.cheb_matM_inv(rhs, 0.37, **kw))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        turns.main([str(REPO)])
    assert exc.value.code not in (0, None)


def test_mass_and_segment_turns_cases_run_on_the_cpu():
    """The K4, K6 and K7 cases of ``turns.CASES`` build at side 4 and run
    on the CPU, through the twins; ``capture_fast_call`` keeps the first
    call on column slices whole, and the K6 case's call on those
    operands reads them back in place; ``path_operands`` takes them from
    one eccapfim step and puts the scheme's function back; the K7 case
    runs on ``fill_operands``, phase 3's drifted and migrated state; the
    K6 and K7 cases cast their operands to float64 when asked."""
    from xpic_tpu_torch.ops import ecsim_kernel, mass_kernel, segment_kernel
    from xpic_tpu_torch.schemes import eccapfim

    cpu = torch.device("cpu")
    mods = {"ops.mass_kernel": mass_kernel,
            "ops.segment_kernel": segment_kernel}
    calls = turns.CASES["mass_apply"][1](mods, cpu, 4)
    assert sorted(calls) == ["K=112", "K=80"]
    for fn in calls.values():
        Y = fn()
        assert Y.shape == (64, 3, 12) and Y.dtype == torch.float32
        assert bool(torch.isfinite(Y).all()) and bool(Y.abs().max() > 0)
    rng = np.random.default_rng(0)

    def f32(a):
        return torch.tensor(a, dtype=torch.float32)

    Eblk, Bblk = (f32(rng.standard_normal((8, 3, 6, 6, 6))) for _ in "EB")
    t0 = f32(rng.random((8, 12, 3)))
    tn = t0 + f32(rng.uniform(-0.6, 0.6, (8, 12, 3)))
    fim = SimpleNamespace(segment_fields=segment_kernel.segment_fields)
    op = {}
    inner = turns.capture_fast_call(fim, op)
    fim.segment_fields(Eblk, Bblk, t0, tn)  # whole rows: not kept
    assert not op
    fim.segment_fields(Eblk, Bblk, t0[:, :5], tn[:, :5])
    fim.segment_fields(Eblk, Bblk, t0[:, :4], tn[:, :4])  # not the first
    assert inner is segment_kernel.segment_fields and op["kc"] == 5
    assert torch.equal(op["t0"], t0) and torch.equal(op["tn"], tn)
    calls = turns.CASES["segment_fields"][1](mods, cpu, 4, op)
    assert sorted(calls) == ["K'=32 of 96", "K'=32 of 96, long moves",
                             "operands K'=5 of 12"]
    assert all(v.shape == (64, 32, 3) for v in calls["K'=32 of 96"]())
    assert all(bool(torch.isfinite(v).all())
               for v in calls["K'=32 of 96, long moves"]())
    ref = segment_kernel.segment_fields_plain(Eblk, Bblk, t0[:, :5],
                                              tn[:, :5])
    got = calls["operands K'=5 of 12"]()
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    # A real call: one float32 eccapfim step at 4^3 x 20 ppc.
    op = turns.path_operands(cpu, 4, ppc=20)
    assert eccapfim.segment_fields is segment_kernel.segment_fields
    K = op["t0"].shape[1]
    assert op["kc"] == K // 3 and op["t0"].dtype == torch.float32
    E_p, B_p = turns.CASES["segment_fields"][1](mods, cpu, 4, op)[
        f"operands K'={K // 3} of {K}"]()
    assert E_p.shape == (64, K // 3, 3) and bool(torch.isfinite(E_p).all())
    ops = {K: turns.fill_operands(cpu, 4, K) for K in (96, 112)}
    (t, v, B_p, valid), kw = ops[112]
    assert t.shape == (64, 112, 3) and int(valid.sum()) == 64 * 50
    assert kw == dict(q=-1.0, m=1.0, mpw=0.02, dt=1.5)
    calls = turns.CASES["ecsim_fill"][1](
        {"ops.ecsim_kernel": ecsim_kernel}, cpu, 4, ops)
    assert sorted(calls) == ["path K=112", "path K=96",
                             "random K=112 70% live"]
    L, Islot = calls["path K=112"]()
    ref = ecsim_kernel.ecsim_fill_plain(t, v, B_p, valid, **kw)
    assert torch.equal(L, ref[0]) and torch.equal(Islot, ref[1])
    L, Islot = calls["random K=112 70% live"]()
    assert L.shape == (64, 3, 12, 3, 12) and bool(torch.isfinite(L).all())
    # --dtype float64: the same operands, cast, through the twins
    f64 = torch.float64
    got = turns.CASES["segment_fields"][1](mods, cpu, 4, op, f64)[
        f"operands K'={K // 3} of {K}"]()
    ref = segment_kernel.segment_fields_plain(
        *(op[k].double() for k in ("Eblk", "Bblk")),
        op["t0"].double()[:, :K // 3], op["tn"].double()[:, :K // 3])
    assert got[0].dtype == f64
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    calls = turns.CASES["ecsim_fill"][1](
        {"ops.ecsim_kernel": ecsim_kernel}, cpu, 4, ops, f64)
    L, Islot = calls["path K=112"]()
    ref = ecsim_kernel.ecsim_fill_plain(t.double(), v.double(),
                                        B_p.double(), valid, **kw)
    assert L.dtype == f64 and torch.equal(L, ref[0])
