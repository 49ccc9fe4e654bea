"""One of this tree's kernels against another checkout's, in turns on one
CUDA card.

    python -m xpic_tpu_torch.benchmarks.turns OTHER_ROOT [--kernel NAME]
        [--side N] [--turns T]

OTHER_ROOT is the root of another checkout of the repository, for
example an earlier commit unpacked by ``git archive`` into a directory
that ``.gitignore`` lists.  Each tree builds its kernels from its own
sources; the other tree's library goes under this tree's
``build/turns_other/``, so nothing is written into OTHER_ROOT.  NAME is a
key of ``CASES`` (default ``cheb_step``): the kernel's wrapper at the
main paths' shapes, on the same inputs in both trees, made from a numpy
seed; ``mass_apply`` and ``slot_gather`` at K = 80 and 112,
``segment_fields`` at K' = 32 of K = 96 and on the operands of a real
call: the first fast-path call of one eccapfim step at side^3 x 50 ppc
(:func:`path_operands`, this tree's scheme, run before the timing);
``ecsim_fill`` on the drifted and migrated side^3 x 50 ppc state at
K = 96 and 112 (:func:`fill_operands`, as ``chip_smoke.py``'s phase 3
makes it) and on random inputs with 70% of slots live.  Each turn times
the other tree, this tree, this tree, the other tree: ``ms`` back to back
(``benchmarks.device_ms``, no host launch gap) and ``call_ms`` (one call
between two CUDA events, the host's gap in).  Prints one JSON line: the
turns, each case's medians, each tree's launches a call, the largest
difference between the two trees' results and the card's name and power
limit.  Without CUDA it exits non-zero.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import sys

import numpy as np
import torch

from . import call_ms, card_label, device_ms, resolve_device

_PKG = __package__.split(".")[0]


def _own_modules() -> dict:
    return {k: m for k, m in sys.modules.items()
            if k == _PKG or k.startswith(_PKG + ".")}


def load_other(root: str, names) -> dict:
    """The other checkout's modules ``names`` (dotted, under the package)
    and its ``kernels``, imported from ``root`` and then taken out of
    ``sys.modules``, so that this tree's package stays the one imported
    by name.  The functions keep their own modules' globals; the other
    ``kernels`` builds under this tree's ``build/turns_other/``."""
    from .. import kernels

    root = os.path.abspath(root)
    if not os.path.isdir(os.path.join(root, _PKG)):
        raise SystemExit(f"{root} holds no {_PKG} package")
    own = _own_modules()
    for name in own:
        del sys.modules[name]
    sys.path.insert(0, root)
    bytecode = sys.dont_write_bytecode
    sys.dont_write_bytecode = True
    try:
        mods = {m: importlib.import_module(f"{_PKG}.{m}")
                for m in (*names, "kernels")}
    finally:
        sys.dont_write_bytecode = bytecode
        sys.path.remove(root)
        for name in _own_modules():
            del sys.modules[name]
        sys.modules.update(own)
    mods["kernels"].BUILD_DIR = kernels.BUILD_DIR.parent / "turns_other"
    return mods


def _cheb_case(mods, device, side, operands=None):
    """K1: one degree-12 Chebyshev apply on rhs [3, side, side, side]
    float32, shift 0.37 (a device scalar), periodic, dx = 0.5, dt = 1.5."""
    geom = mods["config"].Geometry(dx=0.5, dy=0.5, dz=0.5, dt=1.5, nx=side,
                                   ny=side, nz=side, nt=1)
    rng = np.random.default_rng(2)
    rhs = torch.tensor(rng.standard_normal((3, side, side, side)),
                       dtype=torch.float32, device=device)
    shift = torch.tensor(0.37, dtype=torch.float32, device=device)
    cheb = mods["ops.stencil_kernel"].cheb_matM_inv
    return lambda: cheb(rhs, shift, geom=geom, degree=12, dt=geom.dt)


def _mass_case(mods, device, side, operands=None):
    """K4: Y = W^T M W xg on side^3 cells at K = 80 (the fused path) and
    112 (the CLI and ecsimcorr runs): 50 live slots a cell at random
    positions, |b| ~ 0.2, padding slots at the cell centre with coef 0."""
    apply = mods["ops.mass_kernel"].mass_apply_slots
    G = side ** 3
    calls = {}
    for K in (80, 112):
        rng = np.random.default_rng(K)
        valid = rng.random((G, K)) < 50 / K
        t = np.where(valid[..., None], rng.random((G, K, 3)), 0.5)
        b = 0.15 * rng.standard_normal((G, K, 3))
        coef = np.where(valid, 0.0225 / (1.0 + np.sum(b * b, axis=-1)), 0.0)
        packed = np.concatenate(
            [np.moveaxis(t, -1, 1), np.moveaxis(b, -1, 1), coef[:, None],
             np.zeros((G, 1, K))], axis=1)
        P = torch.tensor(np.ascontiguousarray(packed), dtype=torch.float32,
                         device=device)
        xg = torch.tensor(rng.standard_normal((G, 3, 12)),
                          dtype=torch.float32, device=device)
        calls[f"K={K}"] = lambda P=P, xg=xg: apply(xg, P)
    return calls


def _gather_case(mods, device, side, operands=None):
    """K5: E at the slots from the slot values on side^3 cells at K = 80
    (the fused path) and 112 (the CLI and ecsimcorr runs): t uniform in
    the cell, Fg ~ N(0, 1), numpy seed K."""
    gather = mods["ops.ecsim_kernel"].ecsim_gather
    G = side ** 3
    calls = {}
    for K in (80, 112):
        rng = np.random.default_rng(K)
        t = torch.tensor(rng.random((G, K, 3)), dtype=torch.float32,
                         device=device)
        Fg = torch.tensor(rng.standard_normal((G, 3, 12)),
                          dtype=torch.float32, device=device)
        calls[f"K={K}"] = lambda t=t, Fg=Fg: gather(t, Fg)
    return calls


def _segment_case(mods, device, side, operands=None):
    """K6: K' = 32 crosser columns of [side^3, 96, 3] moves, read in
    place, as in chip_smoke's phase 3: positions uniform in the cell,
    moves uniform in +-0.9 cell a axis (1 to 4 segments), the first 4
    slots at rest, windows N(0, 0.1^2); and the call ``operands``
    (:func:`path_operands`) when given."""
    fields = mods["ops.segment_kernel"].segment_fields
    G = side ** 3
    rng = np.random.default_rng(11)
    t0 = rng.random((G, 96, 3))
    move = rng.uniform(-0.9, 0.9, (G, 96, 3))
    move[:, :4] = 0.0

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    Eblk = f32(0.1 * rng.standard_normal((G, 3, 6, 6, 6)))
    Bblk = f32(0.1 * rng.standard_normal((G, 3, 6, 6, 6)))
    a, b = f32(t0), f32(t0 + move)
    calls = {"K'=32 of 96": lambda: fields(Eblk, Bblk, a[:, :32],
                                           b[:, :32])}
    if operands is not None:
        op, kc = operands, operands["kc"]
        calls[f"operands K'={kc} of {op['t0'].shape[1]}"] = lambda: fields(
            op["Eblk"], op["Bblk"], op["t0"][:, :kc], op["tn"][:, :kc])
    return calls


def _fill_case(mods, device, side, operands=None):
    """K7: the ECSIM fill on ``operands`` ({K: :func:`fill_operands`},
    K = 96 and 112) and on random inputs at K = 112 with 70% of slots
    live: t uniform in the cell, v ~ N(0, 0.05^2), B_p ~ N(0, 0.25^2)
    (|b| ~ 0.2 at q/m = -1, dt = 1.5), numpy seed 7."""
    fill = mods["ops.ecsim_kernel"].ecsim_fill
    calls = {f"path K={K}": lambda args=args, kw=kw: fill(*args, **kw)
             for K, (args, kw) in operands.items()}
    G, K = side ** 3, 112
    rng = np.random.default_rng(7)

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    valid = torch.tensor(rng.random((G, K)) < 0.7, device=device)
    t, v, B_p = (f32(rng.random((G, K, 3))),
                 f32(0.05 * rng.standard_normal((G, K, 3))),
                 f32(0.25 * rng.standard_normal((G, K, 3))))
    kw = dict(q=-1.0, m=1.0, mpw=0.02, dt=1.5)
    calls[f"random K={K} 70% live"] = lambda: fill(t, v, B_p, valid, **kw)
    return calls


def fill_operands(device, side, slots, ppc=50, vth=0.014):
    """The ECSIM fill's operands on the drifted and migrated side^3 x
    ``ppc`` state at K = ``slots`` (cells of 0.5, dt 1.5): particles
    uniform in the box with thermal momenta of ``vth`` (numpy seed 1), B =
    0.2 z + N(0, 0.05^2) a component (seed 13) gathered at the slots.
    Returns ((t, v, B_p, valid), the fill's keywords)."""
    from ..config import Geometry
    from ..convert import state_from_numpy
    from ..ops.binning import bin_state, drift_state, rebin
    from ..ops.gather_scatter import B_STAGGER, cell_t, gather_vector

    geom = Geometry(dx=0.5, dy=0.5, dz=0.5, dt=1.5, nx=side, ny=side,
                    nz=side, nt=1)
    rng = np.random.default_rng(13)
    shape = (3,) + geom.shape
    Bf = np.zeros(shape)
    Bf[2] = 0.2
    Bf += 0.05 * rng.standard_normal(shape)
    rng = np.random.default_rng(1)
    n = geom.n_cells * ppc
    r = rng.random((n, 3)) * np.array(geom.L)
    p = rng.standard_normal((n, 3)) * vth
    Bt, _, _, sp = state_from_numpy(Bf, np.zeros(1), np.zeros(1), r, p,
                                    np.ones(n, bool), device=device,
                                    dtype=torch.float32)
    st = rebin(drift_state(bin_state(sp, geom, slots), geom), geom)
    t = cell_t(geom, st.r)
    B_p = gather_vector(Bt, t, st.valid, geom, order=1, width=3, anchor=-1,
                        stagger=B_STAGGER)
    return (t, st.p, B_p, st.valid), dict(q=-1.0, m=1.0, mpw=1.0 / ppc,
                                          dt=geom.dt)


def whole_rows(T):
    """The [G, K, 3] rows that a column slice ``T = X[:, :kc]`` of a
    [G, K, 3] tensor X is read from (a view of X)."""
    ld = T.stride(0)
    return T.as_strided((T.shape[0], ld // 3, 3), (ld, 3, 1),
                        T.storage_offset())


def capture_fast_call(fim, store):
    """Wrap ``fim.segment_fields`` (the eccapfim scheme module's) so that
    the operands of its first call on column slices (the fast path's
    crosser columns) are copied into ``store``: Eblk, Bblk, t0 and tn
    whole, and kc.  Returns the function it wrapped, to be put back."""
    inner = fim.segment_fields

    def wrapper(Eblk, Bblk, t0, tn):
        if not store and t0.stride(0) > 3 * t0.shape[1]:
            store.update(Eblk=Eblk.clone(), Bblk=Bblk.clone(),
                         t0=whole_rows(t0).clone(),
                         tn=whole_rows(tn).clone(), kc=t0.shape[1])
        return inner(Eblk, Bblk, t0, tn)

    fim.segment_fields = wrapper
    return inner


def eccapfim_config(out_dir, side, ppc, steps):
    """bench.py's eccapfim workload: ``side``^3 cells of 0.5, dt 1.5,
    periodic, one electron species at ``ppc`` and T = 0.1 keV, no field;
    the default diagnostics (and ConvergenceHistory) every step."""
    L = side * 0.5
    periodic = "DM_BOUNDARY_PERIODIC"
    return {
        "Simulation": "eccapfim",
        "OutputDirectory": out_dir,
        "Geometry": {"x": L, "y": L, "z": L, "t": steps * 1.5,
                     "dx": 0.5, "dy": 0.5, "dz": 0.5, "dt": 1.5,
                     "diagnose_period": 1.5, "da_boundary_x": periodic,
                     "da_boundary_y": periodic, "da_boundary_z": periodic},
        "Particles": [{"sort_name": "electrons", "Np": ppc, "n": 1.0,
                       "q": -1.0, "m": 1.0, "T": 0.1}],
        "Presets": [
            {"command": "SetParticles", "particles": "electrons",
             "coordinate": {"name": "CoordinateInBox"},
             "momentum": {"name": "MaxwellianMomentum", "tov": True}},
        ],
        "Diagnostics": [],
    }


def path_operands(device, side, ppc=50) -> dict:
    """The operands of the first fast-path ``segment_fields`` call of
    one float32 eccapfim step of :func:`eccapfim_config` at side^3 x
    ``ppc`` on ``device`` (the particles loaded from seed 5489, as
    ``chip_smoke.py`` loads them), as :func:`capture_fast_call` keeps
    them.  Raises if the step made no such call."""
    import tempfile

    from .. import schemes
    from ..commands import particles_load
    from ..config import Config
    from ..schemes import eccapfim as fim

    store = {}
    with tempfile.TemporaryDirectory(prefix="xpic_turns_") as work:
        cfg = Config.from_json(eccapfim_config(os.path.join(work, "out"),
                                               side, ppc, 1))
        particles_load.seed(5489)
        sim = schemes.build_simulation(cfg, device=device,
                                       dtype=torch.float32)
        os.makedirs(cfg.out_dir, exist_ok=True)
        inner = capture_fast_call(fim, store)
        try:
            sim.initialize()
            sim.calculate()
        finally:
            fim.segment_fields = inner
            sim.finalize()
    if not store:
        raise RuntimeError("the eccapfim step made no fast-path "
                           "segment_fields call")
    return store


# kernel -> (the modules its case calls, the case: (modules, device,
# side, the operands of a real call or None) -> one call of the kernel's
# wrapper, or {case name: call})
CASES = {"cheb_step": (("ops.stencil_kernel", "config"), _cheb_case),
         "mass_apply": (("ops.mass_kernel",), _mass_case),
         "slot_gather": (("ops.ecsim_kernel",), _gather_case),
         "segment_fields": (("ops.segment_kernel",), _segment_case),
         "ecsim_fill": (("ops.ecsim_kernel",), _fill_case)}


def _operands(kernel, device, side):
    """The operands of real calls that ``kernel``'s case takes, made by
    this tree's code before the timing, or None."""
    if kernel == "segment_fields":
        return path_operands(device, side)
    if kernel == "ecsim_fill":
        return {K: fill_operands(device, side, K) for K in (96, 112)}
    return None


def _max_diff(a, b) -> float:
    if isinstance(a, (tuple, list)):
        return max(_max_diff(x, y) for x, y in zip(a, b))
    return float((a - b).abs().max())


def run(other_root: str, kernel: str, side: int, turns: int,
        device) -> dict:
    names, case = CASES[kernel]
    trees = {"this": {m: importlib.import_module(f"{_PKG}.{m}")
                      for m in (*names, "kernels")},
             "other": load_other(other_root, names)}
    operands = _operands(kernel, device, side)
    calls, results, launches = {}, {}, {}
    for tree, mods in trees.items():
        made = case(mods, device, side, operands)
        calls[tree] = made if isinstance(made, dict) else {
            f"side={side}": made}
        counts = mods["kernels"]
        counts.load()
        launches[tree] = {}
        for label, fn in calls[tree].items():
            before = counts.LAUNCHES[kernel]
            results[tree, label] = fn()
            launches[tree][label] = counts.LAUNCHES[kernel] - before
    torch.cuda.synchronize(device)
    rows = []
    for label in calls["this"]:
        for _ in range(turns):
            for tree in ("other", "this", "this", "other"):
                fn = calls[tree][label]
                rows.append(dict(case=label, tree=tree,
                                 ms=device_ms(fn, device),
                                 call_ms=call_ms(fn, device)))
    medians = {label: {f"{tree}_{key}": statistics.median(
        r[key] for r in rows if r["case"] == label and r["tree"] == tree)
        for tree in ("this", "other") for key in ("ms", "call_ms")}
        for label in calls["this"]}
    return dict(
        kernel=kernel, side=side, turns=rows,
        medians=medians, launches_per_call=launches,
        max_abs_diff={label: _max_diff(results["this", label],
                                       results["other", label])
                      for label in calls["this"]},
        other_root=os.path.abspath(other_root), device=card_label(device))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="xpic_tpu_torch.benchmarks.turns")
    parser.add_argument("other_root",
                        help="root of the other checkout to time against")
    parser.add_argument("--kernel", choices=sorted(CASES),
                        default="cheb_step", help="the kernel to time")
    parser.add_argument("--side", type=int, default=32,
                        help="cells a side of the field (default 32)")
    parser.add_argument("--turns", type=int, default=2,
                        help="turns of other, this, this, other (default 2)")
    args = parser.parse_args(argv)
    device = resolve_device("cuda:0")
    print(json.dumps(run(args.other_root, args.kernel, args.side, args.turns,
                         device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
