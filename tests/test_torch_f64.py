"""The port's float64 path on the card, as far as the CPU can check it.

* The float64 entry points of the kernels (``kernels.F64_KERNELS``): each
  ``<name>_f64`` row of ``kernels.SIGNATURES`` has its float32 row's
  layout with ``c_double`` wherever that row has ``c_float`` (an entry
  point fed float32-rounded scalars would miss its twin by ~1e-8
  relative), its launches are counted under its own name, and
  ``kernels.entry`` picks it for a float64 tensor, the float32 entry for
  a float32 one, and refuses float16 and bfloat16.
* The schemes' entry takes float64 on the card: with ``XPIC_X64`` unset
  ``build_simulation`` hands a ``cuda:0`` float64 run to the scheme, and
  still refuses any dtype but float32 and float64 there.
* The float32 fill twin's own distance from the float64 fill twin on the
  same float32-rounded operands (``benchmarks.turns.fill_operands`` at
  8^3 x 50 ppc, K = 112): the part of the float32 ``ecsim_fill``
  kernel's gap from its twin that the twin itself carries.  The kernels
  run only on the card (``chip_smoke.py`` phase 16 and
  ``tests/test_torch_kernels.py`` hold them against these twins there).
"""

import ctypes

import pytest
import torch

import xpic_tpu_torch.schemes as tschemes
import xpic_tpu_torch.schemes.ecsim as tecsim
from xpic_tpu_torch import kernels
from xpic_tpu_torch.benchmarks.turns import fill_operands
from xpic_tpu_torch.config import Config
from xpic_tpu_torch.ops.ecsim_kernel import ecsim_fill_plain


def test_f64_entry_points_take_doubles():
    rows = {n: a for n, a in kernels.SIGNATURES.items()
            if n.endswith(kernels.F64)}
    assert sorted(rows) == sorted(n + kernels.F64
                                  for n in kernels.F64_KERNELS)
    for name, args in rows.items():
        f32 = kernels.SIGNATURES[name.removesuffix(kernels.F64)]
        assert len(args) == len(f32), name
        for a, b in zip(args, f32):
            assert a is (ctypes.c_double if b is ctypes.c_float else b), name
        assert ctypes.c_float not in args, name
        assert kernels.LAUNCHES[name] == 0
    for name in kernels.F64_KERNELS:
        assert kernels.entry(name, torch.zeros(1)) == name
        assert kernels.entry(name, torch.zeros(1, dtype=torch.float64)) \
            == name + kernels.F64
        for dtype in (torch.float16, torch.bfloat16):
            with pytest.raises(TypeError):
                kernels.entry(name, torch.zeros(1, dtype=dtype))
    with pytest.raises(TypeError):  # no float64 instantiation
        kernels.entry("mass_apply", torch.zeros(1, dtype=torch.float64))


def test_float64_is_the_cards_default(monkeypatch, tmp_path):
    built = []

    class Recorded(tecsim.EcsimSimulation):
        def __init__(self, cfg, device, dtype, mass):
            built.append((device, dtype))

    monkeypatch.setattr(tecsim, "EcsimSimulation", Recorded)
    monkeypatch.delenv("XPIC_X64", raising=False)
    cfg = Config.from_json({
        "Simulation": "ecsim", "OutputDirectory": str(tmp_path),
        "Geometry": {"x": 2.0, "y": 2.0, "z": 2.0, "t": 1.0, "dx": 0.5,
                     "dy": 0.5, "dz": 0.5, "dt": 1.0,
                     "diagnose_period": 1.0},
        "Particles": [], "Presets": [], "Diagnostics": []})
    tschemes.build_simulation(cfg, device="cuda:0")
    monkeypatch.setenv("XPIC_X64", "0")
    tschemes.build_simulation(cfg, device="cuda:0")
    assert built == [(torch.device("cuda", 0), torch.float64),
                     (torch.device("cuda", 0), torch.float32)]
    for dtype in (torch.float16, torch.bfloat16):
        with pytest.raises(ValueError, match="float32 and float64"):
            tschemes.build_simulation(cfg, device="cuda:0", dtype=dtype)


def test_f32_fill_twin_gap_from_f64_twin():
    args32, kw = fill_operands(torch.device("cpu"), 8, 112)
    args64 = tuple(a.double() for a in args32[:3]) + args32[3:]
    L32, I32 = ecsim_fill_plain(*args32, **kw)
    L64, I64 = ecsim_fill_plain(*args64, **kw)
    gap = max(float((L32.double() - L64).abs().max() / L64.abs().max()),
              float((I32.double() - I64).abs().max() / I64.abs().max()))
    # float32 slot sums of ~50 live slots a cell: a few ulp of the largest
    # magnitude, and less than half of the float32 kernel's 1.086e-6 gap
    # from this twin on the card
    assert 0.0 < gap <= 5e-7
