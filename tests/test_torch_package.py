"""Structure of the PyTorch port: it imports without JAX, pins IEEE
float32, refuses to run without its compiler, and counts no kernel
launch on the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import xpic_tpu_torch
from xpic_tpu_torch import kernels
from xpic_tpu_torch.config import Geometry
from xpic_tpu_torch.convert import binned_from_numpy
from xpic_tpu_torch.ops import neighbor_rebin as NR
from xpic_tpu_torch.ops.stencil_kernel import cheb_matM_inv

torch.set_num_threads(1)

PKG = Path(xpic_tpu_torch.__file__).resolve().parent
REPO = PKG.parent
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts)
    for p in PKG.rglob("*.py") if p.name != "__init__.py")


def test_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['xpic_tpu'] = None\n"
        "import importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_jax_or_reference_import_in_package():
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "xpic_tpu"), \
                    f"{path.name} imports {name}"


def test_config_is_a_verbatim_copy():
    ref = REPO / "xpic_tpu" / "config.py"
    assert (PKG / "config.py").read_text() == ref.read_text()


def test_precision_pins():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_load_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels, "TOOLKIT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.load()


def test_cpu_tensors_take_the_twins_and_count_nothing():
    kernels.reset_counts()
    geom = Geometry(dx=0.5, dy=0.5, dz=0.5, dt=1.5, nx=4, ny=4, nz=4, nt=1)
    rng = np.random.default_rng(0)
    rhs = torch.tensor(rng.standard_normal((3,) + geom.shape),
                       dtype=torch.float32)
    x = cheb_matM_inv(rhs, torch.tensor(0.1), geom=geom, degree=3,
                      dt=geom.dt)
    assert torch.isfinite(x).all()
    G, K = geom.n_cells, 16
    cells = np.stack(np.unravel_index(np.arange(G), geom.shape)[::-1], -1)
    r = (cells[:, None, :] + rng.random((G, K, 3))).astype(np.float32)
    st = binned_from_numpy(r, np.zeros_like(r), rng.random((G, K)) < 0.5,
                           device="cpu")
    _, load = NR.rebin_neighbor(st, geom)
    assert int(load[1]) == 0
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_other_devices_raise():
    geom = Geometry(dx=0.5, dy=0.5, dz=0.5, dt=1.5, nx=4, ny=4, nz=4, nt=1)
    rhs = torch.empty((3,) + geom.shape, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        cheb_matM_inv(rhs, 0.0, geom=geom, degree=3, dt=geom.dt)
    buf = torch.empty((geom.n_cells, 8, 16), device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        NR.rebin_extract(buf, geom, 0)
    with pytest.raises(RuntimeError, match="unsupported device"):
        NR.rebin_place(buf, buf[:, :, :8], buf[:, :, :8], geom, 0)
