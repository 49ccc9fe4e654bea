"""Build, bind and count the port's hand-written Hopper kernels.

The CUDA sources under ``xpic_tpu_torch/csrc`` have a plain C interface.
:func:`load` compiles them with ``nvcc`` for ``sm_90a``, one ``nvcc``
per source, all started together, and links the objects into one shared
library under ``build/xpic_tpu_torch/`` at the repository root (rebuilt
when a hash of the sources changes), then binds it with ``ctypes``.  A
missing ``nvcc`` or a failed compile raises ``RuntimeError`` with the
compiler's output: there is no fallback.

Every C entry point enqueues its kernel on the caller's CUDA stream and
returns ``cudaGetLastError()``; :func:`call` raises when that is not 0
and adds one to ``LAUNCHES[name]``, the count a run reads to show that
its path went through the kernel.

The kernels take float32.  The four that the float64 path of the schemes
runs (``F64_KERNELS``) have a second entry point ``xpic_<name>_f64``,
with double scalars: the kernel template instantiated for float64
(``cheb_step``, ``slot_gather``) or a float64 kernel of its own
(``segment_fields``, ``ecsim_fill``); :func:`entry` picks the entry
point from a tensor's dtype, and the launches of each are counted under
its own name (``cheb_step_f64``, ...), so that a run shows which dtype
its path took.  :func:`kernel_info` reads what each float64 kernel takes
on the card (registers, shared memory, resident warps).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "xpic_tpu_torch"
LIB_NAME = "libxpic_kernels.so"
# Where the CUDA toolkit puts nvcc when it is not on PATH.
TOOLKIT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float, ctypes.c_double)
# C entry point -> argument types (pointers and the stream as void*).
SIGNATURES = {
    # rhs, shift, x, r, d0, d1, nx, ny, nz, periodic x/y/z,
    # 1/dx, 1/dy, 1/dz, beta, beta*lam_cc, degree, stream
    "cheb_step": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                  _F, _F, _F, _F, _F, _I, _P),
    # The slab form, one sweep a launch: rhs, shift, x, r, d_in, d_out,
    # nx, ny, nz (own planes), periodic x/y, ghost plane below/above,
    # 1/dx, 1/dy, 1/dz, beta, beta*lam_cc, sweep k, degree, stream
    "cheb_sweep": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                   _F, _F, _F, _F, _F, _I, _I, _P),
    # P, out, up, dn, G, AT, A, axis, n_ax, nx, ny, stream
    "rebin_extract": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # P, up, dn, out, G, AT, A, axis, nx, ny, nz, z ghost planes, stream
    "rebin_place": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # xg, packed, Y, G, K, stream
    "mass_apply": (_P, _P, _P, _I, _I, _P),
    # t, Fg, out, G, K, stream
    "slot_gather": (_P, _P, _P, _I, _I, _P),
    # Eblk, Bblk, t0, tn, E_p, B_p, G, K, row stride of t0/tn, stream
    "segment_fields": (_P, _P, _P, _P, _P, _P, _I, _I, _L, _P),
    # t, v, B_p, valid, L, Islot, G, K, (dt/2) q/m, (dt^2/2) mpw q^2/m,
    # q mpw, stream
    "ecsim_fill": (_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _P),
    # x, out, G, probe (0 copy .. 5 reduce16), stream
    "prims": (_P, _P, _I, _I, _P),
    # The float64 instantiations: the rows above with double scalars.
    "cheb_step_f64": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      _D, _D, _D, _D, _D, _I, _P),
    "cheb_sweep_f64": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _D, _D, _D, _D, _D, _I, _I, _P),
    "slot_gather_f64": (_P, _P, _P, _I, _I, _P),
    "segment_fields_f64": (_P, _P, _P, _P, _P, _P, _I, _I, _L, _P),
    "ecsim_fill_f64": (_P, _P, _P, _P, _P, _P, _I, _I, _D, _D, _D, _P),
}
# The kernels with a float64 entry point, and its suffix.
F64_KERNELS = ("cheb_step", "cheb_sweep", "slot_gather", "segment_fields",
               "ecsim_fill")
F64 = "_f64"
# What kernel_info reports, in the order of the C side's out[5].
INFO_KEYS = ("registers", "smem_bytes", "threads", "warps_per_sm",
             "local_bytes")

LAUNCHES = {name: 0 for name in SIGNATURES}
BUILD_LOG = ""

_lib = None


def reset_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources():
    return sorted(_CSRC.glob("*.cu")), sorted(_CSRC.glob("*.cuh"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cus, cuhs = _sources()
    for path in cus + cuhs:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.access(TOOLKIT_NVCC, os.X_OK):
        nvcc = TOOLKIT_NVCC
    if nvcc is None:
        raise RuntimeError(
            f"nvcc not found on PATH or at {TOOLKIT_NVCC}: the port's CUDA "
            "kernels cannot be built")
    return nvcc


def _run_all(cmds) -> None:
    """Run the commands in parallel, append their output to BUILD_LOG,
    and raise on the first that failed."""
    global BUILD_LOG
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    BUILD_LOG += "".join(outs)
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {p.returncode}): {' '.join(cmd)}\n{out}")


def _build(lib_path: Path, stamp: Path, digest: str) -> None:
    global BUILD_LOG
    BUILD_LOG = ""
    nvcc = _find_nvcc()
    cus, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [os.path.join(work, p.stem + ".o") for p in cus]
        _run_all([[nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-c", "-o", obj,
                   str(cu)] for cu, obj in zip(cus, objs)])
        tmp = os.path.join(work, LIB_NAME)
        _run_all([[nvcc, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, lib_path)
    stamp.write_text(digest)


def load():
    """Build (when the sources changed) and bind the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _source_hash()
    if not (lib_path.exists() and stamp.exists()
            and stamp.read_text() == digest):
        _build(lib_path, stamp, digest)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, "xpic_" + name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    for name in F64_KERNELS:
        fn = getattr(lib, f"xpic_{name}{F64}_info")
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def kernel_info(name: str) -> dict:
    """What the float64 kernel ``name`` (a key of ``F64_KERNELS`` with
    ``F64``) takes on the current CUDA device, by the runtime's
    attributes and occupancy at its launch's block and shared memory:
    ``INFO_KEYS``."""
    out = (ctypes.c_int * len(INFO_KEYS))()
    err = getattr(load(), f"xpic_{name}_info")(out)
    if err != 0:
        raise RuntimeError(f"{name}: kernel_info failed with error {err}")
    return dict(zip(INFO_KEYS, out))


def entry(name: str, T) -> str:
    """The entry point of kernel ``name`` for the dtype of ``T``: ``name``
    for float32, ``name + F64`` for float64 where the kernel has one
    (``F64_KERNELS``); TypeError for any other dtype, float16 and
    bfloat16 included."""
    import torch

    if T.dtype == torch.float32:
        return name
    if T.dtype == torch.float64 and name in F64_KERNELS:
        return name + F64
    takes = "float32 or float64" if name in F64_KERNELS else "float32"
    raise TypeError(f"{name}: {takes} required on CUDA, got {T.dtype}")


def check_operand(name: str, T, shape, dtype=None) -> None:
    """Raise unless ``T`` is what a kernel takes: of ``dtype`` (default
    float32; TypeError), contiguous and of ``shape`` (ValueError)."""
    import torch

    dtype = torch.float32 if dtype is None else dtype
    if T.dtype != dtype:
        want = str(dtype).removeprefix("torch.")
        raise TypeError(f"{name}: {want} required on CUDA, got {T.dtype}")
    if tuple(T.shape) != tuple(shape) or not T.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {tuple(shape)} "
                         f"tensor, got {tuple(T.shape)}")


def call(name: str, *args, device) -> None:
    """Launch kernel ``name`` on the current stream of ``device`` and
    count the launch; raises on a refused launch."""
    import torch

    lib = load()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, "xpic_" + name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1
