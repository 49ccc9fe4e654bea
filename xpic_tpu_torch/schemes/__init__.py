"""Time-integration schemes (counterpart of ``xpic_tpu/schemes/__init__.py``).

``build_simulation`` dispatches on the config ``Simulation`` key like the
reference factory (src/interfaces/simulation.cpp:160-182): ``basic``,
``ecsim``, ``ecsimcorr`` and ``eccapfim``.

Device and dtype: the entry points run on the card.  ``device=None``
means ``cuda:0`` and raises where there is no CUDA device: a run is put
on the CPU only when the caller asks for it.  ``dtype=None`` follows the
JAX package's rule: float64 unless ``XPIC_X64=0`` (float32).  The card
runs both: every kernel that a float64 path calls has a float64
instantiation (``kernels.F64_KERNELS``); any other dtype on the card is
refused at once.  ``mass=None`` reads ``XPIC_MASS`` when the simulation
is built; the ECSIM family's mass route then follows
``parallel.step.mass_route`` (float64 always assembles).
"""

from __future__ import annotations

import os

import torch

from ..config import Config

def default_dtype() -> torch.dtype:
    return torch.float32 if os.environ.get("XPIC_X64", "1") == "0" \
        else torch.float64


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: xpic_tpu_torch runs on the card by default; "
                "ask for the CPU with device='cpu' (--device cpu)")
        return torch.device("cuda", 0)
    return torch.device(device)


def build_simulation(cfg: Config, device=None, dtype=None, mass=None):
    from .basic import BasicSimulation
    from .eccapfim import EccapfimSimulation
    from .ecsim import EcsimSimulation
    from .ecsimcorr import EcsimcorrSimulation

    table = {"basic": BasicSimulation, "ecsim": EcsimSimulation,
             "ecsimcorr": EcsimcorrSimulation,
             "eccapfim": EccapfimSimulation}
    if cfg.scheme not in table:
        raise ValueError(f"unknown simulation scheme: {cfg.scheme!r}")
    device = resolve_device(device)
    dtype = default_dtype() if dtype is None else dtype
    if device.type == "cuda" and dtype not in (torch.float32, torch.float64):
        raise ValueError(
            f"{dtype} on the card: the port's CUDA kernels take float32 and "
            f"float64 (XPIC_X64=0 selects float32, the default is float64)")
    cls = table[cfg.scheme]
    if issubclass(cls, EcsimSimulation):
        return cls(cfg, device, dtype, mass)
    return cls(cfg, device, dtype)
