"""Time-integration schemes (counterpart of ``xpic_tpu/schemes/__init__.py``).

``build_simulation`` dispatches on the config ``Simulation`` key like the
reference factory (src/interfaces/simulation.cpp:160-182): ``basic``,
``ecsim``, ``ecsimcorr`` and ``eccapfim``.

Device and dtype: the entry points run on the card.  ``device=None``
means ``cuda:0`` and raises where there is no CUDA device: a run is put
on the CPU only when the caller asks for it.  ``dtype=None`` follows the
JAX package's rule: float64 unless ``XPIC_X64=0``.  The port's kernels
are float32, as the TPU kernels are, so a float64 run on the card is
refused at once.  ``mass=None`` reads ``XPIC_MASS`` when the simulation
is built; the ECSIM family's mass route then follows
``parallel.step.mass_route``.
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
    if device.type == "cuda" and dtype != torch.float32:
        raise ValueError(
            f"{dtype} on the card: the port's CUDA kernels are float32, as "
            f"the TPU kernels are.  Run with XPIC_X64=0 on the card, or with "
            f"--device cpu (device='cpu') for the float64 parity path")
    cls = table[cfg.scheme]
    if issubclass(cls, EcsimSimulation):
        return cls(cfg, device, dtype, mass)
    return cls(cfg, device, dtype)
