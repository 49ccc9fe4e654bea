"""Joining a multi-rank run (counterpart of
``xpic_tpu/runtime/distributed.py``: the reference's ``mpiexec -n N``).

One process per rank, joined by ``torch.distributed``.  The group comes
from the JAX package's variables (``XPIC_COORDINATOR`` = ``host:port``,
``XPIC_NUM_PROCESSES``, ``XPIC_PROCESS_ID``) or from ``torchrun``'s
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  Nothing
else tells a process of a cluster: a single process with ``"Mesh": N``
starts its N ranks itself (``runtime/cli.py``).

Device and backend: rank r runs on ``cuda:(r % device_count)``, or on
the CPU when the caller asks for it (the tests).  The backend is NCCL
when every rank has a card of its own, gloo on the CPU, and gloo when
ranks share a card (NCCL refuses two ranks on one device; the mesh then
stages its planes through pinned host buffers).  Both choices are logged
and returned, never made silently.  A rank that cannot get its device
fails the run: no rank runs on the CPU in its place.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import socket

import torch
import torch.distributed as dist

log = logging.getLogger("xpic")


@dataclasses.dataclass(frozen=True)
class RankInfo:
    rank: int
    world: int
    device: torch.device
    backend: str
    shared_card: bool  # more ranks than cards: ranks share a card

    def describe(self) -> str:
        return (f"rank {self.rank}/{self.world} on {self.device}, backend "
                f"{self.backend}, ranks share a card: {self.shared_card}")


def launched_group():
    """``(init_method, rank, world)`` when this process was started as a
    rank of a group (``XPIC_*`` or ``torchrun``'s variables), else
    None."""
    if "XPIC_NUM_PROCESSES" in os.environ:
        coord = os.environ.get("XPIC_COORDINATOR")
        if coord is None:
            raise RuntimeError("XPIC_NUM_PROCESSES is set without "
                               "XPIC_COORDINATOR (host:port)")
        return (f"tcp://{coord}", int(os.environ.get("XPIC_PROCESS_ID", 0)),
                int(os.environ["XPIC_NUM_PROCESSES"]))
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        addr = os.environ["MASTER_ADDR"]
        port = os.environ.get("MASTER_PORT", "29500")
        return (f"tcp://{addr}:{port}", int(os.environ.get("RANK", 0)),
                int(os.environ["WORLD_SIZE"]))
    return None


def free_port() -> int:
    """A free TCP port on localhost for a group started here."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(rank: int, world: int, device=None):
    """``(device, shared_card)`` of rank ``rank``: ``cuda:(rank %
    device_count)`` unless ``device`` names the CPU."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu"), False
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"rank {rank}: no CUDA device (ask for the CPU with --device "
            f"cpu)")
    n = torch.cuda.device_count()
    return torch.device("cuda", rank % n), world > n


def choose_backend(device: torch.device, shared_card: bool) -> str:
    if device.type == "cpu" or shared_card:
        return "gloo"
    return "nccl"


def join(init_method: str, rank: int, world: int, device=None,
         backend: str | None = None) -> RankInfo:
    """Join the group as rank ``rank`` of ``world`` and pin the rank's
    device; returns what was chosen (also logged)."""
    dev, shared = rank_device(rank, world, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or choose_backend(dev, shared)
    dist.init_process_group(backend=backend, init_method=init_method,
                            rank=rank, world_size=world)
    info = RankInfo(rank, world, dev, backend, shared)
    log.info("Joined the group: %s", info.describe())
    return info


def leave() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
