"""The 1-D z slab decomposition over ``torch.distributed`` ranks
(counterpart of ``xpic_tpu/parallel/mesh.py``).

The JAX package shards its global-semantics kernels with GSPMD, and XLA
inserts the halo collective-permutes and the all-reduces.  Here every
rank is a process of its own that holds one z slab: ``nz / world``
planes of every field, and the cells of those planes in the binned
particle state.  The binned state ``[G, K]`` is z-major, so a slab is
one contiguous block of G and the cell-local kernels run on it as they
are.  Particle positions stay in global grid units.

What GSPMD inserted is explicit here, as three wrappers around the
local ops (``ops/*``):

* :meth:`SlabMesh.halo_pad` receives ghost z planes from the two
  neighbour ranks; an op then runs on the padded slab with no wrap in z,
  and a gather crops the ghost planes away;
* :meth:`SlabMesh.halo_fold` sends a deposit's ghost-plane sums to the
  rank that owns the plane, which adds them;
* :meth:`SlabMesh.allreduce_sum` / :meth:`allreduce_max` replace the
  global sums and maxima.

On one rank there is no mesh: ``Geometry.mesh`` is None and every op
takes its periodic roll, with no copy and no collective.

Every collective adds the bytes this rank sends to ``bytes_sent``, one
to ``calls[kind]`` and its wall time to ``seconds`` (after a device
synchronisation, so that the device work queued before it is not
counted).  With the gloo backend and tensors on the card
(two ranks sharing one card: NCCL refuses two ranks on one device), the
planes are staged through pinned host buffers.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch
import torch.distributed as dist

from ..config import PERIODIC

# What a later slice of the multi-device work does (ROADMAP A11b).
A11B = "ROADMAP A11b"


def mesh_of(geom):
    """The ``SlabMesh`` of a slab geometry; None for the whole grid (one
    rank), and for any geometry without the port's slab view (the JAX
    package's, which the tests hand to the ops)."""
    return getattr(geom, "mesh", None)


def z0_of(geom) -> int:
    """The slab's first global z plane (0 for the whole grid)."""
    return getattr(geom, "z0", 0)


def nz_global_of(geom) -> int:
    """The whole grid's z planes."""
    return getattr(geom, "nz_global", geom.nz)


def cells_global_of(geom) -> int:
    """The whole grid's cells."""
    return geom.nx * geom.ny * nz_global_of(geom)


def refuse(what: str):
    raise NotImplementedError(
        f"{what}: xpic_tpu_torch runs a 1-D z mesh (\"Mesh\": N) of the "
        f"ecsim scheme; the rest is {A11B}")


def make_mesh(shape, nz_global: int, z_bound: str = PERIODIC, *,
              rank: int | None = None, world: int | None = None,
              backend: str | None = None):
    """The rank's :class:`SlabMesh` for ``"Mesh": shape``: an int (or a
    1-tuple) N is a z mesh over N ranks; a (z, y) or (z, y, x) shape
    raises NotImplementedError (ROADMAP A11b).  ``rank`` and ``world``
    default to the initialised process group's."""
    if isinstance(shape, tuple):
        if len(shape) != 1:
            refuse(f"mesh shape {shape}")
        shape = shape[0]
    n = int(shape)
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    if world is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise RuntimeError(f'"Mesh": {n} needs {n} ranks, the process group '
                           f"has {world}")
    if nz_global % n:
        raise ValueError(f'"Mesh": {n} does not divide the grid\'s '
                         f"{nz_global} z cells")
    if backend is None and dist.is_initialized():
        backend = dist.get_backend()
    return SlabMesh(rank, world, nz_global, z_bound == PERIODIC, backend)


class SlabMesh:
    """One rank's view of the z slab decomposition: ``rank``, ``world``,
    the slab's first plane ``z0`` and its ``nz_local`` planes, and the
    neighbour ranks ``up`` (z0 + nz_local) and ``dn`` (z0 - 1): periodic,
    or None at a non-periodic global z bound."""

    def __init__(self, rank: int, world: int, nz_global: int,
                 periodic: bool, backend: str | None = "gloo"):
        self.rank, self.world = rank, world
        self.nz_global = nz_global
        self.nz_local = nz_global // world
        self.z0 = rank * self.nz_local
        self.periodic = periodic
        last = world - 1
        self.up = (rank + 1) % world if periodic or rank < last else None
        self.dn = (rank - 1) % world if periodic or rank > 0 else None
        self.backend = backend
        self.bytes_sent = 0
        self.seconds = 0.0
        self.calls: collections.Counter = collections.Counter()

    @property
    def is_root(self) -> bool:
        return self.rank == 0

    def reset_counts(self) -> None:
        self.bytes_sent = 0
        self.seconds = 0.0
        self.calls.clear()

    @contextlib.contextmanager
    def _clock(self, kind: str, like: torch.Tensor):
        self.calls[kind] += 1
        if like.device.type == "cuda":
            torch.cuda.synchronize(like.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds += time.perf_counter() - t0

    # -- transport ----------------------------------------------------------
    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type != "cpu"

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """The buffer the backend takes: ``t`` itself, or a pinned host
        copy under gloo."""
        t = t.contiguous()
        if not self._staged(t):
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        return h

    def _empty_like(self, t: torch.Tensor) -> torch.Tensor:
        if self._staged(t):
            return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return torch.empty_like(t, memory_format=torch.contiguous_format)

    def _back(self, h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return h.to(like.device) if self._staged(like) else h

    def exchange(self, to_up: torch.Tensor, to_dn: torch.Tensor, kind: str):
        """Send ``to_up`` to the up rank and ``to_dn`` to the down rank;
        returns ``(from_dn, from_up)``: what the down rank sent up and
        the up rank sent down (None where there is no neighbour).  Sends
        and receives are posted in the same order on every rank, so the
        pairs match with or without tags (NCCL has none)."""
        with self._clock(kind, to_up):
            return self._exchange(to_up, to_dn)

    def _exchange(self, to_up, to_dn):
        ops, recv = [], {}
        if self.up is not None:
            h = self._host(to_up)
            ops.append(dist.P2POp(dist.isend, h, self.up, tag=0))
            self.bytes_sent += h.numel() * h.element_size()
        if self.dn is not None:
            h = self._host(to_dn)
            ops.append(dist.P2POp(dist.isend, h, self.dn, tag=1))
            self.bytes_sent += h.numel() * h.element_size()
        if self.dn is not None:
            recv["dn"] = self._empty_like(to_up)
            ops.append(dist.P2POp(dist.irecv, recv["dn"], self.dn, tag=0))
        if self.up is not None:
            recv["up"] = self._empty_like(to_dn)
            ops.append(dist.P2POp(dist.irecv, recv["up"], self.up, tag=1))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        from_dn = self._back(recv["dn"], to_up) if "dn" in recv else None
        from_up = self._back(recv["up"], to_dn) if "up" in recv else None
        return from_dn, from_up

    # -- halo ---------------------------------------------------------------
    def halo_pad(self, F: torch.Tensor, lo: int, hi: int, dim: int = -3
                 ) -> torch.Tensor:
        """``F`` with ``lo`` ghost planes below its slab along ``dim``
        (the down rank's top planes) and ``hi`` above (the up rank's
        bottom planes); zeros beyond a non-periodic global bound."""
        n = F.shape[dim]
        if lo > n or hi > n:
            raise ValueError(f"halo of {max(lo, hi)} planes on a slab of {n}")
        to_up = F.narrow(dim, n - lo, lo)
        to_dn = F.narrow(dim, 0, hi)
        from_dn, from_up = self.exchange(to_up, to_dn, "halo_pad")
        if from_dn is None:
            from_dn = torch.zeros_like(to_up)
        if from_up is None:
            from_up = torch.zeros_like(to_dn)
        return torch.cat([from_dn, F, from_up], dim=dim)

    def halo_fold(self, Fp: torch.Tensor, lo: int, hi: int, dim: int = -3
                  ) -> torch.Tensor:
        """The adjoint of :meth:`halo_pad`: the padded sums ``Fp`` folded
        onto the slab.  The ghost planes go to the ranks that own them,
        which add them to their own planes' sums; a ghost plane beyond a
        non-periodic global bound is dropped."""
        n = Fp.shape[dim] - lo - hi
        own = Fp.narrow(dim, lo, n)
        ghost_dn = Fp.narrow(dim, 0, lo)
        ghost_up = Fp.narrow(dim, lo + n, hi)
        from_dn, from_up = self.exchange(ghost_up, ghost_dn, "halo_fold")
        out = own.clone()
        if from_dn is not None and hi:
            out.narrow(dim, 0, hi).add_(from_dn)
        if from_up is not None and lo:
            out.narrow(dim, n - lo, lo).add_(from_up)
        return out

    # -- reductions ---------------------------------------------------------
    def _all_reduce(self, x: torch.Tensor, op, kind: str) -> torch.Tensor:
        with self._clock(kind, x):
            h = self._host(x)
            if h is x:
                h = x.clone()
            self.bytes_sent += h.numel() * h.element_size()
            dist.all_reduce(h, op=op)
            return self._back(h, x)

    def allreduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.SUM, "allreduce_sum")

    def allreduce_max(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.MAX, "allreduce_max")

    def allgather_rows(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``x`` (rows of any count, the same trailing
        shape), in rank order."""
        with self._clock("allgather", x):
            return self._allgather_rows(x)

    def _allgather_rows(self, x):
        dev = x.device if self.backend == "nccl" else torch.device("cpu")
        n = torch.tensor([x.shape[0]], dtype=torch.int64, device=dev)
        counts = [torch.zeros_like(n) for _ in range(self.world)]
        dist.all_gather(counts, n)
        counts = [int(c) for c in counts]
        width = max(counts)
        pad = torch.zeros((width,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        pad[: x.shape[0]] = x
        h = self._host(pad)
        outs = [self._empty_like(pad) for _ in range(self.world)]
        dist.all_gather(outs, h)
        self.bytes_sent += (self.world - 1) * h.numel() * h.element_size()
        return [self._back(o, x)[:c] for o, c in zip(outs, counts)]

    def gather_to_root(self, x: torch.Tensor, dim: int = -3):
        """The slabs of ``x`` joined along ``dim`` on rank 0 (None on the
        others): what a writer of the whole grid needs."""
        with self._clock("gather_to_root", x):
            return self._gather_to_root(x, dim)

    def _gather_to_root(self, x, dim):
        h = self._host(x)
        if self.is_root:
            parts = [self._empty_like(x) for _ in range(self.world)]
            dist.gather(h, parts, dst=0)
            return torch.cat([self._back(p, x) for p in parts], dim=dim)
        self.bytes_sent += h.numel() * h.element_size()
        dist.gather(h, None, dst=0)
        return None
