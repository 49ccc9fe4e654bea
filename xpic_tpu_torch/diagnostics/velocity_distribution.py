"""VelocityDistribution: 2-D velocity-space histograms of a spatial region
(counterpart of ``xpic_tpu/diagnostics/velocity_distribution.py``).

Reference: src/diagnostics/velocity_distribution.cpp — particles inside a
spatial region are binned on a (v1, v2) plane chosen by a projector
(vx_vy, vz_vxy, vr_vphi; velocity_distribution.cpp:195-201), weighted by
n/Np; dumps are float32 binaries in FieldView naming.

The histogram is formed without atomics, so that two calls on the card
write the same bytes: the flat bin ids are sorted (stably), each run of
equal ids is one bin's particles, and its sum is written to its bin.
Every particle carries the same weight n/Np, so a run's sum is its
length times the weight.  On a z slab each rank bins its own particles,
the bins' counts are summed over the ranks, and rank 0 writes: the
one-rank histogram, bit for bit.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import parse_value, parse_vector
from ..parallel.mesh import mesh_of
from .field_view import format_time


def _project(name, r, p, Lx, Ly):
    if name == "vx_vy":
        return p[:, 0], p[:, 1]
    if name == "vz_vxy":
        return p[:, 2], torch.hypot(p[:, 0], p[:, 1])
    if name == "vr_vphi":
        x = r[:, 0] - 0.5 * Lx
        y = r[:, 1] - 0.5 * Ly
        rr = torch.clamp(torch.hypot(x, y), min=1e-300)
        vr = (x * p[:, 0] + y * p[:, 1]) / rr
        vphi = (-y * p[:, 0] + x * p[:, 1]) / rr
        return vr, vphi
    raise ValueError(f"unknown velocity projector {name!r}")


def bin_counts(flat, n_bins: int):
    """The count [n_bins] (int64) of each id of ``flat`` (ids >= n_bins
    are dropped): a stable sort, the runs of equal ids, one write a bin."""
    ids, _ = torch.sort(flat, stable=True)
    bins, counts = torch.unique_consecutive(ids, return_counts=True)
    out = torch.zeros(n_bins + 1, dtype=torch.int64, device=flat.device)
    out[bins] = counts
    return out[:-1]


class VelocityDistribution:
    def __init__(self, simulation, species, projector, vmin, vmax, dv,
                 rmin, rmax, out_dir):
        self.simulation = simulation
        self.species = species
        self.projector = projector
        self.vmin = np.asarray(vmin, dtype=float)
        self.dv = np.asarray(dv, dtype=float)
        self.nv = tuple(
            max(1, int(round((vmax[i] - vmin[i]) / dv[i]))) for i in range(2)
        )
        self.rmin = np.asarray(rmin, dtype=float)
        self.rmax = np.asarray(rmax, dtype=float)
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)

    @classmethod
    def from_json(cls, simulation, info):
        units = simulation.cfg.unit_table()
        sp = simulation.get_named_particles(info["particles"])
        projector = info.get("projection", "vx_vy")
        vmin = (-1.0, -1.0)
        vmax = (+1.0, +1.0)
        dv = (0.01, 0.01)
        if "vmin" in info:
            vmin = tuple(parse_value(v, units) for v in info["vmin"])[:2]
        if "vmax" in info:
            vmax = tuple(parse_value(v, units) for v in info["vmax"])[:2]
        if "dv" in info:
            dv = tuple(parse_value(v, units) for v in info["dv"])[:2]
        rmin = (0.0, 0.0, 0.0)
        rmax = (units["geom_x"], units["geom_y"], units["geom_z"])
        if "region" in info:
            reg = info["region"]
            if "start" in reg:
                rmin = parse_vector(reg["start"], units)
            if "size" in reg:
                size = parse_vector(reg["size"], units)
                rmax = tuple(rmin[i] + size[i] for i in range(3))
        out = os.path.join(
            simulation.cfg.out_dir, sp.params.sort_name, projector
        )
        return cls(simulation, sp, projector, vmin, vmax, dv, rmin, rmax, out)

    def collect(self, arrays):
        """The histogram [nv2, nv1] of a flat species view."""
        counts = self.counts(arrays)
        return (counts.to(arrays.r.dtype)
                * self.species.params.n_Np).reshape(self.nv[1], self.nv[0])

    def counts(self, arrays):
        """The bins' particle counts [nv2 * nv1] of a flat species view."""
        geom = self.simulation.geom
        nv1, nv2 = self.nv
        r, p, alive = arrays.r, arrays.p, arrays.alive
        rmin, rmax = self.rmin.tolist(), self.rmax.tolist()
        vmin = self.vmin.tolist()
        # The bin widths as a tensor on the device: PyTorch's CUDA
        # division by a host scalar multiplies by its reciprocal, which
        # puts a velocity on a bin edge in another bin than the CPU's
        # correctly rounded quotient does.
        dv = torch.tensor(self.dv, dtype=r.dtype, device=r.device)
        inside = alive
        for i in range(3):
            inside = inside & (r[:, i] >= rmin[i]) & (r[:, i] <= rmax[i])
        v1, v2 = _project(self.projector, r, p, geom.Lx, geom.Ly)
        i1 = torch.floor((v1 - vmin[0]) / dv[0]).to(torch.int64)
        i2 = torch.floor((v2 - vmin[1]) / dv[1]).to(torch.int64)
        ok = inside & (i1 >= 0) & (i1 < nv1) & (i2 >= 0) & (i2 < nv2)
        flat = torch.where(ok, i2 * nv1 + i1,
                           torch.full_like(i1, nv1 * nv2))
        return bin_counts(flat, nv1 * nv2)

    def diagnose(self, t: int) -> None:
        sim = self.simulation
        if t % sim.geom.diagnose_period != 0:
            return
        arrays = self.species.arrays
        counts = self.counts(arrays)
        mesh = mesh_of(sim.geom)
        if mesh is not None:
            counts = mesh.allreduce_sum(counts)
            if not mesh.is_root:
                return
        hist = (counts.to(arrays.r.dtype) * self.species.params.n_Np
                ).reshape(self.nv[1], self.nv[0])
        from .io import binary_dump

        binary_dump(
            os.path.join(self.out_dir, format_time(t, sim.geom.nt)),
            hist.cpu().numpy().astype(np.float32),
        )

    def finalize(self) -> None:
        from .io import flush_dumps

        flush_dumps()
