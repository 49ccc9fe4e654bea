"""DistributionMoment: particle->grid moment dumps
(counterpart of ``xpic_tpu/diagnostics/distribution_moment.py``).

Reference: src/diagnostics/distribution_moment.cpp — deposits per-particle
moment values as *cell-centered* quantities with a reduced order-1
spline (the diagnostic-local ``Shape``: shr=1, shw=2, spline_of_1st_order
at the half-shifted lattice, distribution_moment.cpp:125-155), weighted
by n/Np, then dumps float32 binaries in the FieldView layout under
``<out_dir>/<particles>/<moment><suffix>``.  In a run over a z mesh the
slabs' deposits are gathered to rank 0, which writes the whole grid's
file; a region's box is deposited by every rank from the particles of
its own cells, and the boxes are summed over the ranks before rank 0
writes the region's file.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import PERIODIC, Geometry, parse_value
from ..ops.gather_scatter import cell_t, deposit_scalar
from .field_view import format_time
from ..parallel.mesh import mesh_of, nz_global_of, z0_of

MOMENT_DOF = {
    "density": 1,
    "current": 3,
    "momentum_flux": 6,
    "momentum_flux_cyl": 6,
    "momentum_flux_diag": 3,
    "momentum_flux_diag_cyl": 3,
}

_PAIRS = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]


def _moment_values(name, params, r, p, Lx, Ly):
    """Per-slot moment component values [G, K, dof]
    (reference: distribution_moment.cpp:212-313)."""
    if name == "density":
        return torch.ones(p.shape[:-1] + (1,), dtype=p.dtype, device=p.device)
    if name == "current":
        return params.q * p
    m = params.m
    if name == "momentum_flux":
        return torch.stack([m * p[..., a] * p[..., b] for a, b in _PAIRS],
                           dim=-1)
    if name == "momentum_flux_diag":
        return m * p * p
    # Cylindrical variants use the (r, phi, z) projection around the box axis.
    x = r[..., 0] - 0.5 * Lx
    y = r[..., 1] - 0.5 * Ly
    rr = torch.hypot(x, y)
    safe = rr > 0
    zero = torch.zeros_like(rr)
    inv = torch.where(safe, 1.0 / torch.where(safe, rr, torch.ones_like(rr)),
                      zero)
    vr = torch.where(safe, (x * p[..., 0] + y * p[..., 1]) * inv, p[..., 0])
    va = torch.where(safe, (-y * p[..., 0] + x * p[..., 1]) * inv, p[..., 1])
    vz = p[..., 2]
    v = torch.stack([vr, va, vz], dim=-1)
    if name == "momentum_flux_cyl":
        return torch.stack([m * v[..., a] * v[..., b] for a, b in _PAIRS],
                           dim=-1)
    if name == "momentum_flux_diag_cyl":
        return m * v * v
    raise ValueError(f"unknown moment {name!r}")


class DistributionMoment:
    region: tuple | None = None

    def __init__(self, simulation, species, moment: str, out_dir: str):
        self.simulation = simulation
        self.species = species
        self.moment = moment
        self.dof = MOMENT_DOF[moment]
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self._rows = None  # region-local deposit tables, built lazily

    @classmethod
    def from_json(cls, simulation, info):
        sp = simulation.get_named_particles(info["particles"])
        moment = info["moment"]
        if moment not in MOMENT_DOF:
            raise ValueError(f"unknown moment name {moment!r}")
        suffix = ""
        region = None
        if "region" in info:
            reg = info["region"]
            if "suffix" in reg:
                suffix = "_" + reg["suffix"]
            g = simulation.geom
            units = simulation.cfg.unit_table()
            steps = (g.dx, g.dy, g.dz)
            start = [0, 0, 0]
            size = [g.nx, g.ny, nz_global_of(g)]
            if "start" in reg:
                start = [int(parse_value(reg["start"][i], units) // steps[i])
                         for i in range(3)]
            if "size" in reg:
                size = [int(parse_value(reg["size"][i], units) // steps[i])
                        for i in range(3)]
            region = (tuple(start), tuple(size))
        out = os.path.join(
            simulation.cfg.out_dir, sp.params.sort_name, moment + suffix
        )
        obj = cls(simulation, sp, moment, out)
        obj.region = region
        return obj

    def _region_rows(self, device):
        """Region-local deposit (the reference's reduced-dof DA,
        distribution_moment.cpp:125-155): the cell rows intersecting the
        region dilated by the deposit's 1-cell spline halo, wrapped on
        periodic axes and masked dead outside the domain on the others,
        deposited into a +2-padded sub-box whose windows never wrap.  On a
        z slab the rows of planes outside the slab are masked dead.
        Returns ``(rows, halo_ok, sub_geom)``."""
        geom = self.simulation.geom
        (sx, sy, sz), (rx, ry, rz) = self.region
        zs = np.arange(sz - 1, sz + rz + 1)
        ys = np.arange(sy - 1, sy + ry + 1)
        xs = np.arange(sx - 1, sx + rx + 1)
        halo_ok = np.ones((len(zs), len(ys), len(xs)), bool)
        nz = nz_global_of(geom)
        for ax, idx in ((0, xs), (1, ys), (2, zs)):
            n = (geom.nx, geom.ny, nz)[ax]
            if geom.bounds[ax] != PERIODIC:
                in_dom = (idx >= 0) & (idx < n)
                shape = [1, 1, 1]
                shape[2 - ax] = len(idx)
                halo_ok &= in_dom.reshape(shape)
        zs, ys, xs = zs % nz - z0_of(geom), ys % geom.ny, xs % geom.nx
        mine = (zs >= 0) & (zs < geom.nz)
        halo_ok &= mine[:, None, None]
        zs = np.clip(zs, 0, geom.nz - 1)
        rows = ((zs[:, None, None] * geom.ny + ys[None, :, None])
                * geom.nx + xs[None, None, :]).reshape(-1)
        sub_geom = Geometry(dx=geom.dx, dy=geom.dy, dz=geom.dz, dt=geom.dt,
                            nx=rx + 2, ny=ry + 2, nz=rz + 2, nt=1)
        return (torch.as_tensor(rows, device=device),
                torch.as_tensor(halo_ok.reshape(-1), device=device),
                sub_geom)

    def collect(self, st):
        """The moment deposit of a binned state: [nz', ny', nx', dof]."""
        geom = self.simulation.geom
        params = self.species.params
        t = cell_t(geom, st.r)
        d = torch.tensor(geom.cell_steps, dtype=st.r.dtype,
                         device=st.r.device)
        vals = _moment_values(self.moment, params, st.r * d, st.p, geom.Lx,
                              geom.Ly)
        valid = st.valid
        sub_geom = geom
        if self.region is not None:
            if self._rows is None:
                self._rows = self._region_rows(st.r.device)
            rows, halo_ok, sub_geom = self._rows
            t, vals = t[rows], vals[rows]
            valid = valid[rows] & halo_ok[:, None]
        outs = [deposit_scalar(vals[..., j] * params.n_Np, t, valid,
                               sub_geom, order=1, width=3, anchor=-1,
                               stag=True)
                for j in range(vals.shape[-1])]
        out = torch.stack(outs, dim=-1)
        if self.region is not None:
            out = out[1:-1, 1:-1, 1:-1, :]
        return out

    def diagnose(self, t: int) -> None:
        sim = self.simulation
        if t % sim.geom.diagnose_period != 0:
            return
        data = self.collect(sim.binned(self.species))
        mesh = mesh_of(sim.geom)
        if mesh is not None:
            if self.region is None:
                data = mesh.gather_to_root(data, dim=0)
            else:
                data = mesh.allreduce_sum(data)
            if not mesh.is_root:
                return
        data = data.to(torch.float32).cpu().numpy()
        from .io import binary_dump

        binary_dump(os.path.join(self.out_dir, format_time(t, sim.geom.nt)),
                    np.ascontiguousarray(data))

    def finalize(self) -> None:
        from .io import flush_dumps

        flush_dumps()
