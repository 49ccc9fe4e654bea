"""FieldView: periodic float32 binary dumps of a field region
(counterpart of ``xpic_tpu/diagnostics/field_view.py``).

Reference: src/diagnostics/field_view.cpp + src/utils/mpi_binary_file.h.
File layout contract (consumed by tools/plotting/lib/data_format.py:34-56):
C-ordered (z, y, x, dof) float32, one file per dump named by the
zero-padded timestep (width = digits of nt), under
``<out_dir>/<field><suffix>/``.  In a run over a z mesh the slabs are
gathered to rank 0, which writes the whole grid's file.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..config import parse_value
from ..convert import to_numpy
from ..parallel.mesh import mesh_of


@dataclasses.dataclass
class Region:
    start: tuple[int, int, int, int]  # (x, y, z, dof)
    size: tuple[int, int, int, int]


def format_time(t: int, nt: int) -> str:
    width = len(str(nt))
    return f"{t:0{width}d}"


class FieldView:
    def __init__(self, simulation, field_name: str, region: Region, out_dir: str):
        self.simulation = simulation
        self.field_name = field_name
        self.region = region
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)

    @classmethod
    def from_json(cls, simulation, info):
        g = simulation.cfg.geometry
        units = simulation.cfg.unit_table()
        start = [0, 0, 0, 0]
        size = [g.nx, g.ny, g.nz, 3]
        suffix = ""
        if "region" in info:
            reg = info["region"]
            suffix = reg.get("suffix", "")
            steps = (g.dx, g.dy, g.dz)
            if "start" in reg:
                s = reg["start"]
                for i in range(3):
                    start[i] = int(parse_value(s[i], units) // steps[i])
            if "size" in reg:
                s = reg["size"]
                for i in range(3):
                    size[i] = int(parse_value(s[i], units) // steps[i])
        if suffix:
            suffix = "_" + suffix
        out = os.path.join(simulation.cfg.out_dir, info["field"] + suffix)
        return cls(simulation, info["field"], Region(tuple(start), tuple(size)), out)

    def diagnose(self, t: int) -> None:
        sim = self.simulation
        if t % sim.geom.diagnose_period != 0:
            return
        F = sim.get_named_field(self.field_name)  # [3, nz, ny, nx]
        if mesh_of(sim.geom) is not None:
            F = mesh_of(sim.geom).gather_to_root(F)
            if F is None:
                return
        F = to_numpy(F)
        sx, sy, sz, sc = self.region.start
        nx, ny, nz, nc = self.region.size
        sub = F[sc : sc + nc, sz : sz + nz, sy : sy + ny, sx : sx + nx]
        data = np.ascontiguousarray(np.moveaxis(sub, 0, -1), dtype=np.float32)
        path = os.path.join(self.out_dir, format_time(t, sim.geom.nt))
        from .io import binary_dump

        binary_dump(path, data)

    def finalize(self) -> None:
        from .io import flush_dumps

        flush_dumps()
