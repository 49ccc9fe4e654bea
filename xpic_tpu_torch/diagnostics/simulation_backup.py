"""SimulationBackup: checkpoint/restore with the reference's file contract
(counterpart of ``xpic_tpu/diagnostics/simulation_backup.py``, in the
same on-disk format: either package loads the other's backups).

Reference: src/diagnostics/simulation_backup.cpp.  Every
``diagnose_period`` steps, into ``<out>/simulation_backup/<t>/``:

* each field (E, B, B0) as a PetscViewer-binary-compatible file —
  big-endian: int32 classid 1211214 ("VEC"), int32 length, then the
  raw float64 values in (z, y, x, dof) order;
* each species as raw (x,y,z,px,py,pz) float64 records plus a
  ``.numparts`` sidecar holding the count (big-endian int32);
* a copy of the ``temporal/`` table directory.

A rolling window of ``num_periods_being_kept = 2`` checkpoints is kept
(simulation_backup.cpp:38-46).  Loading places the fields on the
simulation's device in its dtype and re-inserts the particles through
the normal flat -> binned path (the analog of re-adding through
``add_particle``, simulation_backup.cpp:132-158).
"""

from __future__ import annotations

import logging
import os
import shutil
import struct

import numpy as np
import torch

from ..config import parse_value, round_step
from ..convert import to_numpy
from ..particles import from_numpy

log = logging.getLogger("xpic")

VEC_FILE_CLASSID = 1211214
NUM_PERIODS_KEPT = 2


def write_vec(path: str, data: np.ndarray) -> None:
    """PetscViewer binary Vec format: >i4 classid, >i4 n, then >f8 values."""
    flat = np.asarray(data, dtype=np.float64).reshape(-1)
    with open(path, "wb") as fh:
        fh.write(struct.pack(">ii", VEC_FILE_CLASSID, flat.size))
        flat.astype(">f8").tofile(fh)


def read_vec(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        classid, n = struct.unpack(">ii", fh.read(8))
        if classid != VEC_FILE_CLASSID:
            raise ValueError(f"{path}: not a Vec binary file")
        return np.fromfile(fh, dtype=">f8", count=n).astype(np.float64)


class SimulationBackup:
    def __init__(self, simulation, period: int):
        self.simulation = simulation
        self.period = max(1, period)
        self.out_dir = os.path.join(simulation.cfg.out_dir,
                                    "simulation_backup")
        os.makedirs(self.out_dir, exist_ok=True)

    @classmethod
    def from_json(cls, simulation, info):
        units = simulation.cfg.unit_table()
        period = round_step(
            parse_value(info.get("diagnose_period", units["dt"]), units),
            units["dt"],
        )
        backup = cls(simulation, period)
        if info.get("save_sources"):
            backup.save_sources()
        load_from = info.get("load_from")
        if isinstance(load_from, int):
            backup.load(load_from)
            simulation.start = load_from
        return backup

    def save_sources(self) -> None:
        """Copy the package's source tree into ``<backup>/src`` for
        provenance (Configuration::save_sources,
        src/utils/configuration.cpp:38-47)."""
        src_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        dst = os.path.join(self.out_dir, "src")
        shutil.copytree(
            src_dir, dst, dirs_exist_ok=True,
            ignore=shutil.ignore_patterns("__pycache__", "*.pyc"),
        )

    # -- save ---------------------------------------------------------
    def _dir(self, t: int) -> str:
        return os.path.join(self.out_dir, str(t))

    def diagnose(self, t: int) -> None:
        if t % self.period != 0:
            return
        self.save(t)
        old = t - NUM_PERIODS_KEPT * self.period
        if old >= 0 and os.path.isdir(self._dir(old)):
            shutil.rmtree(self._dir(old), ignore_errors=True)

    def save(self, t: int) -> None:
        sim = self.simulation
        d = self._dir(t)
        os.makedirs(d, exist_ok=True)

        # Fields in the DMDA natural ordering: (z, y, x, dof) rows.
        for name in ("E", "B", "B0"):
            F = to_numpy(sim.get_named_field(name))  # [3, nz, ny, nx]
            write_vec(os.path.join(d, name), np.moveaxis(F, 0, -1))

        for sp in sim.species:
            arr = sp.arrays
            alive = arr.alive.cpu().numpy()
            r = arr.r.cpu().numpy()[alive]
            p = arr.p.cpu().numpy()[alive]
            rec = np.concatenate([r, p], axis=1)  # [N, 6]
            fname = os.path.join(d, sp.params.sort_name)
            rec.astype(np.float64).tofile(fname)
            with open(fname + ".numparts", "wb") as fh:
                fh.write(struct.pack(">i", rec.shape[0]))

        temporal = os.path.join(sim.cfg.out_dir, "temporal")
        if os.path.isdir(temporal):
            for diag in sim.diagnostics:
                table = getattr(diag, "table", None)
                if table is not None:
                    table._file.flush()
            shutil.copytree(
                temporal, os.path.join(d, "temporal"), dirs_exist_ok=True
            )
        log.info("  Simulation backup saved at t=%d", t)

    # -- load ---------------------------------------------------------
    def load(self, t: int) -> None:
        sim = self.simulation
        d = self._dir(t)
        if not os.path.isdir(d):
            raise RuntimeError(f"no backup directory {d}")

        g = sim.geom
        for name in ("E", "B", "B0"):
            data = read_vec(os.path.join(d, name)).reshape(g.nz, g.ny, g.nx, 3)
            setattr(sim, name, torch.tensor(
                np.moveaxis(data, -1, 0), dtype=sim.dtype, device=sim.device))

        for sp in sim.species:
            fname = os.path.join(d, sp.params.sort_name)
            with open(fname + ".numparts", "rb") as fh:
                (numparts,) = struct.unpack(">i", fh.read(4))
            rec = np.fromfile(fname, dtype=np.float64).reshape(numparts, 6)
            sp.arrays = from_numpy(rec[:, :3], rec[:, 3:], dtype=sim.dtype,
                                   device=sim.device)
            sp.n = numparts
        sim.rebin_all()

        src = os.path.join(d, "temporal")
        if os.path.isdir(src):
            shutil.copytree(
                src, os.path.join(sim.cfg.out_dir, "temporal"),
                dirs_exist_ok=True,
            )
        log.info("  Simulation loaded from backup at t=%d", t)

    def finalize(self) -> None:
        pass
