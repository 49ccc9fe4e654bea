"""LogView: per-phase wall-clock timing tables
(counterpart of ``xpic_tpu/diagnostics/log_view.py``).

Reference: src/diagnostics/log_view.{h,cpp} converts PETSc log-handler
state into per-timestep / period-averaged / cumulative tables.  Here the
host driver records phase timings (``Simulation.timings`` plus the
scheme's ``phase_timings``, where it has them) and this diagnostic
writes them in the same three levels: ``EachTimestep``,
``DiagnosePeriodAvg``, ``AllTimestepsSummary``.  The times are host
clocks around work the card may not have finished.
"""

from __future__ import annotations

import os

from .tables import TableDiagnostic


class LogView:
    LEVELS = ("EachTimestep", "DiagnosePeriodAvg", "AllTimestepsSummary")

    def __init__(self, simulation, level: str):
        if level not in self.LEVELS:
            raise ValueError(f"unknown LogView level {level!r}")
        self.simulation = simulation
        self.level = level
        self.table = TableDiagnostic(
            os.path.join(simulation.cfg.out_dir, "temporal",
                         f"log_{level}.txt")
        )
        self.accum: dict[str, float] = {}
        self.steps = 0

    @classmethod
    def from_json(cls, simulation, info):
        return cls(simulation, info.get("level", "EachTimestep"))

    def _timings(self) -> dict[str, float]:
        t = dict(self.simulation.timings)
        t.update(getattr(self.simulation, "phase_timings", {}))
        return t

    def diagnose(self, t: int) -> None:
        timings = self._timings()
        if not timings:
            return
        self.steps += 1
        for k, v in timings.items():
            self.accum[k] = self.accum.get(k, 0.0) + v

        period = self.simulation.geom.diagnose_period
        tb = self.table
        if self.level == "EachTimestep":
            tb.add(6, "Time", t, "{:d}")
            total = sum(timings.values()) or 1.0
            for k, v in timings.items():
                tb.add(13, k, v)
                tb.add(9, k + "_%", 100.0 * v / total, "{:.2f}")
            tb.commit(t, period)
        elif self.level == "DiagnosePeriodAvg" and t and t % period == 0:
            tb.add(6, "Time", t, "{:d}")
            for k, v in self.accum.items():
                tb.add(13, k + "_avg", v / max(self.steps, 1))
            tb.commit(t, period)
            self.accum.clear()
            self.steps = 0

    def finalize(self) -> None:
        if self.level == "AllTimestepsSummary" and self.accum:
            tb = self.table
            tb.add(6, "Steps", self.steps, "{:d}")
            total = sum(self.accum.values()) or 1.0
            for k, v in self.accum.items():
                tb.add(13, k + "_sum", v)
                tb.add(9, k + "_%", 100.0 * v / total, "{:.2f}")
            tb.commit(0, 1)
        self.table.finalize()
