"""Diagnostics: tables, field dumps, moments, backup
(counterpart of ``xpic_tpu/diagnostics/__init__.py``).

``default_diagnostics`` auto-appends Energy (EcsimcorrEnergy under
ecsimcorr), ChargeConservation and MomentumConservation like the reference
(src/interfaces/simulation.cpp:41-56); ``build_diagnostics`` dispatches
the config ``Diagnostics`` section
(src/diagnostics/builders/diagnostic_builder.cpp:17-59) and appends the
``SimulationBackup`` section's checkpointer.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence


def default_diagnostics(simulation) -> list:
    from .charge_conservation import ChargeConservation
    from .energy import EcsimcorrEnergy, Energy
    from .momentum_conservation import MomentumConservation

    energy = (EcsimcorrEnergy if simulation.scheme_name == "ecsimcorr"
              else Energy)
    return [energy(simulation), ChargeConservation(simulation),
            MomentumConservation(simulation)]


def build_diagnostics(simulation, infos: Sequence[Mapping[str, Any]]) -> list:
    from .distribution_moment import DistributionMoment
    from .field_view import FieldView
    from .log_view import LogView
    from .velocity_distribution import VelocityDistribution

    table = {
        "FieldView": FieldView,
        "DistributionMoment": DistributionMoment,
        "VelocityDistribution": VelocityDistribution,
        "LogView": LogView,
    }
    diags = []
    for info in infos or ():
        name = info.get("diagnostic")
        if name not in table:
            raise ValueError(f"unknown diagnostic {name!r}")
        diags.append(table[name].from_json(simulation, info))

    backup = getattr(simulation.cfg, "backup", None)
    if backup:
        from .simulation_backup import SimulationBackup

        diags.append(SimulationBackup.from_json(simulation, backup))
    return diags
