"""Diagnostics: tables, field dumps, moments
(counterpart of ``xpic_tpu/diagnostics/__init__.py``).

``default_diagnostics`` auto-appends Energy (EcsimcorrEnergy under
ecsimcorr), ChargeConservation and MomentumConservation like the reference
(src/interfaces/simulation.cpp:41-56); ``build_diagnostics`` dispatches
the config ``Diagnostics`` section.  The port has FieldView and
DistributionMoment; VelocityDistribution, LogView and the
SimulationBackup section raise ``NotImplementedError`` until they are
ported.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

# Diagnostics of the JAX package the port does not have yet.
NOT_PORTED = ("VelocityDistribution", "LogView")


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

    diags = []
    for info in infos or ():
        name = info.get("diagnostic")
        if name == "FieldView":
            diags.append(FieldView.from_json(simulation, info))
        elif name == "DistributionMoment":
            diags.append(DistributionMoment.from_json(simulation, info))
        elif name in NOT_PORTED:
            raise NotImplementedError(
                f"diagnostic {name!r} is not ported to xpic_tpu_torch yet "
                f"(ROADMAP A7)")
        else:
            raise ValueError(f"unknown diagnostic {name!r}")

    if getattr(simulation.cfg, "backup", None):
        raise NotImplementedError(
            "SimulationBackup is not ported to xpic_tpu_torch yet "
            "(ROADMAP A7)")
    return diags
