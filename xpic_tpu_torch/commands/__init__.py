"""Commands: one-shot Presets and per-step StepPresets
(counterpart of ``xpic_tpu/commands/__init__.py``).

The port has SetParticles and SetMagneticField; the other commands of
the JAX package raise ``NotImplementedError`` until they are ported.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

# Commands of the JAX package the port does not have yet.
NOT_PORTED = ("InjectParticles", "RemoveParticles", "FieldsDamping")


def build_commands(simulation, infos: Sequence[Mapping[str, Any]]) -> list:
    from .set_magnetic_field import SetMagneticField
    from .set_particles import SetParticles

    table = {
        "SetParticles": SetParticles,
        "SetMagneticField": SetMagneticField,
    }
    commands = []
    for info in infos or ():
        name = info.get("command")
        if name is None:
            raise ValueError(f"command entry without 'command' key: {info}")
        if name in NOT_PORTED:
            raise NotImplementedError(
                f"command {name!r} is not ported to xpic_tpu_torch yet "
                f"(ROADMAP A7)")
        if name not in table:
            raise ValueError(f"unknown command {name!r}")
        commands.append(table[name].from_json(simulation, info))
    return commands
