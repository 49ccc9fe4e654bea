"""Commands: one-shot Presets and per-step StepPresets
(counterpart of ``xpic_tpu/commands/__init__.py``).

Dispatch mirrors ``build_commands``
(src/commands/builders/command_builder.cpp:16-62).
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence


def build_commands(simulation, infos: Sequence[Mapping[str, Any]]) -> list:
    from .fields_damping import FieldsDamping
    from .inject_particles import InjectParticles
    from .remove_particles import RemoveParticles
    from .set_magnetic_field import SetMagneticField
    from .set_particles import SetParticles

    table = {
        "SetParticles": SetParticles,
        "InjectParticles": InjectParticles,
        "RemoveParticles": RemoveParticles,
        "SetMagneticField": SetMagneticField,
        "FieldsDamping": FieldsDamping,
    }
    commands = []
    for info in infos or ():
        name = info.get("command")
        if name is None:
            raise ValueError(f"command entry without 'command' key: {info}")
        if name not in table:
            raise ValueError(f"unknown command {name!r}")
        commands.append(table[name].from_json(simulation, info))
    return commands
