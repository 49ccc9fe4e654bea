"""SetParticles preset (counterpart of
``xpic_tpu/commands/set_particles.py``).

The particles are drawn on the host with numpy (``particles_load``), so
the same seed gives the same particles as the JAX package, and appended
to the species on its device.
"""

from __future__ import annotations

import logging
import os

from .. import particles as P
from ..particles import kinetic_energy
from .particles_load import build_coordinate, build_momentum

log = logging.getLogger("xpic")


class SetParticles:
    def __init__(self, species, number_of_particles, generate_coordinate,
                 generate_momentum):
        self.species = species
        self.n = number_of_particles
        self.gen_coordinate = generate_coordinate
        self.gen_momentum = generate_momentum
        self.added_energy = 0.0

    @classmethod
    def from_json(cls, simulation, info):
        sp = simulation.get_named_particles(info["particles"])
        units = simulation.cfg.unit_table()
        gen_c, n = build_coordinate(info["coordinate"], sp.params, units)
        gen_m = build_momentum(info["momentum"], sp.params, units)
        log.info("  SetParticles command is added for %r", sp.params.sort_name)
        return cls(sp, n, gen_c, gen_m)

    def execute(self, t: int) -> None:
        if os.environ.get("XPIC_RNG") == "reference":
            from .particles_load import generate_interleaved

            coords, moms = generate_interleaved(
                self.gen_coordinate, self.gen_momentum, self.n,
                sin_first=os.environ.get("XPIC_RNG_ORDER", "sin") == "sin",
            )
        else:
            coords = self.gen_coordinate(self.n)
            moms = self.gen_momentum(coords)
        before = kinetic_energy(self.species.arrays, self.species.params)
        self.species.arrays = P.append(self.species.arrays, coords, moms)
        self.species.n += coords.shape[0]
        after = kinetic_energy(self.species.arrays, self.species.params)
        self.added_energy = float(after - before)
        log.info(
            "  Added %d particles into %r (energy %.4e)",
            self.n, self.species.params.sort_name, self.added_energy,
        )
