"""SetParticles preset (counterpart of
``xpic_tpu/commands/set_particles.py``).

The particles are drawn on the host with numpy (``particles_load``), so
the same seed gives the same particles as the JAX package, and appended
to the species on its device.  On a z slab every rank draws the whole
stream and keeps the particles of its slab (``particles.in_slab``), so
the ranks together hold the one-rank load, bit for bit.
"""

from __future__ import annotations

import logging
import os

from .. import particles as P
from ..particles import kinetic_energy
from .particles_load import build_coordinate, build_momentum
from ..parallel.mesh import mesh_of

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
        n_all = coords.shape[0]
        geom = self.species.geom
        if mesh_of(geom) is not None:
            keep = P.in_slab(coords, geom, self.species.arrays.r.dtype)
            coords, moms = coords[keep], moms[keep]
        before = kinetic_energy(self.species.arrays, self.species.params)
        self.species.arrays = P.append(self.species.arrays, coords, moms)
        self.species.n += n_all
        added = kinetic_energy(self.species.arrays, self.species.params) \
            - before
        if mesh_of(geom) is not None:
            added = mesh_of(geom).allreduce_sum(added)
        self.added_energy = float(added)
        log.info(
            "  Added %d particles into %r (energy %.4e)",
            self.n, self.species.params.sort_name, self.added_energy,
        )
