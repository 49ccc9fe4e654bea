"""InjectParticles step preset: paired ionized/ejected injection
(counterpart of ``xpic_tpu/commands/inject_particles.py``).

Reference: src/commands/inject_particles.cpp — each step within
[injection_start, injection_end] injects ``per_step_particles_num``
coordinate-shared pairs into two species, tracking the added kinetic
energy for the energy-conservation table.  The particles are drawn on
the host by ``particles_load`` (the JAX package's particles for the same
seed) and appended to each species on its device.  On a z slab every
rank draws the whole stream, so the ranks' generators stay in step and
the injected energies are the whole draw's, and each rank keeps the
particles whose cell lies in its slab (``particles.in_slab``).
"""

from __future__ import annotations

import logging

import numpy as np

from .. import particles as P
from ..config import parse_value
from ..parallel.mesh import mesh_of
from .particles_load import build_coordinate, build_momentum

log = logging.getLogger("xpic")


class InjectParticles:
    def __init__(self, ionized, ejected, start, end, per_step, gen_coordinate,
                 gen_momentum_i, gen_momentum_e):
        self.ionized = ionized
        self.ejected = ejected
        self.start = start
        self.end = end
        self.per_step = per_step
        self.gen_coordinate = gen_coordinate
        self.gen_momentum_i = gen_momentum_i
        self.gen_momentum_e = gen_momentum_e
        self.energy_i = 0.0
        self.energy_e = 0.0

    @classmethod
    def from_json(cls, simulation, info):
        units = simulation.cfg.unit_table()
        ionized = simulation.get_named_particles(info["ionized"])
        ejected = simulation.get_named_particles(info["ejected"])
        gen_c, n_inj = build_coordinate(info["coordinate"], ionized.params,
                                        units)
        gen_mi = build_momentum(info["momentum_i"], ionized.params, units)
        gen_me = build_momentum(info["momentum_e"], ejected.params, units)

        dt = units["dt"]
        start = int(round(parse_value(info.get("injection_start", 0), units)
                          / dt))
        end_default = simulation.geom.nt * dt
        end = int(round(parse_value(info.get("injection_end", end_default),
                                    units) / dt))

        tau = parse_value(info.get("tau", dt), units)
        per_step = info.get("per_step_particles_num")
        if per_step is None:
            # Spread n_inj particles over tau (particles per step =
            # round(coordinate-count * dt / tau)).
            per_step = max(1, int(round(n_inj * dt / tau)))
        log.info(
            "  InjectParticles is added for %r + %r (%d..%d, %d/step)",
            ionized.params.sort_name, ejected.params.sort_name, start, end,
            per_step,
        )
        return cls(ionized, ejected, start, end, per_step, gen_c, gen_mi,
                   gen_me)

    def get_ionized_name(self):
        return self.ionized.params.sort_name

    def get_ejected_name(self):
        return self.ejected.params.sort_name

    def get_ionized_energy(self):
        return self.energy_i

    def get_ejected_energy(self):
        return self.energy_e

    def execute(self, t: int) -> None:
        self.energy_i = 0.0
        self.energy_e = 0.0
        if t < self.start or t > self.end:
            return
        coords = self.gen_coordinate(self.per_step)
        pi = self.gen_momentum_i(coords)
        pe = self.gen_momentum_e(coords)

        def kinetic(params, p):
            return float(0.5 * params.m * params.n_Np * np.sum(p**2))

        self.energy_i = kinetic(self.ionized.params, pi)
        self.energy_e = kinetic(self.ejected.params, pe)
        n = coords.shape[0]
        geom = self.ionized.geom
        if mesh_of(geom) is not None:
            keep = P.in_slab(coords, geom, self.ionized.arrays.r.dtype)
            coords, pi, pe = coords[keep], pi[keep], pe[keep]
        self.ionized.arrays = P.append(self.ionized.arrays, coords, pi)
        self.ejected.arrays = P.append(self.ejected.arrays, coords, pe)
        self.ionized.n += n
        self.ejected.n += n
