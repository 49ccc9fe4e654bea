"""FieldsDamping step preset: absorbing-layer damping
(counterpart of ``xpic_tpu/commands/fields_damping.py``).

Reference: src/commands/fields_damping.cpp.  The damping profile is
evaluated once on the (cell-centered) grid with numpy and applied on the
simulation's device as an elementwise multiply on E and on (B - B0); the
absorbed energy is tracked for the energy-conservation table (used at
src/diagnostics/energy.cpp:166-170), one host read a step.  On a z slab
the profile is evaluated at the slab's global planes against the whole
grid's extent, and the absorbed energy is summed over the ranks.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..config import parse_value
from ..parallel.mesh import mesh_of, nz_global_of, z0_of
from .particles_load import load_box, load_cylinder

log = logging.getLogger("xpic")


def _cell_centers(geom):
    """The cell centres of the grid (of a slab: its planes, at their
    global z)."""
    x = (np.arange(geom.nx) + 0.5) * geom.dx
    y = (np.arange(geom.ny) + 0.5) * geom.dy
    z = (np.arange(geom.nz) + z0_of(geom) + 0.5) * geom.dz
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    return X, Y, Z


def damp_for_box(geom, box, coefficient):
    """DampForBox profile (fields_damping.cpp:78-101)."""
    X, Y, Z = _cell_centers(geom)
    L = (geom.Lx, geom.Ly, nz_global_of(geom) * geom.dz)
    damping = np.ones_like(X)
    inside = np.ones_like(X, dtype=bool)
    for g, lo, hi, Lg in ((X, box.min[0], box.max[0], L[0]),
                          (Y, box.min[1], box.max[1], L[1]),
                          (Z, box.min[2], box.max[2], L[2])):
        above = g > hi
        below = g < lo
        inside &= ~(above | below)
        width_hi = max(Lg - hi, 1e-300)
        width_lo = max(lo, 1e-300)
        d_hi = 1.0 - coefficient * ((g - hi) / width_hi - 1.0) ** 2
        d_lo = 1.0 - coefficient * ((g - lo) / width_lo - 1.0) ** 2
        damping *= np.where(above, d_hi, np.where(below, d_lo, 1.0))
    return np.where(inside, 1.0, damping), inside


def damp_for_cylinder(geom, cyl, coefficient):
    """DampForCylinder profile (fields_damping.cpp:104-122)."""
    X, Y, Z = _cell_centers(geom)
    r = np.hypot(X - cyl.center[0], Y - cyl.center[1])
    inside = r < cyl.radius
    width = max(cyl.center[0] - cyl.radius, 1e-300)
    delta = r - cyl.radius
    delta0 = width * (1.0 + 1.0 / np.sqrt(coefficient))
    damping = np.where(
        delta < delta0, 1.0 - coefficient * (delta / width - 1.0) ** 2, 0.0
    )
    return np.where(inside, 1.0, damping), inside


def _apply(E, B, B0, factor):
    """Damped (E, B) and the energy removed, sum 0.5 F^2 (1 - d^2) over
    the grid (a 0-d tensor)."""
    Bi = B - B0
    removed = 0.5 * torch.sum((E * E + Bi * Bi) * (1.0 - factor * factor))
    return E * factor, Bi * factor + B0, removed


class FieldsDamping:
    def __init__(self, simulation, factor):
        self.simulation = simulation
        self.factor = torch.as_tensor(
            factor, dtype=simulation.dtype,
            device=simulation.device)[None, :, :, :]
        self.damped_energy = 0.0

    @classmethod
    def from_json(cls, simulation, info):
        units = simulation.cfg.unit_table()
        geom_info = info["geometry"]
        coefficient = parse_value(geom_info.get("coefficient", 0.8), units)
        name = geom_info["name"]
        if name == "BoxGeometry":
            factor, _ = damp_for_box(
                simulation.geom, load_box(geom_info, units), coefficient
            )
        elif name == "CylinderGeometry":
            factor, _ = damp_for_cylinder(
                simulation.geom, load_cylinder(geom_info, units), coefficient
            )
        else:
            raise ValueError(f"unknown damping geometry {name!r}")
        log.info("  FieldsDamping is added (%s)", name)
        return cls(simulation, factor)

    def get_damped_energy(self) -> float:
        return self.damped_energy

    def execute(self, t: int) -> None:
        sim = self.simulation
        sim.E, sim.B, removed = _apply(sim.E, sim.B, sim.B0, self.factor)
        if mesh_of(sim.geom) is not None:
            removed = mesh_of(sim.geom).allreduce_sum(removed)
        self.damped_energy = float(removed)
