"""SetMagneticField preset: uniform, coil (Biot-Savart), mirror fields
(counterpart of ``xpic_tpu/commands/set_magnetic_field.py``).

Reference: src/commands/set_magnetic_field.cpp.  The setters compute the
field on the host with numpy, vectorized over the whole grid; the result
is added to the simulation's B0 and B on their device.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from ..config import parse_value, parse_vector
from ..parallel.mesh import z0_of

log = logging.getLogger("xpic")


def _grid_coords(geom, stagger):
    """Node coordinates per component with Yee staggering offsets.

    stagger[axis] == 1 adds half a step (matching the B-component
    positions used at set_magnetic_field.cpp:118-140).
    """
    sx, sy, sz = stagger
    x = (np.arange(geom.nx) + 0.5 * sx) * geom.dx
    y = (np.arange(geom.ny) + 0.5 * sy) * geom.dy
    z = (np.arange(geom.nz) + 0.5 * sz) * geom.dz
    return np.meshgrid(z, y, x, indexing="ij")


class SetUniformField:
    def __init__(self, value):
        self.value = np.asarray(value, dtype=np.float64)

    def __call__(self, geom):
        out = np.zeros((3, geom.nz, geom.ny, geom.nx))
        for c in range(3):
            out[c] = self.value[c]
        log.info("  Uniform magnetic field is set, value %s", self.value)
        return out


class SetCoilsField:
    """Axisymmetric field of circular coils by direct integration
    (set_magnetic_field.cpp:93-190; N=2000 trapezoid points)."""

    N = 2000

    def __init__(self, coils):
        self.coils = coils  # list of (z0, R, I)
        self.cos = np.cos(np.arange(self.N) * (2 * math.pi / self.N))
        self.hp = 2 * math.pi / self.N

    def _integ(self, z, r, R):
        # denom[g, i] = z^2 + R^2 + r^2 - 2 R r cos(phi_i)
        base = (z**2 + R**2 + r**2)[..., None]
        denom = base - (2.0 * R) * r[..., None] * self.cos
        denom = np.maximum(np.abs(denom), 1e-10) * np.sign(
            np.where(denom == 0, 1.0, denom)
        )
        denom = np.where(np.abs(denom) < 1e-10, 1e-10, denom)
        inv32 = 1.0 / (denom * np.sqrt(np.abs(denom)))
        integ_r = np.sum(self.cos * inv32, axis=-1) * self.hp
        integ_z = np.sum((R - r[..., None] * self.cos) * inv32, axis=-1) * self.hp
        return integ_r, integ_z

    def _Br_Bz(self, z, r):
        Br = np.zeros_like(z)
        Bz = np.zeros_like(z)
        for z0, R, I in self.coils:
            zc = z - z0
            ir, iz = self._integ(zc, r, R)
            Br += I * R * zc * ir
            Bz += I * R * iz
        return Br, Bz

    def __call__(self, geom):
        cx, cy = 0.5 * geom.Lx, 0.5 * geom.Ly
        out = np.zeros((3, geom.nz, geom.ny, geom.nx))

        # Bx at (x, y+1/2, z+1/2)
        Z, Y, X = _grid_coords(geom, (0, 1, 1))
        sx, sy, sz = X - cx, Y - cy, Z
        r = np.hypot(sx, sy)
        Br, _ = self._Br_Bz(sz, r)
        out[0] = np.divide(Br * sx, r, out=np.zeros_like(r), where=r > 0)

        # By at (x+1/2, y, z+1/2)
        Z, Y, X = _grid_coords(geom, (1, 0, 1))
        sx, sy, sz = X - cx, Y - cy, Z
        r = np.hypot(sx, sy)
        Br, _ = self._Br_Bz(sz, r)
        out[1] = np.divide(Br * sy, r, out=np.zeros_like(r), where=r > 0)

        # Bz at (x+1/2, y+1/2, z)
        Z, Y, X = _grid_coords(geom, (1, 1, 0))
        sx, sy, sz = X - cx, Y - cy, Z
        r = np.hypot(sx, sy)
        _, Bz = self._Br_Bz(sz, r)
        out[2] = Bz

        log.info("  Coils magnetic field is set")
        return out


class SetApproximateMirrorField:
    """Two-coil mirror approximation (set_magnetic_field.cpp:200-260)."""

    def __init__(self, D, R, I):
        self.D, self.R, self.I = D, R, I

    def _B0(self, z, sign):
        zc = z + 0.5 * sign * self.D
        return 0.5 * self.I * self.R**2 / (self.R**2 + zc**2) ** 1.5

    def _B1(self, z, sign):
        zc = z + 0.5 * sign * self.D
        return zc / (self.R**2 + zc**2)

    def __call__(self, geom):
        out = np.zeros((3, geom.nz, geom.ny, geom.nx))
        Z, Y, X = _grid_coords(geom, (0, 0, 1))
        sz = Z
        smx = 1.5 * (X - 0.5 * geom.Lx)
        smy = 1.5 * (Y - 0.5 * geom.Ly)
        for sign in (+1.0, -1.0):
            out[0] += self._B0(sz, sign) * smx * self._B1(sz, sign)
            out[0] += self._B0(sz, sign) * smy * self._B1(sz, sign)
        Zn, _, _ = _grid_coords(geom, (0, 0, 0))
        for sign in (+1.0, -1.0):
            out[2] += self._B0(Zn, sign)
        log.info("  Approximate magnetic mirror field is set")
        return out


class SetMagneticField:
    def __init__(self, simulation, setter, target="B0"):
        self.simulation = simulation
        self.setter = setter
        self.target = target

    @classmethod
    def from_json(cls, simulation, info):
        units = simulation.cfg.unit_table()
        field = info.get("field", {})
        name = field.get("name", "SetUniformField") if field else "SetUniformField"
        if name in ("SetUniformField", "uniform"):
            value = parse_vector(field.get("value", info.get("value", 0.0)), units)
            setter = SetUniformField(value)
        elif name in ("SetCoilsField", "coils"):
            coils = [
                (
                    parse_value(c["z0"], units),
                    parse_value(c["R"], units),
                    parse_value(c["I"], units),
                )
                for c in field["coils"]
            ]
            setter = SetCoilsField(coils)
        elif name in ("SetApproximateMirrorField", "mirror"):
            setter = SetApproximateMirrorField(
                parse_value(field["D"], units),
                parse_value(field["R"], units),
                parse_value(field["I"], units),
            )
        else:
            raise ValueError(f"unknown magnetic field setter {name!r}")
        return cls(simulation, setter)

    def execute(self, t: int) -> None:
        sim = self.simulation
        # The whole grid's field, of which a slab keeps its planes.
        g = sim.geom
        B0_add = self.setter(sim.cfg.geometry)[:, z0_of(g):z0_of(g) + g.nz]
        B0_add = torch.as_tensor(np.ascontiguousarray(B0_add),
                                 dtype=sim.B0.dtype, device=sim.B0.device)
        # The reference writes into B0 then adds it to B
        # (set_magnetic_field.cpp:76-83).
        sim.B0 = sim.B0 + B0_add
        sim.B = sim.B + B0_add
