"""Coordinate and momentum generators for particle loading.

A copy of ``xpic_tpu/commands/particles_load.py``: host-side numpy
counterparts of src/utils/particles_load.cpp.  Each
generator is vectorized over the particle count and draws from a shared
deterministic ``numpy.random.Generator`` (replacing the global mt19937
singleton of src/utils/random_generator.h; statistical equivalence, not
bitwise).  Set ``xpic_tpu_torch.commands.particles_load.seed(...)`` for
reproducible loads; the same seed gives the JAX package's particles.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Any

import numpy as np

from ..config import MEC2_KEV, SortParameters, parse_value, parse_vector

_rng = np.random.default_rng(5489)  # mt19937's default seed, as a nod


def seed(value: int) -> None:
    global _rng
    _rng = np.random.default_rng(value)


def rng() -> np.random.Generator:
    return _rng


def use_reference_rng(seed_value: int | None = None) -> None:
    """Switch the shared stream to the reference's exact mt19937 +
    libstdc++ uniform_real_distribution bit stream (native library;
    reference: src/utils/random_generator.h).  With
    :func:`set_particles_interleaved` draws this reproduces the
    reference's initial particle data bit-for-bit."""
    global _rng
    from ..runtime.native import ReferenceRng

    class _Adapter:
        def __init__(self):
            self._r = ReferenceRng(seed_value)

        def random(self, size=None):
            if size is None:
                return self._r.uniform(1)[0]
            n = int(np.prod(size))
            return self._r.uniform(n).reshape(size)

        def standard_normal(self, size=None):  # pragma: no cover
            raise NotImplementedError(
                "reference stream provides uniforms only"
            )

    _rng = _Adapter()


# -- geometries (src/utils/geometries.h:7-52) ------------------------------


@dataclasses.dataclass
class BoxGeometry:
    min: np.ndarray
    max: np.ndarray

    @property
    def volume(self) -> float:
        return float(np.prod(self.max - self.min))

    def contains(self, r: np.ndarray) -> np.ndarray:
        return np.all((r >= self.min) & (r <= self.max), axis=-1)


@dataclasses.dataclass
class CylinderGeometry:
    center: np.ndarray
    radius: float
    height: float

    @property
    def volume(self) -> float:
        return math.pi * self.radius**2 * self.height

    def contains(self, r: np.ndarray) -> np.ndarray:
        d = r - self.center
        within_r = d[:, 0] ** 2 + d[:, 1] ** 2 <= self.radius**2
        within_z = np.abs(d[:, 2]) <= 0.5 * self.height
        return within_r & within_z


@dataclasses.dataclass
class AnnulusGeometry:
    center: np.ndarray
    inner_r: float
    outer_r: float
    height: float


def load_box(info: Mapping[str, Any], units) -> BoxGeometry:
    lo = np.zeros(3)
    hi = np.array([units["geom_x"], units["geom_y"], units["geom_z"]])
    if "min" in info:
        lo = np.array(parse_vector(info["min"], units))
    if "max" in info:
        hi = np.array(parse_vector(info["max"], units))
    return BoxGeometry(lo, hi)


def load_cylinder(info: Mapping[str, Any], units) -> CylinderGeometry:
    center = np.array(
        [0.5 * units["geom_x"], 0.5 * units["geom_y"], 0.5 * units["geom_z"]]
    )
    radius = 0.5 * min(units["geom_x"], units["geom_y"])
    height = units["geom_z"]
    if "center" in info:
        center = np.array(parse_vector(info["center"], units))
    if "radius" in info:
        radius = parse_value(info["radius"], units)
    if "height" in info:
        height = parse_value(info["height"], units)
    return CylinderGeometry(center, radius, height)


# -- coordinate generators -------------------------------------------------


class PreciseCoordinate:
    def __init__(self, dot):
        self.dot = np.asarray(dot, dtype=np.float64)

    def __call__(self, n: int) -> np.ndarray:
        return np.broadcast_to(self.dot, (n, 3)).copy()


class CoordinateInBox:
    def __init__(self, box: BoxGeometry):
        self.box = box

    def __call__(self, n: int) -> np.ndarray:
        u = _rng.random((n, 3))
        return self.box.min + u * (self.box.max - self.box.min)


class CoordinateInCylinder:
    def __init__(self, cyl: CylinderGeometry):
        self.cyl = cyl

    def __call__(self, n: int) -> np.ndarray:
        c = self.cyl
        r = c.radius * np.sqrt(_rng.random(n))
        phi = 2.0 * math.pi * _rng.random(n)
        return np.stack(
            [
                c.center[0] + r * np.cos(phi),
                c.center[1] + r * np.sin(phi),
                c.center[2] + c.height * (_rng.random(n) - 0.5),
            ],
            axis=-1,
        )


class CoordinateOnAnnulus:
    def __init__(self, ann: AnnulusGeometry):
        self.ann = ann

    def __call__(self, n: int) -> np.ndarray:
        a = self.ann
        r = np.sqrt(a.inner_r**2 + (a.outer_r**2 - a.inner_r**2) * _rng.random(n))
        phi = 2.0 * math.pi * _rng.random(n)
        return np.stack(
            [
                a.center[0] + r * np.cos(phi),
                a.center[1] + r * np.sin(phi),
                a.center[2] + a.height * (_rng.random(n) - 0.5),
            ],
            axis=-1,
        )


# -- momentum generators ---------------------------------------------------


def temperature_momentum(T_keV: float, mass: float, n: int) -> np.ndarray:
    """sqrt(-2 (T m / mec2) ln u) (src/utils/particles_load.cpp:109-112)."""
    u = _rng.random(n)
    u = np.where(u == 0.0, np.finfo(np.float64).tiny, u)
    return np.sqrt(-2.0 * (T_keV * mass / MEC2_KEV) * np.log(u))


class PreciseMomentum:
    def __init__(self, value):
        self.value = np.asarray(value, dtype=np.float64)

    def __call__(self, coords: np.ndarray) -> np.ndarray:
        return np.broadcast_to(self.value, (coords.shape[0], 3)).copy()


class MaxwellianMomentum:
    """Box-Muller-style Maxwellian load
    (src/utils/particles_load.cpp:114-133); ``tov`` converts the sampled
    momentum to velocity via p / sqrt(m^2 + p^2)."""

    def __init__(self, params: SortParameters, tov: bool = False):
        self.params = params
        self.tov = tov

    def __call__(self, coords: np.ndarray) -> np.ndarray:
        n = coords.shape[0]
        pr = self.params
        out = np.empty((n, 3))
        for a, (p0, T) in enumerate(
            [(pr.px, pr.Tx), (pr.py, pr.Ty), (pr.pz, pr.Tz)]
        ):
            out[:, a] = p0 + np.sin(
                2.0 * math.pi * _rng.random(n)
            ) * temperature_momentum(T, pr.m, n)
        if self.tov:
            out /= np.sqrt(pr.m**2 + np.sum(out**2, axis=1))[:, None]
        return out


class MaxwellCosinePerturbation:
    """Maxwellian plus a cosine velocity perturbation
    (src/utils/particles_load.cpp:135-163)."""

    def __init__(self, params: SortParameters, box: BoxGeometry, amplitude, wave_number):
        self.params = params
        self.box = box
        self.a = np.asarray(amplitude, dtype=np.float64)
        self.m = np.asarray(wave_number, dtype=np.float64)

    def __call__(self, coords: np.ndarray) -> np.ndarray:
        n = coords.shape[0]
        pr = self.params
        L = self.box.max - self.box.min
        v = np.empty((n, 3))
        Ts = (pr.Tx, pr.Ty, pr.Tz)
        for a in range(3):
            v[:, a] = np.sin(2.0 * math.pi * _rng.random(n)) * temperature_momentum(
                Ts[a], pr.m, n
            )
        v /= np.sqrt(pr.m**2 + np.sum(v**2, axis=1))[:, None]
        for a in range(3):
            v0 = self.a[a] * math.sqrt(Ts[a] / (pr.m * MEC2_KEV))
            v[:, a] += v0 * np.cos(2.0 * math.pi * self.m[a] * coords[:, a] / L[a])
        return v


class AngularMomentum:
    """Azimuthal drift plus thermal spread
    (src/utils/particles_load.cpp:165-189)."""

    def __init__(self, params: SortParameters, center):
        self.params = params
        self.center = np.asarray(center, dtype=np.float64)

    def __call__(self, coords: np.ndarray) -> np.ndarray:
        pr = self.params
        n = coords.shape[0]
        x = coords[:, 0] - self.center[0]
        y = coords[:, 1] - self.center[1]
        r = np.hypot(x, y)
        tm = np.stack(
            [
                temperature_momentum(pr.Tx, pr.m, n),
                temperature_momentum(pr.Ty, pr.m, n),
                temperature_momentum(pr.Tz, pr.m, n),
            ],
            axis=-1,
        )
        safe = r > 0
        out = np.empty((n, 3))
        out[:, 0] = np.where(safe, -pr.px * np.divide(y, r, where=safe, out=np.zeros_like(r)), 0.0)
        out[:, 1] = np.where(safe, +pr.py * np.divide(x, r, where=safe, out=np.zeros_like(r)), 0.0)
        out[:, 2] = pr.pz
        out += tm
        return out


def generate_interleaved(coord_gen, mom_gen, n: int,
                         sin_first: bool = True):
    """Draw coordinates+momenta in the reference's per-particle order.

    The reference loop (src/commands/set_particles.cpp:28-40) draws, for
    each particle in turn, 3 coordinate uniforms then 6 momentum
    uniforms (2 per axis: the sin() phase and the temperature modulus,
    src/utils/particles_load.cpp:114-133).  Vectorized generators
    consume the stream in column blocks instead, so bit-parity with the
    reference additionally needs this interleaved loop.  ``sin_first``
    selects the operand evaluation order of the reference's
    ``sin(2 pi u1) * temperature_momentum(u2)`` product (unspecified in
    C++; both orders are provided).
    """
    supported = isinstance(coord_gen, CoordinateInBox) and isinstance(
        mom_gen, (MaxwellianMomentum,)
    )
    if not supported:
        coords = coord_gen(n)
        return coords, mom_gen(coords)

    u = _rng.random((n, 9))
    box = coord_gen.box
    coords = box.min + u[:, 0:3] * (box.max - box.min)

    pr = mom_gen.params
    out = np.empty((n, 3))
    for a, (p0, T) in enumerate([(pr.px, pr.Tx), (pr.py, pr.Ty),
                                 (pr.pz, pr.Tz)]):
        u1 = u[:, 3 + 2 * a]
        u2 = u[:, 4 + 2 * a]
        if not sin_first:
            u1, u2 = u2, u1
        mod = np.sqrt(
            -2.0 * (T * pr.m / MEC2_KEV)
            * np.log(np.where(u2 == 0.0, np.finfo(np.float64).tiny, u2))
        )
        out[:, a] = p0 + np.sin(2.0 * math.pi * u1) * mod
    if mom_gen.tov:
        out /= np.sqrt(pr.m**2 + np.sum(out**2, axis=1))[:, None]
    return coords, out


def build_coordinate(info: Mapping[str, Any], params: SortParameters, units):
    """Dispatch + particle-count rule
    (src/commands/builders/particles_builder.cpp:9-38)."""
    name = info["name"]
    frac = params.Np / (units["dx"] * units["dy"] * units["dz"])
    if name == "PreciseCoordinate":
        return PreciseCoordinate(parse_vector(info["value"], units)), params.Np
    if name == "CoordinateInBox":
        box = load_box(info, units)
        return CoordinateInBox(box), int(box.volume * frac)
    if name == "CoordinateInCylinder":
        cyl = load_cylinder(info, units)
        return CoordinateInCylinder(cyl), int(cyl.volume * frac)
    raise ValueError(f"unknown coordinate generator {name!r}")


def build_momentum(info: Mapping[str, Any], params: SortParameters, units):
    """Dispatch (src/commands/builders/particles_builder.cpp:40-70)."""
    name = info["name"]
    if name == "PreciseMomentum":
        return PreciseMomentum(parse_vector(info["value"], units))
    if name == "MaxwellianMomentum":
        return MaxwellianMomentum(params, bool(info.get("tov", False)))
    if name == "MaxwellCosinePerturbation":
        return MaxwellCosinePerturbation(
            params,
            load_box(info, units),
            parse_vector(info["amplitude"], units),
            parse_vector(info["wave_number"], units),
        )
    if name == "AngularMomentum":
        return AngularMomentum(params, parse_vector(info.get("center", "Geom / 2"), units))
    raise ValueError(f"unknown momentum generator {name!r}")
