"""Frozen configuration model replacing the reference's global state.

The reference stores geometry in mutable globals (``dx, dy, dz, dt,
Geom[3], Geom_n[3], geom_nt, diagnose_period`` — reference:
src/constants.h:10-28, set by World::set_geometry at
src/utils/world.cpp:64-112) and a JSON singleton
(src/utils/configuration.h:11-66).  In a JAX design everything that
shapes the computation graph must be static, so the whole of that state
becomes frozen dataclasses that are hashed into jit caches.

The JSON schema is kept compatible with the reference's ``config.json``
(sections ``Simulation``, ``OutputDirectory``, ``Geometry``,
``Particles``, ``Presets``, ``StepPresets``, ``Diagnostics``,
``SimulationBackup``) including unit-suffixed values such as ``"2 [dx]"``
(reference: src/interfaces/builder.cpp:54-81).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Mapping, Sequence

# Boundary kinds (reference: DM_BOUNDARY_* parsing in
# src/utils/configuration.cpp:88-116).  REFLECTIVE maps particles with
# the reference's g_bound_reflective (clamp + momentum flip,
# src/interfaces/point.cpp:3-17); fields see it as zero-filled ghosts,
# like GHOSTED.
PERIODIC = "periodic"
GHOSTED = "ghosted"
REFLECTIVE = "reflective"
NONE = "none"

_BOUNDARY_ALIASES = {
    "DM_BOUNDARY_PERIODIC": PERIODIC,
    "DM_BOUNDARY_GHOSTED": GHOSTED,
    "DM_BOUNDARY_REFLECTIVE": REFLECTIVE,
    "DM_BOUNDARY_NONE": NONE,
    "periodic": PERIODIC,
    "ghosted": GHOSTED,
    "reflective": REFLECTIVE,
    "reflect": REFLECTIVE,
    "none": NONE,
}

#: Electron rest energy in keV (reference: src/constants.h:30).
MEC2_KEV = 511.0


def round_step(value: float, step: float) -> int:
    """ROUND_STEP from the reference: number of steps of size `step` in `value`."""
    return int(round(value / step))


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Grid/time geometry in plasma units (c/w_pe, 1/w_pe).

    Mirrors the information kept in the reference globals
    (src/constants.h:10-28).  ``nx, ny, nz`` count cells per axis;
    fields live on the Yee lattice of the same extent.
    """

    dx: float
    dy: float
    dz: float
    dt: float
    nx: int
    ny: int
    nz: int
    nt: int
    diagnose_period: int = 100
    bounds: tuple[str, str, str] = (PERIODIC, PERIODIC, PERIODIC)

    @property
    def Lx(self) -> float:
        return self.nx * self.dx

    @property
    def Ly(self) -> float:
        return self.ny * self.dy

    @property
    def Lz(self) -> float:
        return self.nz * self.dz

    @property
    def Lt(self) -> float:
        return self.nt * self.dt

    @property
    def L(self) -> tuple[float, float, float]:
        return (self.Lx, self.Ly, self.Lz)

    @property
    def cell_steps(self) -> tuple[float, float, float]:
        return (self.dx, self.dy, self.dz)

    @property
    def shape(self) -> tuple[int, int, int]:
        """Grid shape in (z, y, x) array order."""
        return (self.nz, self.ny, self.nx)

    @property
    def n_cells(self) -> int:
        return self.nx * self.ny * self.nz

    def validate(self) -> None:
        if min(self.nx, self.ny, self.nz) < 1 or self.nt < 0:
            raise ValueError("grid extents must be positive")
        for b in self.bounds:
            if b not in (PERIODIC, GHOSTED, REFLECTIVE, NONE):
                raise ValueError(f"unknown boundary kind {b!r}")


@dataclasses.dataclass(frozen=True)
class SortParameters:
    """Per-species constants (reference: src/interfaces/sort_parameters.h:7-19)."""

    sort_name: str
    Np: int  # particles per cell (dimensionless)
    n: float  # reference density [n0]
    q: float  # charge [e]
    m: float  # mass [me]
    px: float = 0.0  # initial momentum [me c]
    py: float = 0.0
    pz: float = 0.0
    Tx: float = 0.0  # temperature [keV]
    Ty: float = 0.0
    Tz: float = 0.0

    @property
    def qm(self) -> float:
        return self.q / self.m

    @property
    def n_Np(self) -> float:
        """Macro-particle weight n/Np (reference: particles.cpp:interfaces n_Np)."""
        return self.n / self.Np


def parse_value(value: Any, geom: Mapping[str, float]) -> float:
    """Parse a config value with optional unit suffix.

    Accepts plain numbers and strings like ``"2 [dx]"``, ``"100 [dt]"``,
    ``"5 [c/w_pe]"``, ``"30 [1/w_pe]"`` plus the named values
    ``geom_x/geom_y/geom_z`` (reference: src/interfaces/builder.cpp:54-81).
    ``geom`` supplies the unit table (at least dx, dy, dz, dt).
    """
    if isinstance(value, (int, float)):
        return float(value)
    if not isinstance(value, str):
        raise TypeError(f"cannot parse config value {value!r}")

    s = value.strip()
    if s in ("geom_x", "geom_nx"):
        return float(geom["geom_x"])
    if s in ("geom_y", "geom_ny"):
        return float(geom["geom_y"])
    if s in ("geom_z", "geom_nz"):
        return float(geom["geom_z"])

    for suffix, unit in (
        (" [dx]", "dx"),
        (" [dy]", "dy"),
        (" [dz]", "dz"),
        (" [dt]", "dt"),
    ):
        if s.endswith(suffix):
            return float(s[: -len(suffix)]) * float(geom[unit])

    for suffix in (" [c/w_pe]", " [1/w_pe]"):
        if s.endswith(suffix):
            return float(s[: -len(suffix)])

    raise ValueError(f"unknown unit format in config value: {value!r}")


def parse_vector(value: Any, geom: Mapping[str, float]) -> tuple[float, float, float]:
    """Parse a 3-vector config entry (reference: src/interfaces/builder.cpp:22-52)."""
    if isinstance(value, str):
        if value == "Geom":
            return (geom["geom_x"], geom["geom_y"], geom["geom_z"])
        if value == "Geom / 2":
            return (
                geom["geom_x"] / 2,
                geom["geom_y"] / 2,
                geom["geom_z"] / 2,
            )
    if isinstance(value, Sequence) and not isinstance(value, str):
        if len(value) != 3:
            raise ValueError("vector entries must have 3 components")
        return tuple(parse_value(v, geom) for v in value)  # type: ignore[return-value]
    v = parse_value(value, geom)
    return (v, v, v)


def geometry_from_json(section: Mapping[str, Any]) -> Geometry:
    """Build :class:`Geometry` from the ``Geometry`` config section.

    The reference reads dx/dy/dz/dt first so they can serve as units for
    the extents (src/utils/world.cpp:21-31), then rounds extents to whole
    steps (src/utils/world.cpp:86-91).
    """
    dx = float(section["dx"])
    dy = float(section["dy"])
    dz = float(section["dz"])
    dt = float(section["dt"])
    units = {"dx": dx, "dy": dy, "dz": dz, "dt": dt}

    gx = parse_value(section["x"], units)
    gy = parse_value(section["y"], units)
    gz = parse_value(section["z"], units)
    gt = parse_value(section["t"], units)
    units.update(geom_x=gx, geom_y=gy, geom_z=gz)

    dtp = parse_value(section.get("diagnose_period", gt), units)

    bounds = tuple(
        _BOUNDARY_ALIASES[section.get(f"da_boundary_{ax}", "DM_BOUNDARY_PERIODIC")]
        for ax in "xyz"
    )

    geom = Geometry(
        dx=dx,
        dy=dy,
        dz=dz,
        dt=dt,
        nx=round_step(gx, dx),
        ny=round_step(gy, dy),
        nz=round_step(gz, dz),
        nt=round_step(gt, dt),
        diagnose_period=max(1, round_step(dtp, dt)),
        bounds=bounds,  # type: ignore[arg-type]
    )
    geom.validate()
    return geom


def sorts_from_json(section: Sequence[Mapping[str, Any]]) -> tuple[SortParameters, ...]:
    """Parse the ``Particles`` config section
    (reference: src/interfaces/simulation.tpp:6-80)."""
    sorts = []
    for info in section or ():
        if "sort_name" not in info:
            continue
        if "T" in info:
            T = float(info["T"])
            Ts = dict(Tx=T, Ty=T, Tz=T)
        else:
            Ts = dict(
                Tx=float(info.get("Tx", 0.0)),
                Ty=float(info.get("Ty", 0.0)),
                Tz=float(info.get("Tz", 0.0)),
            )
        sorts.append(
            SortParameters(
                sort_name=str(info["sort_name"]),
                Np=int(info["Np"]),
                n=float(info["n"]),
                q=float(info["q"]),
                m=float(info["m"]),
                px=float(info.get("px", 0.0)),
                py=float(info.get("py", 0.0)),
                pz=float(info.get("pz", 0.0)),
                **Ts,
            )
        )
    return tuple(sorts)


@dataclasses.dataclass(frozen=True)
class Config:
    """Full parsed configuration of one simulation run."""

    scheme: str
    out_dir: str
    geometry: Geometry
    sorts: tuple[SortParameters, ...]
    # Raw JSON sections kept for the command/diagnostic builders.
    presets: tuple[Mapping[str, Any], ...] = ()
    step_presets: tuple[Mapping[str, Any], ...] = ()
    diagnostics: tuple[Mapping[str, Any], ...] = ()
    backup: Mapping[str, Any] | None = None
    raw: Mapping[str, Any] | None = None
    # Number of devices to shard the run over (the analog of the
    # reference's mpiexec -n N + -da_processors_* decomposition options,
    # src/utils/world.cpp:36-46).  1 = unsharded single chip.
    n_devices: int = 1
    # Mesh shape: (Dz,) for a 1-D z mesh, (Dz, Dy) for a 2-D z*y mesh,
    # (Dz, Dy, Dx) for the full 3-axis decomposition (the per-axis
    # processor counts, configuration.cpp:117-130).
    mesh_shape: tuple = (1,)

    @staticmethod
    def from_json(doc: Mapping[str, Any]) -> "Config":
        geometry = geometry_from_json(doc["Geometry"])
        # "Mesh": N (1-D z mesh) or {"z": Dz, "y": Dy, "x": Dx} (the
        # -da_processors_* analog, any subset of axes).  {"devices": N}
        # is the legacy form.
        mesh_doc = doc.get("Mesh", 1)
        if isinstance(mesh_doc, Mapping):
            if "z" in mesh_doc or "y" in mesh_doc or "x" in mesh_doc:
                dz = int(mesh_doc.get("z", 1))
                dy = int(mesh_doc.get("y", 1))
                dx = int(mesh_doc.get("x", 1))
                if dx > 1:
                    mesh_shape = (dz, dy, dx)
                elif dy > 1:
                    mesh_shape = (dz, dy)
                else:
                    mesh_shape = (dz,)
            else:
                mesh_shape = (int(mesh_doc.get("devices", 1)),)
        else:
            mesh_shape = (int(mesh_doc),)
        n_devices = 1
        for d in mesh_shape:
            n_devices *= d
        return Config(
            scheme=str(doc["Simulation"]),
            out_dir=str(doc.get("OutputDirectory", "results/out")),
            geometry=geometry,
            sorts=sorts_from_json(doc.get("Particles", ())),
            presets=tuple(doc.get("Presets", ())),
            step_presets=tuple(doc.get("StepPresets", ())),
            diagnostics=tuple(doc.get("Diagnostics", ())),
            backup=doc.get("SimulationBackup"),
            raw=doc,
            n_devices=n_devices,
            mesh_shape=mesh_shape,
        )

    @staticmethod
    def from_file(path: str) -> "Config":
        with open(path, "r") as fh:
            return Config.from_json(json.load(fh))

    def unit_table(self) -> dict[str, float]:
        g = self.geometry
        return {
            "dx": g.dx,
            "dy": g.dy,
            "dz": g.dz,
            "dt": g.dt,
            "geom_x": g.Lx,
            "geom_y": g.Ly,
            "geom_z": g.Lz,
        }


def thermal_velocity(T_keV: float, mass: float) -> float:
    """Thermal velocity in units of c for temperature in keV
    (reference: src/interfaces/simulation.tpp:56-60)."""
    return math.sqrt(T_keV / (mass * MEC2_KEV))
