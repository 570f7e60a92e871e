"""N-body system state, conserved quantities, and initial-condition IO.

Redesign of the reference's N-body support layer (reference
samples/NBody/MiscFunctions.py and the direct-simulation path of
src/potential.py / src/tests/test_integrator_solar_system.py):

* state is an immutable pytree (positions/velocities/masses), vectorised
  over bodies — no per-particle Python loops (contrast MiscFunctions.py
  ``Accel``:51-78, ``Energy``:155-171, both O(N^2) Python loops);
* conserved-quantity oracles (total energy, angular momentum, and the
  two-body Kepler invariants: reduced angular momentum, Runge-Lenz vector,
  semi-major axis — reference Integrators2B.py:115-137) are jittable
  functions used by automated tolerance tests instead of eyeballed plots;
* the text initial-condition format (header ``N tmax dt``, then N masses,
  N position rows, N velocity rows — reference MiscFunctions.py:8-43,
  data files samples/NBody/pl{2,3,100,1k}.txt) is parsed host-side;
* the Earth-Sun-Moon system of the reference's orbit test
  (test_integrator_solar_system.py:28-40) ships as a preset, in SI units
  (float64, CPU physics mode) and AU/M_sun/day units (float32-safe).
"""

from __future__ import annotations

import io
from typing import Union

import jax
import jax.numpy as jnp

from ..constants import (
    AU_IN_METERS,
    Constants,
    DAY_IN_SECONDS,
    NATURAL,
    SI,
    SOLAR_MASS_IN_KG,
    solar_system_units,
)
from ..ops.potentials import nbody_accelerations, nbody_potential_energy
from ..utils import struct

Array = jax.Array


@struct.dataclass
class NBodySystem:
    """Gravitational N-body state: ``x``/``v`` are ``[N, D]``, ``mass`` is
    ``[N]``, ``time`` a scalar. Batch in front of these axes with ``vmap``
    for ensembles of systems."""

    x: Array
    v: Array
    mass: Array
    time: Array

    @property
    def num_bodies(self) -> int:
        return self.x.shape[-2]

    @property
    def num_space_dims(self) -> int:
        return self.x.shape[-1]


def new_system(x, v, mass, *, time: float = 0.0,
               dtype=None) -> NBodySystem:
    x = jnp.asarray(x, dtype=dtype)
    return NBodySystem(
        x=x,
        v=jnp.asarray(v, dtype=x.dtype),
        mass=jnp.asarray(mass, dtype=x.dtype),
        time=jnp.asarray(time, dtype=x.dtype),
    )


# ---------------------------------------------------------------------------
# Frames and conserved quantities
# ---------------------------------------------------------------------------


def center_of_mass_frame(system: NBodySystem) -> NBodySystem:
    """Shift to the CoM frame (position and velocity): the transform the
    reference's driver applies before integrating (NBody.py:43-51)."""
    total = jnp.sum(system.mass, axis=-1, keepdims=True)
    w = (system.mass / total)[..., :, None]
    x_com = jnp.sum(w * system.x, axis=-2, keepdims=True)
    v_com = jnp.sum(w * system.v, axis=-2, keepdims=True)
    return system.replace(x=system.x - x_com, v=system.v - v_com)


def kinetic_energy(system: NBodySystem) -> Array:
    return 0.5 * jnp.sum(
        system.mass * jnp.sum(system.v * system.v, axis=-1), axis=-1)


def total_energy(system: NBodySystem, *, constants: Constants = NATURAL,
                 softening: float = 0.0) -> Array:
    """T + U (reference ``Energy``, MiscFunctions.py:155-171, vectorised)."""
    return kinetic_energy(system) + nbody_potential_energy(
        system.x, system.mass, constants=constants, softening=softening)


def total_angular_momentum(system: NBodySystem) -> Array:
    """|sum_i m_i x_i x v_i| (3D cross product over the last axis)."""
    L = jnp.sum(system.mass[..., :, None]
                * jnp.cross(system.x, system.v), axis=-2)
    return jnp.linalg.norm(L, axis=-1)


def accelerations(system: NBodySystem, *, constants: Constants = NATURAL,
                  softening: float = 0.0) -> Array:
    return nbody_accelerations(
        system.x, system.mass, constants=constants, softening=softening)


def jerk(x: Array, v: Array, mass: Array, *,
         constants: Constants = NATURAL, softening: float = 0.0) -> Array:
    """Time derivative of gravitational acceleration (needed by the Hermite
    predictor-corrector and adaptive-timestep criteria):

        da_i/dt = G sum_j m_j [ dv/r^3 - 3 (dr . dv) dr / r^5 ]

    Reference ``AccelDeriv`` (MiscFunctions.py:118-149) computes this with a
    double Python loop (and only over half the bodies — a bug for odd N);
    here it is one masked pairwise computation over all bodies.
    """
    n = x.shape[-2]
    dr = x[..., None, :, :] - x[..., :, None, :]  # [N, N, D], j - i
    dv = v[..., None, :, :] - v[..., :, None, :]
    dist2 = jnp.sum(dr * dr, axis=-1) + softening**2
    eye = jnp.eye(n, dtype=bool)
    safe = jnp.where(eye, 1.0, dist2)
    inv3 = jnp.where(eye, 0.0, jax.lax.rsqrt(safe) ** 3)
    inv5 = jnp.where(eye, 0.0, jax.lax.rsqrt(safe) ** 5)
    rdotv = jnp.sum(dr * dv, axis=-1)
    term = (dv * inv3[..., None]
            - 3.0 * dr * (rdotv * inv5)[..., None])
    return constants.G * jnp.sum(mass[None, :, None] * term, axis=-2)


def two_body_invariants(system: NBodySystem, *,
                        constants: Constants = NATURAL) -> dict:
    """Kepler invariants of the relative two-body orbit (bodies 0 and 1):
    reduced angular momentum L, Runge-Lenz eccentricity vector R, and
    semi-major axis a = |L|^2 / (G M mu^2 (1 - |R|^2)) — the conservation
    oracles of reference Integrators2B.py:115-137.
    """
    m0 = system.mass[..., 0]
    m1 = system.mass[..., 1]
    mu = m0 * m1 / (m0 + m1)
    rel_r = system.x[..., 0, :] - system.x[..., 1, :]
    rel_v = system.v[..., 0, :] - system.v[..., 1, :]
    L = jnp.cross(rel_r, rel_v) * mu[..., None]
    gm = constants.G * (m0 + m1)
    # R is dimensionless (the eccentricity vector)
    R = (jnp.cross(rel_v, L / mu[..., None]) / gm[..., None]
         - rel_r / jnp.linalg.norm(rel_r, axis=-1, keepdims=True))
    l_nrm = jnp.linalg.norm(L, axis=-1)
    r_nrm = jnp.linalg.norm(R, axis=-1)
    a = (l_nrm / mu) ** 2 / (gm * (1.0 - r_nrm**2))
    return {"angular_momentum": l_nrm, "runge_lenz": r_nrm,
            "semi_major_axis": a}


# ---------------------------------------------------------------------------
# Initial conditions IO
# ---------------------------------------------------------------------------


def load_nbody_text(source: Union[str, io.TextIOBase], *,
                    dtype=jnp.float64) -> tuple[NBodySystem, float, float]:
    """Parse the reference's N-body text format and return
    ``(system, tmax, dt)``.

    Format (reference ``ReadInput``, MiscFunctions.py:8-43): first line
    ``N tmax dt``; then N mass lines; N position rows ``x y z``; N velocity
    rows ``vx vy vz``. ``source`` is a filename, the raw text itself, or an
    open text file.
    """
    if isinstance(source, io.TextIOBase):
        text = source.read()
    elif "\n" in str(source):
        text = str(source)
    else:
        with open(source) as f:
            text = f.read()
    # native tokenizer (csrc/pbbi_io.cpp) with numpy fallback
    from ..native import parse_nbody_text
    mass_np, x_np, v_np, tmax, dt = parse_nbody_text(text)
    mass = jnp.asarray(mass_np, dtype=dtype)
    x = jnp.asarray(x_np, dtype=dtype)
    v = jnp.asarray(v_np, dtype=dtype)
    return new_system(x, v, mass), tmax, dt


def save_nbody_text(system: NBodySystem, tmax: float, dt: float) -> str:
    """Serialise to the same text format (round-trips load_nbody_text)."""
    lines = [f"{system.num_bodies} {tmax} {dt}"]
    lines += [repr(float(m)) for m in system.mass]
    for arr in (system.x, system.v):
        lines += [" ".join(repr(float(c)) for c in row) for row in arr]
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

_EARTH_MASS_KG = 5.972e24   # reference test_integrator_solar_system.py:28
_SUN_MASS_KG = 1.989e30
_MOON_MASS_KG = 7.34e22
_EARTH_X_M = 1.52e11
_EARTH_VY_MS = 29_800.0
_MOON_DY_M = 3.844e8
_MOON_VZ_MS = 1_022.0


def solar_system(units: str = "astro") -> tuple[NBodySystem, Constants]:
    """Earth-Sun-Moon with the reference's initial data
    (test_integrator_solar_system.py:28-40: Earth at aphelion-ish 1.52e11 m
    with 29.8 km/s, Moon offset 3.844e8 m with +1.022 km/s out-of-plane).

    ``units="si"``: metres/kg/seconds, float64 (SI gravitational energies
    overflow float32). ``units="astro"``: AU / M_sun / day, float32-safe —
    the scaling float32 accelerators want (SURVEY.md §7 risks: normalise
    units internally).
    Returns ``(system, constants)``.
    """
    mass_kg = [_EARTH_MASS_KG, _SUN_MASS_KG, _MOON_MASS_KG]
    x_m = [[_EARTH_X_M, 0.0, 0.0],
           [0.0, 0.0, 0.0],
           [_EARTH_X_M, _MOON_DY_M, 0.0]]
    v_ms = [[0.0, _EARTH_VY_MS, 0.0],
            [0.0, 0.0, 0.0],
            [0.0, _EARTH_VY_MS, _MOON_VZ_MS]]
    if units == "si":
        sys_ = new_system(x_m, v_ms, mass_kg, dtype=jnp.float64)
        return sys_, SI
    if units == "astro":
        import numpy as np
        x = np.asarray(x_m) / AU_IN_METERS
        v = np.asarray(v_ms) * DAY_IN_SECONDS / AU_IN_METERS
        m = np.asarray(mass_kg) / SOLAR_MASS_IN_KG
        return new_system(x, v, m, dtype=jnp.float32), solar_system_units()
    raise ValueError(f"unknown units {units!r}")


def kepler_two_body(*, eccentricity: float = 0.5, mass_ratio: float = 1e-3,
                    dtype=jnp.float32) -> tuple[NBodySystem, Constants]:
    """A clean two-body Kepler orbit in natural units (G = 1, M = 1) for
    invariant-conservation tests: starts at periapsis of an orbit with the
    given eccentricity and semi-major axis 1."""
    e = float(eccentricity)
    m1 = float(mass_ratio)
    r_peri = 1.0 - e
    # vis-viva with a = 1, GM = 1 + m1
    v_peri = (((1.0 + m1) * (2.0 / r_peri - 1.0)) ** 0.5)
    x = [[r_peri * m1 / (1 + m1), 0.0, 0.0],
         [-r_peri / (1 + m1), 0.0, 0.0]]
    v = [[0.0, v_peri * m1 / (1 + m1), 0.0],
         [0.0, -v_peri / (1 + m1), 0.0]]
    # body 0 = primary (mass 1), body 1 = secondary (mass m1); relative
    # separation r_peri, relative speed v_peri.
    sys_ = new_system(x, v, [1.0, m1], dtype=dtype)
    return center_of_mass_frame(sys_), NATURAL
