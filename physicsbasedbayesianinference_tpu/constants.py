"""Physical constants and unit systems.

The reference (Anton-Le/PhysicsBasedBayesianInference) hard-codes SI constants
(``scipy.constants.k`` in ensemble.py:13, ``scipy.constants.G`` in
potential.py:13) and then works around them in tests by passing
``temperature = 1 / k_B`` (reference src/tests/test_HMC.py). SI magnitudes
(k_B ~ 1e-23) underflow float32, the accelerator's working dtype, so this
framework makes the constant system an explicit, swappable value:

* ``NATURAL`` (default): k_B = G = 1 — the right choice for statistical
  inference, where "temperature" is the tempering parameter beta = 1/(k_B T).
* ``SI``: full physical constants, for physics-mode simulation in float64 or
  for externally pre-scaled units.
* ``solar_system_units()``: AU / solar-mass / day units in which gravitational
  dynamics of planetary systems are O(1) and float32-safe.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Constants:
    """Physical constants used by thermodynamic scaling and gravity.

    Attributes:
      k_B: Boltzmann constant. Thermal momenta are drawn with per-component
        std ``sqrt(mass * k_B * T)`` (reference ensemble.py:88).
      G: Gravitational constant for N-body potentials (reference
        potential.py:51).
    """

    k_B: float = 1.0
    G: float = 1.0

    def beta(self, temperature: float) -> float:
        """Inverse temperature 1 / (k_B * T)."""
        return 1.0 / (self.k_B * temperature)


NATURAL = Constants(k_B=1.0, G=1.0)

# CODATA 2018 values, matching scipy.constants used by the reference.
SI = Constants(k_B=1.380649e-23, G=6.6743e-11)

# Astronomical units: length = AU, mass = M_sun, time = day.
# G = 6.6743e-11 m^3 kg^-1 s^-2 converted:
#   AU = 1.495978707e11 m, M_sun = 1.98892e30 kg, day = 86400 s
_AU = 1.495978707e11
_MSUN = 1.98892e30
_DAY = 86400.0
_G_ASTRO = 6.6743e-11 * _MSUN * _DAY**2 / _AU**3


def solar_system_units() -> Constants:
    """Constants in AU / M_sun / day units (G ~= 2.96e-4, float32-safe)."""
    return Constants(k_B=1.0, G=_G_ASTRO)


# Conversion helpers exposed for tests and the physics layer.
AU_IN_METERS = _AU
SOLAR_MASS_IN_KG = _MSUN
DAY_IN_SECONDS = _DAY
