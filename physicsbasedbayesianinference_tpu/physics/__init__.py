"""Direct physical simulation: N-body systems, integrator zoo, trajectory
drivers, conserved-quantity oracles (the reference's samples/NBody layer
and solar-system tests, rebuilt as scan-compiled XLA programs)."""

from . import integrators, nbody
from . import simulate as simulate_lib
from .integrators import INTEGRATORS as PHYSICS_INTEGRATORS
from .integrators import get_physics_integrator
from .nbody import (
    NBodySystem,
    accelerations,
    center_of_mass_frame,
    jerk,
    kepler_two_body,
    load_nbody_text,
    new_system,
    save_nbody_text,
    solar_system,
    total_angular_momentum,
    total_energy,
    two_body_invariants,
)
from .simulate import (
    Trajectory,
    adaptive_dt_advanced,
    adaptive_dt_simple,
    energy_drift,
    simulate,
    simulate_adaptive,
    simulate_rk45,
)

__all__ = [
    "integrators", "nbody", "simulate", "PHYSICS_INTEGRATORS",
    "get_physics_integrator", "NBodySystem", "new_system",
    "center_of_mass_frame", "accelerations", "jerk", "total_energy",
    "total_angular_momentum", "two_body_invariants", "solar_system",
    "kepler_two_body", "load_nbody_text", "save_nbody_text", "Trajectory",
    "simulate_adaptive", "simulate_rk45", "adaptive_dt_simple",
    "adaptive_dt_advanced", "energy_drift",
]
