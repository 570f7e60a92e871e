"""Compute ops: potentials, symplectic integrators, the fused GPU kernel."""

from . import integrators, potentials
from .integrators import INTEGRATORS, get_integrator
from .potentials import (
    batched_value_and_grad,
    harmonic_potential,
    make_banana,
    make_funnel,
    make_gaussian,
    make_harmonic,
    make_logistic_regression,
    make_nbody_potential,
    make_standard_normal,
    nbody_accelerations,
    nbody_potential_energy,
    no_potential,
    pad_potential,
)

__all__ = [
    "integrators",
    "potentials",
    "INTEGRATORS",
    "get_integrator",
    "batched_value_and_grad",
    "harmonic_potential",
    "make_banana",
    "make_funnel",
    "make_gaussian",
    "make_harmonic",
    "make_logistic_regression",
    "make_nbody_potential",
    "make_standard_normal",
    "nbody_accelerations",
    "nbody_potential_energy",
    "no_potential",
    "pad_potential",
]
