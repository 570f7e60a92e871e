"""Ensemble state: the walker population as an immutable, shardable pytree.

Redesign of the reference ``Ensemble`` class (reference
src/ensemble.py:17-114). Differences, by design:

* **Walker-major layout** ``[num_walkers, num_dims]`` instead of the
  reference's ``[num_dims, num_particles]`` — the walker axis is the axis we
  shard over a device mesh, and it must be the leading axis for
  ``NamedSharding(mesh, P('walkers', None))``.
* **Immutable pytree** instead of in-place numpy mutation (the reference
  aliases ensemble arrays into the integrator and mutates them,
  integrator.py:40-43, 112-120). Pure-functional state is what lets the whole
  sampling loop live inside one ``jit``/``lax.scan``.
* **Explicit RNG keys** via ``jax.random`` instead of the unseeded global
  numpy RNG (reference ensemble.py:72,89) — runs are deterministic and
  reproducible per-walker even when sharded.
* **Log-weights** instead of raw weights (reference ensemble.py:43,52-61 has
  a commented-out Boltzmann weight ``exp(-H/kT)``, which underflows): SMC and
  tempering need log-space weights.

The Maxwell-Boltzmann thermal momentum refresh (per-component std
``sqrt(mass * k_B * T)``, reference ensemble.py:88) is preserved exactly,
with ``k_B`` taken from an explicit :class:`~..constants.Constants`.
"""

from __future__ import annotations

from typing import Union

import jax
import jax.numpy as jnp

from .constants import Constants, NATURAL
from .utils import struct

Array = jax.Array


@struct.dataclass
class EnsembleState:
    """State of an ensemble of walkers.

    Attributes:
      q: positions, ``[num_walkers, num_dims]``.
      p: momenta, ``[num_walkers, num_dims]``.
      mass: mass (diagonal metric). Any shape broadcastable against
        ``[num_walkers, num_dims]``: scalar, per-dim ``[num_dims]``,
        per-walker ``[num_walkers, 1]`` (the reference's per-particle scalar
        mass, ensemble.py:42), or full ``[num_walkers, num_dims]``.
      log_weight: per-walker log importance weight, ``[num_walkers]``
        (zeros for plain MCMC; used by tempering/SMC).
    """

    q: Array
    p: Array
    mass: Array
    log_weight: Array

    @property
    def num_walkers(self) -> int:
        return self.q.shape[0]

    @property
    def num_dims(self) -> int:
        return self.q.shape[-1]


def _as_mass(mass: Union[float, Array], dtype) -> Array:
    m = jnp.asarray(mass, dtype=dtype)
    return m


def new_ensemble(
    num_walkers: int,
    num_dims: int,
    *,
    mass: Union[float, Array] = 1.0,
    dtype=jnp.float32,
) -> EnsembleState:
    """Create a zero-initialised ensemble (parity: reference ensemble.py:38-43

    starts with zero q/p, unit mass, zero weights)."""
    return EnsembleState(
        q=jnp.zeros((num_walkers, num_dims), dtype=dtype),
        p=jnp.zeros((num_walkers, num_dims), dtype=dtype),
        mass=_as_mass(mass, dtype),
        log_weight=jnp.zeros((num_walkers,), dtype=dtype),
    )


def sample_positions(
    key: Array,
    state: EnsembleState,
    q_std: Union[float, Array],
    mean: Union[float, Array] = 0.0,
) -> EnsembleState:
    """Gaussian position initialisation (reference ``setPosition``,

    ensemble.py:63-76), seeded and vectorised."""
    q = mean + q_std * jax.random.normal(key, state.q.shape, dtype=state.q.dtype)
    return state.replace(q=q)


def thermal_momentum_std(
    mass: Array, temperature: Union[float, Array], constants: Constants = NATURAL
) -> Array:
    """Maxwell-Boltzmann per-component momentum std ``sqrt(m k_B T)``

    (reference ensemble.py:88)."""
    return jnp.sqrt(mass * constants.k_B * temperature)


def sample_momenta(
    key: Array,
    state: EnsembleState,
    temperature: Union[float, Array] = 1.0,
    constants: Constants = NATURAL,
) -> EnsembleState:
    """Thermal (Maxwell-Boltzmann) momentum refresh (reference

    ``setMomentum``, ensemble.py:78-93)."""
    p_std = thermal_momentum_std(state.mass, temperature, constants)
    noise = jax.random.normal(key, state.p.shape, dtype=state.p.dtype)
    return state.replace(p=p_std * noise)


def kinetic_energy(p: Array, mass: Union[float, Array]) -> Array:
    """Per-walker kinetic energy ``sum_d p_d^2 / (2 m_d)``.

    (Reference HMC.py:100-102 computes the same per particle in a Python
    loop.)  ``p``: ``[num_walkers, num_dims]`` -> ``[num_walkers]``.
    """
    return 0.5 * jnp.sum(p * p / mass, axis=-1)


def velocities(p: Array, mass: Union[float, Array]) -> Array:
    """v = p / m (broadcasting diagonal mass)."""
    return p / mass


def walker(state: EnsembleState, index: int):
    """Return (q, p, mass, log_weight) of one walker (reference

    ``Ensemble.particle``, ensemble.py:95-114). Bounds are checked statically.
    """
    n = state.num_walkers
    if not 0 <= index < n:
        raise IndexError(f"Index {index} out of bounds. num_walkers={n}")
    mass = jnp.broadcast_to(state.mass, state.q.shape)
    return state.q[index], state.p[index], mass[index], state.log_weight[index]


def boltzmann_log_weights(
    state: EnsembleState,
    potential_energy: Array,
    temperature: Union[float, Array] = 1.0,
    constants: Constants = NATURAL,
) -> Array:
    """Log of the canonical ensemble weights ``exp(-H / (k_B T))``.

    This realises (in log space, which does not underflow) the reference's
    commented-out ``setWeights`` (ensemble.py:52-61) and eq. 1 of the
    reference's NotesOnParticleBasedHMC.pdf (microcanonical ensemble weights
    ``e^{-beta H_i} / sum_j e^{-beta H_j}``). Returns *normalised* log
    weights.
    """
    h = kinetic_energy(state.p, state.mass) + potential_energy
    lw = -h * constants.beta(temperature)
    return lw - jax.scipy.special.logsumexp(lw)
