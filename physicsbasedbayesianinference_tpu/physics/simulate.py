"""Trajectory simulation drivers: fixed-step scans + adaptive timestepping.

Jitted replacement for the reference's per-step Python time loops
(reference samples/NBody/Integrators.py — every IntegrateXX function is
``for t in range(Ntot):`` around numpy math; NBody.py:52-66 wraps them with
wall-clock prints). Here the whole trajectory is ONE compiled program:

    lax.scan(save_block = lax.scan(step, ...), ...)

recording every ``save_every``-th state and the conserved-quantity
diagnostics on device, so an N-step million-body run costs one dispatch.

Adaptive timestepping (reference AdaptiveTimeSimple/AdaptiveTimeAdvanced,
MiscFunctions.py:178-243, used by IntegrateSVA/EEA/HIA,
Integrators.py:238-350) is a ``lax.while_loop`` with a static-size output
buffer — data-dependent step counts cannot change array shapes under XLA,
so the caller supplies ``max_steps`` and gets back a validity count.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..constants import Constants, NATURAL
from . import integrators as phyint
from .nbody import (
    NBodySystem,
    accelerations,
    jerk,
    total_angular_momentum,
    total_energy,
)
from ..utils import struct

Array = jax.Array


@struct.dataclass
class Trajectory:
    """Recorded simulation output. ``x``/``v``: [num_saves, N, D];
    ``times``/``energy``/``angular_momentum``: [num_saves];
    ``final``: the end state; ``num_valid``: saves actually filled
    (== num_saves for fixed-step runs; <= for adaptive runs)."""

    x: Array
    v: Array
    times: Array
    energy: Array
    angular_momentum: Array
    initial_energy: Array
    final: NBodySystem
    num_valid: Array


def _diag(system: NBodySystem, constants: Constants, softening: float):
    return (total_energy(system, constants=constants, softening=softening),
            total_angular_momentum(system))


@partial(jax.jit, static_argnames=(
    "method", "num_steps", "save_every", "softening", "constants"))
def simulate(
    system: NBodySystem,
    dt: float,
    num_steps: int,
    *,
    method: str = "velocity_verlet",
    save_every: int = 1,
    constants: Constants = NATURAL,
    softening: float = 0.0,
) -> Trajectory:
    """Integrate ``num_steps`` fixed steps, saving every ``save_every``-th
    state with on-device energy/angular-momentum diagnostics (the automated
    version of the reference's energy-drift plot oracles, NBody.py:68-77).

    ``num_steps`` must be divisible by ``save_every``.
    """
    if num_steps % save_every != 0:
        raise ValueError(
            f"num_steps={num_steps} not divisible by save_every={save_every}")
    step_fn = phyint.get_physics_integrator(method)
    accel = lambda x: _accel_of(system, x, constants, softening)
    needs_jerk = method in phyint.NEEDS_JERK
    if needs_jerk:
        jerk_fn = lambda x, v: jerk(
            x, v, system.mass, constants=constants, softening=softening)

    dt = jnp.asarray(dt, dtype=system.x.dtype)

    def one_step(carry, _):
        x, v, t = carry
        if needs_jerk:
            x, v = step_fn(accel, jerk_fn, x, v, dt)
        else:
            x, v = step_fn(accel, x, v, dt)
        return (x, v, t + dt), None

    def save_block(carry, _):
        carry, _ = jax.lax.scan(one_step, carry, None, length=save_every)
        x, v, t = carry
        sys_t = system.replace(x=x, v=v, time=t)
        e, l = _diag(sys_t, constants, softening)
        return carry, (x, v, t, e, l)

    num_saves = num_steps // save_every
    e0, _ = _diag(system, constants, softening)
    (x, v, t), (xs, vs, ts, es, ls) = jax.lax.scan(
        save_block, (system.x, system.v, system.time), None,
        length=num_saves)
    final = system.replace(x=x, v=v, time=t)
    return Trajectory(x=xs, v=vs, times=ts, energy=es, angular_momentum=ls,
                      initial_energy=e0, final=final,
                      num_valid=jnp.asarray(num_saves))


def _accel_of(system, x, constants, softening):
    return accelerations(
        system.replace(x=x), constants=constants, softening=softening)


# ---------------------------------------------------------------------------
# Adaptive timestep criteria (reference MiscFunctions.py:178-243)
# ---------------------------------------------------------------------------


def adaptive_dt_simple(system: NBodySystem, dt0, *,
                       constants: Constants = NATURAL,
                       softening: float = 0.0) -> Array:
    """Aarseth-style criterion: dt = dt0 * min_i |a_i| / |da_i/dt|
    (reference ``AdaptiveTimeSimple``, MiscFunctions.py:178-204), fully
    on-device (the reference prints dtmin host-side every step)."""
    a = accelerations(system, constants=constants, softening=softening)
    da = jerk(system.x, system.v, system.mass,
              constants=constants, softening=softening)
    a_nrm = jnp.sqrt(jnp.sum(a * a, axis=-1))
    da_nrm = jnp.sqrt(jnp.sum(da * da, axis=-1)) + 1e-300
    return dt0 * jnp.min(a_nrm / da_nrm, axis=-1)


def adaptive_dt_advanced(system: NBodySystem, dt0, *,
                         constants: Constants = NATURAL,
                         softening: float = 0.0) -> Array:
    """Higher-derivative criterion (reference ``AdaptiveTimeAdvanced``,
    MiscFunctions.py:210-243): estimate the 2nd/3rd acceleration
    derivatives from a dt0 Taylor prediction and take
    dt = dt0 * min_i sqrt( (|a||a2| + |da|^2) / (|da||a3| + |a2|^2) )."""
    x, v, m = system.x, system.v, system.mass
    dt0 = jnp.asarray(dt0, dtype=x.dtype)
    a = accelerations(system, constants=constants, softening=softening)
    da = jerk(x, v, m, constants=constants, softening=softening)
    vp = v + dt0 * a + 0.5 * dt0**2 * da
    xp = x + dt0 * v + 0.5 * dt0**2 * a + (dt0**3 / 6.0) * da
    ap = accelerations(system.replace(x=xp), constants=constants,
                       softening=softening)
    dap = jerk(xp, vp, m, constants=constants, softening=softening)
    a2 = -6.0 * (a - ap) / dt0**2 - 2.0 * (2.0 * da + dap) / dt0
    a3 = 12.0 * (a - ap) / dt0**3 + 6.0 * (da + dap) / dt0**2
    nrm = lambda z: jnp.sqrt(jnp.sum(z * z, axis=-1))
    val = ((nrm(a) * nrm(a2) + jnp.sum(da * da, axis=-1))
           / (nrm(da) * nrm(a3) + jnp.sum(a2 * a2, axis=-1) + 1e-300))
    return dt0 * jnp.min(jnp.sqrt(val), axis=-1)


@partial(jax.jit, static_argnames=(
    "method", "max_steps", "criterion", "softening", "constants"))
def simulate_adaptive(
    system: NBodySystem,
    dt0: float,
    final_time: float,
    *,
    method: str = "velocity_verlet",
    criterion: str = "simple",
    max_steps: int = 10_000,
    constants: Constants = NATURAL,
    softening: float = 0.0,
) -> Trajectory:
    """Adaptive-dt integration to ``final_time`` (the reference's
    IntegrateSVA/EEA/HIA loops, Integrators.py:238-350): each step re-derives
    dt from the chosen criterion, clipped to not overshoot final_time.
    Static ``max_steps`` bounds the output buffer; ``num_valid`` reports how
    many entries are real. Saves every accepted step."""
    raw_step = phyint.get_physics_integrator(method)
    crit = {"simple": adaptive_dt_simple,
            "advanced": adaptive_dt_advanced}[criterion]
    accel = lambda x: _accel_of(system, x, constants, softening)
    if method in phyint.NEEDS_JERK:
        # adaptive Hermite (reference ``IntegrateHIA``,
        # samples/NBody/Integrators.py:320-350): the jerk the step needs is
        # the same quantity the dt criteria already evaluate
        jerk_fn = lambda x, v: jerk(
            x, v, system.mass, constants=constants, softening=softening)
        step_fn = lambda a, x, v, dt: raw_step(a, jerk_fn, x, v, dt)
    else:
        step_fn = raw_step
    dtype = system.x.dtype
    final_time = jnp.asarray(final_time, dtype=dtype)

    xs = jnp.zeros((max_steps,) + system.x.shape, dtype)
    vs = jnp.zeros_like(xs)
    ts = jnp.zeros((max_steps,), dtype)
    es = jnp.zeros((max_steps,), dtype)
    ls = jnp.zeros((max_steps,), dtype)

    def cond(carry):
        x, v, t, i, *_ = carry
        return (t < final_time) & (i < max_steps)

    def body(carry):
        x, v, t, i, xs, vs, ts, es, ls = carry
        sys_t = system.replace(x=x, v=v, time=t)
        dt = crit(sys_t, dt0, constants=constants, softening=softening)
        dt = jnp.minimum(dt, final_time - t)
        x, v = step_fn(accel, x, v, dt)
        t = t + dt
        sys_n = system.replace(x=x, v=v, time=t)
        e, l = _diag(sys_n, constants, softening)
        xs = xs.at[i].set(x)
        vs = vs.at[i].set(v)
        ts = ts.at[i].set(t)
        es = es.at[i].set(e)
        ls = ls.at[i].set(l)
        return (x, v, t, i + 1, xs, vs, ts, es, ls)

    e0, _ = _diag(system, constants, softening)
    x, v, t, i, xs, vs, ts, es, ls = jax.lax.while_loop(
        cond, body,
        (system.x, system.v, system.time, jnp.asarray(0), xs, vs, ts, es, ls))
    final = system.replace(x=x, v=v, time=t)
    return Trajectory(x=xs, v=vs, times=ts, energy=es, angular_momentum=ls,
                      initial_energy=e0, final=final, num_valid=i)


@partial(jax.jit, static_argnames=(
    "max_steps", "softening", "constants"))
def simulate_rk45(
    system: NBodySystem,
    dt0: float,
    final_time: float,
    *,
    rtol: float = 1e-6,
    atol: float = 1e-9,
    max_steps: int = 10_000,
    constants: Constants = NATURAL,
    softening: float = 0.0,
) -> Trajectory:
    """Error-controlled Dormand-Prince 5(4) integration to ``final_time`` —
    the working ``ode45`` the reference's ``IntegrateRK`` was written against
    (Integrators.py:10,373-384; the import is broken there). Standard
    controller: scaled RMS error norm over (x, v), accept when <= 1,
    dt *= clip(0.9 * err^{-1/5}, 0.2, 5.0); rejected steps retry with the
    shrunk dt and do not advance time or consume an output slot."""
    accel = lambda x: _accel_of(system, x, constants, softening)
    dtype = system.x.dtype
    final_time = jnp.asarray(final_time, dtype=dtype)

    xs = jnp.zeros((max_steps,) + system.x.shape, dtype)
    vs = jnp.zeros_like(xs)
    ts = jnp.zeros((max_steps,), dtype)
    es = jnp.zeros((max_steps,), dtype)
    ls = jnp.zeros((max_steps,), dtype)

    def err_norm(err, ref_a, ref_b):
        scale = atol + rtol * jnp.maximum(jnp.abs(ref_a), jnp.abs(ref_b))
        return jnp.sqrt(jnp.mean((err / scale) ** 2))

    def cond(carry):
        t, dt, i, tries, *_ = carry
        return (t < final_time) & (i < max_steps) & (tries < 8 * max_steps)

    def body(carry):
        t, dt, i, tries, x, v, xs, vs, ts, es, ls = carry
        dt_c = jnp.minimum(dt, final_time - t)
        xn, vn, err_x, err_v = phyint.rk45_step(accel, x, v, dt_c)
        err = jnp.maximum(err_norm(err_x, x, xn), err_norm(err_v, v, vn))
        accept = err <= 1.0
        factor = jnp.clip(0.9 * (err + 1e-30) ** -0.2, 0.2, 5.0)
        dt = dt_c * factor
        x = jnp.where(accept, xn, x)
        v = jnp.where(accept, vn, v)
        t = jnp.where(accept, t + dt_c, t)
        sys_n = system.replace(x=x, v=v, time=t)
        e, l = _diag(sys_n, constants, softening)
        slot = jnp.where(accept, i, max_steps - 1)  # dummy slot on reject
        xs = jnp.where(accept, xs.at[slot].set(x), xs)
        vs = jnp.where(accept, vs.at[slot].set(v), vs)
        ts = jnp.where(accept, ts.at[slot].set(t), ts)
        es = jnp.where(accept, es.at[slot].set(e), es)
        ls = jnp.where(accept, ls.at[slot].set(l), ls)
        return (t, dt, i + accept.astype(i.dtype), tries + 1,
                x, v, xs, vs, ts, es, ls)

    e0, _ = _diag(system, constants, softening)
    t, dt, i, _, x, v, xs, vs, ts, es, ls = jax.lax.while_loop(
        cond, body,
        (system.time, jnp.asarray(dt0, dtype), jnp.asarray(0),
         jnp.asarray(0), system.x, system.v, xs, vs, ts, es, ls))
    final = system.replace(x=x, v=v, time=t)
    return Trajectory(x=xs, v=vs, times=ts, energy=es, angular_momentum=ls,
                      initial_energy=e0, final=final, num_valid=i)


def energy_drift(traj: Trajectory) -> Array:
    """|E_t - E_0| / |E_0| over saved states, relative to the energy of the
    *initial* state — the reference's correctness oracle rendered as
    numbers instead of log plots (NBody.py:68-77)."""
    e0 = traj.initial_energy
    return jnp.abs(traj.energy - e0) / jnp.abs(e0)
