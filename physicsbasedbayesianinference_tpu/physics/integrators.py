"""The N-body integrator zoo, as jitted scans.

Functional re-creation of the reference's legacy integrator collection
(reference samples/NBody/Integrators.py:15-407 and Integrators2B.py:12-201):
explicit Euler (IntegrateEE), Euler-Cromer/symplectic Euler (IntegrateEC),
explicit midpoint (IntegrateMV), leapfrog/velocity-Verlet (IntegrateLF),
position Verlet (IntegrateVerlet), Störmer-Verlet (IntegrateSV), Hermite
predictor-corrector (IntegrateHI), Runge-Kutta (IntegrateRK — broken in the
reference: it imports a nonexistent ``ode45`` module, Integrators.py:10;
fixed here as classical RK4), and implicit midpoint (IntegrateIMP, fsolve
in the reference; a fixed iteration count here — SPMD/jit-safe).

Design: each integrator is a *single-step* pure function

    step(accel_fn, x, v, dt) -> (x', v')           (x, v: [N, D])

with no internal time loop — the loop lives in :mod:`.simulate` as one
``lax.scan`` (whole trajectory = one XLA computation), and adaptive-dt
drivers re-invoke steps with new dt without recompiling. Schemes needing
the jerk (Hermite) take ``jerk_fn(x, v)`` too. All steps vmap cleanly over
a leading batch axis for ensembles of systems.
"""

from __future__ import annotations

from typing import Callable

import jax

Array = jax.Array
AccelFn = Callable[[Array], Array]           # x:[N,D] -> a:[N,D]
JerkFn = Callable[[Array, Array], Array]     # (x, v) -> da/dt


def explicit_euler(accel_fn: AccelFn, x, v, dt):
    """x += v dt; v += a(x) dt (reference IntegrateEE, Integrators.py:15-41).
    Non-symplectic: energy drifts linearly — kept as the negative control
    the reference's energy-drift plots use."""
    a = accel_fn(x)
    return x + dt * v, v + dt * a


def symplectic_euler(accel_fn: AccelFn, x, v, dt):
    """Euler-Cromer: v += a(x) dt, then x += v' dt (reference IntegrateEC,
    Integrators.py:44-68). First-order symplectic."""
    v = v + dt * accel_fn(x)
    return x + dt * v, v


def explicit_midpoint(accel_fn: AccelFn, x, v, dt):
    """Midpoint rule (reference IntegrateMV, Integrators.py:71-96):
    evaluate derivatives at the half-step Euler prediction."""
    xm = x + 0.5 * dt * v
    vm = v + 0.5 * dt * accel_fn(x)
    return x + dt * vm, v + dt * accel_fn(xm)


def velocity_verlet(accel_fn: AccelFn, x, v, dt):
    """Kick-drift-kick leapfrog (reference IntegrateLF, Integrators.py:99-127,
    and the HMC-layer 'Leapfrog', src/integrator.py:94-123)."""
    a = accel_fn(x)
    v = v + 0.5 * dt * a
    x = x + dt * v
    v = v + 0.5 * dt * accel_fn(x)
    return x, v


def position_verlet(accel_fn: AccelFn, x, v, dt):
    """Drift-kick-drift (reference IntegrateVerlet, Integrators.py:130-163)."""
    x = x + 0.5 * dt * v
    v = v + dt * accel_fn(x)
    x = x + 0.5 * dt * v
    return x, v


def stormer_verlet(accel_fn: AccelFn, x, v, dt):
    """One step of the reference's Störmer-Verlet (IntegrateSV,
    Integrators.py:166-187; two-step position recursion in
    src/integrator.py:126-165). In one-step form with exact velocity it is
    algebraically velocity-Verlet; the reference's backward-difference
    velocity recovery (integrator.py:162) is a 1st-order-in-p artifact we
    deliberately do not reproduce (SURVEY.md §7)."""
    return velocity_verlet(accel_fn, x, v, dt)


def rk4(accel_fn: AccelFn, x, v, dt):
    """Classical 4th-order Runge-Kutta on the (x, v) system — the working
    replacement for the reference's broken IntegrateRK
    (Integrators.py:373-384, imports missing ``ode45``)."""
    k1x, k1v = v, accel_fn(x)
    k2x, k2v = v + 0.5 * dt * k1v, accel_fn(x + 0.5 * dt * k1x)
    k3x, k3v = v + 0.5 * dt * k2v, accel_fn(x + 0.5 * dt * k2x)
    k4x, k4v = v + dt * k3v, accel_fn(x + dt * k3x)
    x = x + (dt / 6.0) * (k1x + 2 * k2x + 2 * k3x + k4x)
    v = v + (dt / 6.0) * (k1v + 2 * k2v + 2 * k3v + k4v)
    return x, v


def implicit_midpoint(accel_fn: AccelFn, x, v, dt, *, num_iters: int = 8):
    """Implicit midpoint rule, solved by fixed-point iteration (reference
    IntegrateIMP, Integrators.py:387-407, uses scipy fsolve — data-dependent
    iteration; a fixed ``num_iters`` Picard loop is jit/SPMD-safe and
    converges fast for dt below the stability limit). Symplectic and
    time-reversible."""
    def body(_, carry):
        x_next, v_next = carry
        a_mid = accel_fn(0.5 * (x + x_next))
        v_new = v + dt * a_mid
        x_new = x + dt * 0.5 * (v + v_new)
        return (x_new, v_new)

    return jax.lax.fori_loop(0, num_iters, body, (x, v))


def hermite(accel_fn: AccelFn, jerk_fn: JerkFn, x, v, dt, *,
            num_corrector_iters: int = 2):
    """4th-order Hermite predictor-corrector (reference IntegrateHI,
    Integrators.py:190-235): Taylor predict with jerk, then iterate the
    Makino-Aarseth Hermite corrector a fixed number of times. (The
    reference's corrector uses the opposite sign on the dt^2/12 jerk terms
    vs Makino & Aarseth 1992 — the standard signs are used here; SURVEY.md
    §7: behavioural spec = intent, not bug-for-bug.)"""
    a = accel_fn(x)
    j = jerk_fn(x, v)
    xp = x + dt * v + (dt**2 / 2.0) * a + (dt**3 / 6.0) * j
    vp = v + dt * a + (dt**2 / 2.0) * j

    def body(_, carry):
        xc, vc = carry
        ap = accel_fn(xc)
        jp = jerk_fn(xc, vc)
        vc = v + (dt / 2.0) * (a + ap) + (dt**2 / 12.0) * (j - jp)
        xc = x + (dt / 2.0) * (v + vc) + (dt**2 / 12.0) * (a - ap)
        return (xc, vc)

    return jax.lax.fori_loop(0, num_corrector_iters, body, (xp, vp))


# Dormand-Prince 5(4) tableau (the pair inside MATLAB's ode45 — the module
# the reference's IntegrateRK tried and failed to import, Integrators.py:10).
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
          187 / 2100, 1 / 40)


def rk45_step(accel_fn: AccelFn, x, v, dt):
    """One embedded Dormand-Prince 5(4) step on the joint (x, v) system.

    Returns ``(x5, v5, err_x, err_v)``: the 5th-order solution and the
    (5th - 4th)-order error estimate per component. This is the working
    ``ode45`` kernel the reference's ``IntegrateRK`` was written against
    (Integrators.py:373-384 imports a nonexistent ``ode45`` module); the
    adaptive accept/reject controller lives in
    :func:`..physics.simulate.simulate_rk45`.
    """
    kx, kv = [], []
    for row in _DP_A:
        xs = x + dt * sum(c * k for c, k in zip(row, kx))
        vs = v + dt * sum(c * k for c, k in zip(row, kv))
        kx.append(vs)
        kv.append(accel_fn(xs))
    x5 = x + dt * sum(b * k for b, k in zip(_DP_B5, kx))
    v5 = v + dt * sum(b * k for b, k in zip(_DP_B5, kv))
    err_x = dt * sum((b5 - b4) * k
                     for b5, b4, k in zip(_DP_B5, _DP_B4, kx))
    err_v = dt * sum((b5 - b4) * k
                     for b5, b4, k in zip(_DP_B5, _DP_B4, kv))
    return x5, v5, err_x, err_v


INTEGRATORS = {
    "explicit_euler": explicit_euler,
    "symplectic_euler": symplectic_euler,
    "explicit_midpoint": explicit_midpoint,
    "velocity_verlet": velocity_verlet,
    "leapfrog": velocity_verlet,
    "position_verlet": position_verlet,
    "stormer_verlet": stormer_verlet,
    "rk4": rk4,
    "implicit_midpoint": implicit_midpoint,
}

NEEDS_JERK = {"hermite": hermite}


def get_physics_integrator(name: str):
    if name in INTEGRATORS:
        return INTEGRATORS[name]
    if name in NEEDS_JERK:
        return NEEDS_JERK[name]
    raise ValueError(
        f"Invalid integration method {name!r}; available: "
        f"{sorted(INTEGRATORS) + sorted(NEEDS_JERK)}")
