"""Symplectic integrators as fused, batched `lax.scan` computations.

Redesign of the reference integrator layer (reference
src/integrator.py). The reference integrates one walker at a time with a
Python loop over steps, calling ``jax.grad`` once per walker per step
(integrator.py:105-123) — every call a separate host->XLA dispatch. Here the
whole trajectory of the whole ensemble is ONE XLA computation:

    lax.scan(step, (q[W,D], p[W,D], grad[W,D], U[W]), length=num_steps)

with the force evaluated batched over all walkers at once (one fusion
region per step, no host round-trips).

All integrators are *splitting methods*: a palindromic sequence of momentum
"kicks" (p -= c*dt*grad U) and position "drifts" (q += c*dt*p/m). A generic
builder turns a coefficient table into a scan body with gradient caching (a
gradient is recomputed only when a kick follows a drift), so adding an
integrator = adding a table. Provided:

  * ``leapfrog`` / ``velocity_verlet`` — the reference's "Leapfrog"
    (integrator.py:94-123 is velocity-Verlet despite its name), 1 force/step.
  * ``position_verlet`` — drift-kick-drift form, 1 force/step.
  * ``mclachlan`` — 2-stage minimal-error 2nd order (McLachlan 1995), 2
    forces/step; ~same error at ~2x the step size of leapfrog.
  * ``yoshida4`` — 4th order (Yoshida 1990), 3 forces/step; the reference's
    week plan and references/ point at higher-order symplectic schemes
    (arXiv:1608.07048 in PAPERS.md).
  * ``stormer_verlet`` — the reference's two-step position recursion
    (integrator.py:126-165) with its endpoint semantics, kept for parity
    studies (backward-difference momentum recovery, 1st-order accurate in p).

Deliberate fixes vs the reference (SURVEY.md §7 "reference bugs must not be
ported"): step counts are exact (the reference truncates
``int(finalTime/stepSize)``, integrator.py:51); nothing is mutated in place;
state is never aliased.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import jax

Array = jax.Array
# (q[W,D]) -> (U[W], gradU[W,D])
ValueAndGradFn = Callable[[Array], Tuple[Array, Array]]

_KICK = "K"
_DRIFT = "D"


def num_steps_for_time(final_time: float, step_size: float) -> int:
    """Number of steps covering [0, final_time] (rounded, >= 1).

    The reference truncates (``int(finalTime/stepSize)``, integrator.py:51),
    so e.g. finalTime=1.0, dt=0.0999 silently integrates 10% short; we round
    to nearest and never return 0.
    """
    return max(1, int(round(final_time / step_size)))


def make_splitting_integrator(stages: Sequence[Tuple[str, float]],
                              name: str = "splitting"):
    """Build an integrator from a kick/drift coefficient table.

    Args:
      stages: sequence of ("K", c) momentum kicks and ("D", c) position
        drifts; coefficients are in units of the step size and must sum to 1
        per kind (checked).

    Returns a function
      ``integrate(vg_fn, q, p, *, step_size, num_steps, inv_mass,
                  grad=None, potential_energy=None)
        -> (q, p, potential_energy, grad)``
    where ``step_size`` is a scalar or per-walker ``[W, 1]`` array (per-walker
    step-size jitter), ``num_steps`` is static, and ``grad``/``potential_energy``
    may carry cached values of ``vg_fn(q)`` to avoid a redundant evaluation.
    """
    stages = tuple((k, float(c)) for k, c in stages)
    for kind, _ in stages:
        if kind not in (_KICK, _DRIFT):
            raise ValueError(f"bad stage kind {kind!r}")
    for kind in (_KICK, _DRIFT):
        total = sum(c for k, c in stages if k == kind)
        if abs(total - 1.0) > 1e-12:
            raise ValueError(f"{name}: {kind} coefficients sum to {total}, not 1")

    ends_with_kick = stages[-1][0] == _KICK
    grad_evals = 0  # force evaluations per step (static bookkeeping)
    fresh = ends_with_kick  # freshness of grad at step entry, steady state
    for kind, _ in stages:
        if kind == _KICK and not fresh:
            grad_evals += 1
            fresh = True
        elif kind == _DRIFT:
            fresh = False

    def integrate(vg_fn: ValueAndGradFn, q: Array, p: Array, *,
                  step_size, num_steps: int, inv_mass,
                  grad: Array | None = None,
                  potential_energy: Array | None = None):
        dt = step_size
        if grad is None or potential_energy is None:
            potential_energy, grad = vg_fn(q)

        def step(carry, _):
            q, p, g, u = carry
            fresh = ends_with_kick
            for kind, c in stages:
                if kind == _KICK:
                    if not fresh:
                        u, g = vg_fn(q)
                        fresh = True
                    p = p - (c * dt) * g
                else:
                    q = q + (c * dt) * p * inv_mass
                    fresh = False
            if not fresh and ends_with_kick:
                raise AssertionError("unreachable")
            return (q, p, g, u), None

        (q, p, grad, potential_energy), _ = jax.lax.scan(
            step, (q, p, grad, potential_energy), None, length=num_steps)
        if not ends_with_kick:
            potential_energy, grad = vg_fn(q)
        return q, p, potential_energy, grad

    integrate.stages = stages  # type: ignore[attr-defined]
    integrate.grad_evals_per_step = max(grad_evals, 1)  # type: ignore[attr-defined]
    integrate.name = name  # type: ignore[attr-defined]
    return integrate


# -- coefficient tables ------------------------------------------------------

leapfrog = make_splitting_integrator(
    [(_KICK, 0.5), (_DRIFT, 1.0), (_KICK, 0.5)], name="leapfrog")
velocity_verlet = leapfrog  # the reference's "Leapfrog" (integrator.py:94)

position_verlet = make_splitting_integrator(
    [(_DRIFT, 0.5), (_KICK, 1.0), (_DRIFT, 0.5)], name="position_verlet")

# McLachlan (1995) 2-stage minimal-error 2nd-order scheme; see also
# Blanes/Casas/Sanz-Serna (arXiv:1608.07048, referenced in PAPERS.md).
_MCL_B = 0.1931833275037836
mclachlan = make_splitting_integrator(
    [(_KICK, _MCL_B), (_DRIFT, 0.5), (_KICK, 1.0 - 2.0 * _MCL_B),
     (_DRIFT, 0.5), (_KICK, _MCL_B)],
    name="mclachlan")

# Yoshida (1990) 4th-order: triple-jump composition of velocity-Verlet.
_Y_W1 = 1.0 / (2.0 - 2.0 ** (1.0 / 3.0))
_Y_W0 = 1.0 - 2.0 * _Y_W1
yoshida4 = make_splitting_integrator(
    [(_KICK, _Y_W1 / 2), (_DRIFT, _Y_W1), (_KICK, (_Y_W1 + _Y_W0) / 2),
     (_DRIFT, _Y_W0), (_KICK, (_Y_W0 + _Y_W1) / 2), (_DRIFT, _Y_W1),
     (_KICK, _Y_W1 / 2)],
    name="yoshida4")


def stormer_verlet(vg_fn: ValueAndGradFn, q: Array, p: Array, *,
                   step_size, num_steps: int, inv_mass,
                   grad: Array | None = None,
                   potential_energy: Array | None = None):
    """Two-step position-recursion Störmer-Verlet (reference

    integrator.py:126-165): q_{n+1} = 2 q_n - q_{n-1} + a(q_n) dt^2, with the
    final momentum recovered by a backward difference (reference
    integrator.py:162 — only 1st-order accurate in p; ``leapfrog`` produces
    the same positions with 2nd-order momenta and is preferred for HMC).
    Batched and scan-compiled like the splitting integrators.
    """
    dt = step_size
    if grad is None or potential_energy is None:
        potential_energy, grad = vg_fn(q)
    v = p * inv_mass
    q_prev = q
    q = q + v * dt + (0.5 * dt * dt) * (-grad * inv_mass)

    def step(carry, _):
        q_prev, q = carry
        _, g = vg_fn(q)
        q_next = 2.0 * q - q_prev + (dt * dt) * (-g * inv_mass)
        return (q, q_next), None

    (q_prev, q), _ = jax.lax.scan(step, (q_prev, q), None,
                                  length=max(num_steps - 1, 0))
    v = (q - q_prev) / dt
    p = v / inv_mass
    potential_energy, grad = vg_fn(q)
    return q, p, potential_energy, grad


stormer_verlet.grad_evals_per_step = 1  # type: ignore[attr-defined]
stormer_verlet.name = "stormer_verlet"  # type: ignore[attr-defined]


INTEGRATORS = {
    "leapfrog": leapfrog,
    "velocity_verlet": velocity_verlet,
    "position_verlet": position_verlet,
    "mclachlan": mclachlan,
    "yoshida4": yoshida4,
    "stormer_verlet": stormer_verlet,
}


def get_integrator(name: str):
    """Look up an integrator by name (reference HMC.py:62-71 dispatches

    "Leapfrog"/"Stormer-Verlet" and raises ValueError otherwise)."""
    try:
        return INTEGRATORS[name]
    except KeyError:
        raise ValueError(
            f"Invalid integration method {name!r}; "
            f"available: {sorted(INTEGRATORS)}") from None

