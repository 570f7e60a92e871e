"""No-U-Turn Sampler: iterative, jittable, vmapped over the ensemble.

The reference specifies NUTS as the planned sampler upgrade — its algorithm
notes give the U-turn criterion ``(x_new - x) . p < 0`` and dual averaging
(reference references/NotesOnParticleBasedHMC.pdf, eqs. 5-6), the
Hoffman-Gelman paper is checked into references/, and the NumPyro examples
run NUTS as the oracle (samples/NumpyroExamples/CoinTossExample.py:35-44).
Nothing of it was implemented. This module supplies it, ensemble-native:

* **Iterative tree building** (the checkpoint/stack formulation of
  Phan & Pradhan's iterative NUTS): a doubling tree of leapfrog steps with
  per-subtree U-turn checks done by storing O(max_depth) left-endpoint
  states in fixed slots — no recursion, no dynamic shapes, compiles to two
  nested ``lax.while_loop``s with a static trip bound of ``2^max_depth``
  leapfrog steps.
* **Multinomial progressive sampling** along the trajectory (the modern
  replacement for the original slice sampler): each visited state is
  reservoir-sampled with weight ``exp(-beta (H - H0))``.
* **SPMD over walkers**: one walker's transition is pure; ``vmap`` runs the
  whole ensemble, each walker stopping at its own depth (masked iterations
  — the wasted-FLOPs-for-static-shapes tradeoff SURVEY.md §7 calls out).
* Physical-constants semantics match :mod:`.hmc`: momenta are
  Maxwell-Boltzmann at temperature T, weights use beta = 1/(k_B T).

Diagnostics follow :class:`~.hmc.HMCInfo` so the dual-averaging warmup in
:func:`~.hmc.run_hmc` applies unchanged (``run_nuts`` below drives it).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import jax
import jax.numpy as jnp

from .adaptation import build_warmup_schedule, da_init, da_update, \
    variance_init, variance_update, regularized_mass
from .constants import Constants, NATURAL
from .ensemble import EnsembleState, thermal_momentum_std
from .hmc import HMCState
from .utils import struct

Array = jax.Array


@struct.dataclass
class NUTSInfo:
    """Per-transition diagnostics (per walker)."""

    accept_prob: Array      # [W] mean Metropolis stat over visited leaves
    depth: Array            # [W] tree depth reached
    num_leapfrogs: Array    # [W] leapfrog steps taken
    divergent: Array        # [W] bool
    turned: Array           # [W] bool (stopped by U-turn, not max_depth)
    potential_energy: Array  # [W]
    step_size: Array        # scalar


def _uturn(q_left, p_left, q_right, p_right, inv_mass):
    """Original Hoffman-Gelman criterion on the subtree endpoints
    (the reference notes' eq. 5), with inverse-mass-weighted momenta."""
    dq = q_right - q_left
    return ((jnp.dot(dq, p_left * inv_mass) < 0.0)
            | (jnp.dot(dq, p_right * inv_mass) < 0.0))


def _ctz(i: Array) -> Array:
    """Count trailing zeros of a positive int32."""
    lowbit = jnp.bitwise_and(i, -i)
    return jax.lax.population_count(lowbit - 1)


@dataclasses.dataclass(frozen=True)
class NUTSKernel:
    """A built NUTS transition kernel (static config closed over)."""

    init: Callable
    step: Callable
    max_depth: int


def _build_lockstep_nuts_kernel(
    potential_fn: Callable[[Array], Array],
    *,
    max_depth: int,
    temperature: Union[float, Array],
    constants: Constants,
    divergence_threshold: float,
):
    """Walker-lockstep iterative NUTS (see :func:`build_nuts_kernel`).

    Every leapfrog is ONE batched [W, D] update through the shared
    ``batched_value_and_grad``; the iterative checkpoint stack lives as
    ``[slots, W, D]`` with a SCALAR pointer (all walkers share the leaf
    counter), so stores are one dynamic-update-slice and U-turn checks
    are scalar-indexed slices + batched reductions — no per-walker
    gather/scatter anywhere. Per-walker randomness (direction signs,
    reservoir draws) and stopping (turned/divergent masks) stay
    elementwise. Walkers that stop simply freeze while the ensemble
    finishes — the wasted-FLOPs-for-static-shapes tradeoff SURVEY.md §7
    accepts, now bounded by the ensemble-max tree rather than paid
    per-walker.
    """
    from .ops.potentials import batched_value_and_grad

    beta = constants.beta(temperature)
    vg = batched_value_and_grad(potential_fn)
    num_slots = max_depth + 1  # + scratch slot appended below

    def init(q: Array, *, mass: Union[float, Array] = 1.0) -> HMCState:
        q = jnp.asarray(q)
        if q.ndim != 2:
            raise ValueError(
                f"init positions must be [num_walkers, num_dims]; got "
                f"{q.shape}")
        u, g = vg(q)
        ens = EnsembleState(
            q=q, p=jnp.zeros_like(q),
            mass=jnp.asarray(mass, dtype=q.dtype),
            log_weight=jnp.zeros(q.shape[:1], dtype=q.dtype))
        return HMCState(ensemble=ens, potential_energy=u, grad=g)

    def step(key: Array, state: HMCState, step_size: Array,
             mass: Optional[Array] = None):
        ens = state.ensemble
        if mass is None:
            mass = ens.mass
        w, d = ens.q.shape
        dtype = ens.q.dtype
        inv_mass = 1.0 / jnp.broadcast_to(
            jnp.asarray(mass, dtype), (1, d))
        eps = jnp.asarray(step_size, dtype)
        neg_inf = jnp.asarray(-jnp.inf, dtype)

        key_mom, key_loop = jax.random.split(key)
        p_std = thermal_momentum_std(mass, temperature, constants)
        p0 = p_std * jax.random.normal(key_mom, ens.q.shape, dtype)
        q0, u0, g0 = ens.q, state.potential_energy, state.grad

        def ke(p):
            return 0.5 * jnp.sum(p * p * inv_mass, axis=-1)

        h0 = ke(p0) + u0  # [W]

        def subtree(key, depth, q_e, p_e, g_e, dirn, act):
            """One doubling subtree of up to 2^depth leaves, lockstep."""
            n_leaves = jnp.asarray(1, jnp.int32) << depth
            ckpt_q = jnp.zeros((num_slots + 1, w, d), dtype)
            ckpt_p = jnp.zeros((num_slots + 1, w, d), dtype)

            def cond(c):
                return (c["i"] < n_leaves) & jnp.any(c["alive"])

            def body(c):
                i = c["i"]
                key, k_take = jax.random.split(c["key"])
                alive = c["alive"]
                dt = dirn * eps

                p_half = c["p"] - 0.5 * dt * c["g"]
                q_new = c["q"] + dt * p_half * inv_mass
                u_new, g_new = vg(q_new)
                p_new = p_half - 0.5 * dt * g_new

                derr = beta * (ke(p_new) + u_new - h0)
                derr = jnp.where(jnp.isfinite(derr), derr, jnp.inf)
                div_leaf = alive & (derr > divergence_threshold)
                sum_acc = c["sum_acc"] + jnp.where(
                    alive, jnp.exp(jnp.minimum(0.0, -derr)), 0.0)
                logw_leaf = jnp.where(alive & ~div_leaf, -derr, neg_inf)

                logw_new = jnp.logaddexp(c["logw"], logw_leaf)
                take = alive & (jnp.log(jax.random.uniform(
                    k_take, (w,), dtype=dtype,
                    minval=jnp.finfo(dtype).tiny))
                    < logw_leaf - logw_new)
                sel = take[:, None]
                prop_q = jnp.where(sel, q_new, c["prop_q"])
                prop_u = jnp.where(take, u_new, c["prop_u"])
                prop_g = jnp.where(sel, g_new, c["prop_g"])

                # checkpoint store: scalar slot (scratch on odd leaves)
                even = (i % 2) == 0
                ptr = c["ptr"]
                slot = jnp.where(even, ptr, num_slots)
                ckpt_q = jax.lax.dynamic_update_slice(
                    c["ckpt_q"], q_new[None], (slot, 0, 0))
                ckpt_p = jax.lax.dynamic_update_slice(
                    c["ckpt_p"], p_new[None], (slot, 0, 0))

                # sub-U-turn checks against the m stacked left endpoints
                # (iterative NUTS invariant: m = trailing ones of i+1);
                # traced-bound fori -> only ~1 check per odd leaf on avg
                m = jnp.where(even, 0, _ctz(i + 1))

                def check(j, turned_acc):
                    cq = jax.lax.dynamic_slice(
                        ckpt_q, (ptr - j, 0, 0), (1, w, d))[0]
                    cp = jax.lax.dynamic_slice(
                        ckpt_p, (ptr - j, 0, 0), (1, w, d))[0]
                    dq = dirn * (q_new - cq)
                    t = ((jnp.sum(dq * cp * inv_mass, -1) < 0.0)
                         | (jnp.sum(dq * p_new * inv_mass, -1) < 0.0))
                    return turned_acc | (alive & t)

                turned = jax.lax.fori_loop(1, m + 1, check, c["turned"])
                ptr = jnp.where(even, ptr + 1, ptr - (m - 1))

                alive = alive & ~div_leaf & ~turned
                upd = c["alive"][:, None]  # walkers active THIS leaf move
                return {
                    "i": i + 1, "key": key, "ptr": ptr,
                    "q": jnp.where(upd, q_new, c["q"]),
                    "p": jnp.where(upd, p_new, c["p"]),
                    "g": jnp.where(upd, g_new, c["g"]),
                    "u": jnp.where(c["alive"], u_new, c["u"]),
                    "logw": logw_new,
                    "prop_q": prop_q, "prop_u": prop_u, "prop_g": prop_g,
                    "ckpt_q": ckpt_q, "ckpt_p": ckpt_p,
                    "turned": turned, "div": c["div"] | div_leaf,
                    "sum_acc": sum_acc,
                    "n_leap": c["n_leap"] + c["alive"].astype(jnp.int32),
                    "alive": alive,
                }

            out = jax.lax.while_loop(cond, body, {
                "i": jnp.asarray(0, jnp.int32), "key": key,
                "ptr": jnp.asarray(0, jnp.int32),
                "q": q_e, "p": p_e, "g": g_e,
                "u": jnp.zeros((w,), dtype),
                "logw": jnp.full((w,), neg_inf, dtype),
                "prop_q": q_e, "prop_u": jnp.zeros((w,), dtype),
                "prop_g": g_e,
                "ckpt_q": ckpt_q, "ckpt_p": ckpt_p,
                "turned": jnp.zeros((w,), bool),
                "div": jnp.zeros((w,), bool),
                "sum_acc": jnp.zeros((w,), dtype),
                "n_leap": jnp.zeros((w,), jnp.int32),
                "alive": act,
            })
            return out

        def outer_cond(c):
            return (c["depth"] < max_depth) & jnp.any(~c["turned"]
                                                      & ~c["div"])

        def outer_body(c):
            key, k_dir, k_sub, k_merge = jax.random.split(c["key"], 4)
            act = ~c["turned"] & ~c["div"]
            go_right = jax.random.bernoulli(k_dir, shape=(w,))
            dirn = jnp.where(go_right, 1.0, -1.0).astype(dtype)[:, None]
            gr = go_right[:, None]
            q_e = jnp.where(gr, c["qR"], c["qL"])
            p_e = jnp.where(gr, c["pR"], c["pL"])
            g_e = jnp.where(gr, c["gR"], c["gL"])

            sub = subtree(k_sub, c["depth"], q_e, p_e, g_e, dirn, act)
            ok = act & ~sub["turned"] & ~sub["div"]

            logw_tree = jnp.logaddexp(c["logw"], sub["logw"])
            p_take = jnp.exp(sub["logw"] - logw_tree)
            take = ok & (jax.random.uniform(k_merge, (w,), dtype=dtype)
                         < p_take)
            sel = take[:, None]
            prop_q = jnp.where(sel, sub["prop_q"], c["prop_q"])
            prop_u = jnp.where(take, sub["prop_u"], c["prop_u"])
            prop_g = jnp.where(sel, sub["prop_g"], c["prop_g"])
            logw = jnp.where(ok, logw_tree, c["logw"])

            okc = ok[:, None]
            qL = jnp.where(okc & ~gr, sub["q"], c["qL"])
            pL = jnp.where(okc & ~gr, sub["p"], c["pL"])
            gL = jnp.where(okc & ~gr, sub["g"], c["gL"])
            qR = jnp.where(okc & gr, sub["q"], c["qR"])
            pR = jnp.where(okc & gr, sub["p"], c["pR"])
            gR = jnp.where(okc & gr, sub["g"], c["gR"])

            dq = qR - qL
            turned_full = ((jnp.sum(dq * pL * inv_mass, -1) < 0.0)
                           | (jnp.sum(dq * pR * inv_mass, -1) < 0.0))
            return {
                "key": key, "depth": c["depth"] + 1,
                "qL": qL, "pL": pL, "gL": gL,
                "qR": qR, "pR": pR, "gR": gR,
                "prop_q": prop_q, "prop_u": prop_u, "prop_g": prop_g,
                "logw": logw,
                "turned": c["turned"] | (act & sub["turned"])
                | (ok & turned_full),
                "div": c["div"] | (act & sub["div"]),
                "sum_acc": c["sum_acc"] + sub["sum_acc"],
                "n_leap": c["n_leap"] + sub["n_leap"],
                "depth_r": jnp.where(act, c["depth"] + 1, c["depth_r"]),
            }

        out = jax.lax.while_loop(outer_cond, outer_body, {
            "key": key_loop, "depth": jnp.asarray(0, jnp.int32),
            "qL": q0, "pL": p0, "gL": g0, "qR": q0, "pR": p0, "gR": g0,
            "prop_q": q0, "prop_u": u0, "prop_g": g0,
            "logw": jnp.zeros((w,), dtype),
            "turned": jnp.zeros((w,), bool),
            "div": jnp.zeros((w,), bool),
            "sum_acc": jnp.zeros((w,), dtype),
            "n_leap": jnp.zeros((w,), jnp.int32),
            "depth_r": jnp.zeros((w,), jnp.int32),
        })

        n = jnp.maximum(out["n_leap"], 1).astype(dtype)
        new_state = HMCState(
            ensemble=ens.replace(q=out["prop_q"], mass=mass),
            potential_energy=out["prop_u"], grad=out["prop_g"])
        info = NUTSInfo(
            accept_prob=out["sum_acc"] / n,
            depth=out["depth_r"],
            num_leapfrogs=out["n_leap"],
            divergent=out["div"], turned=out["turned"],
            potential_energy=out["prop_u"],
            step_size=jnp.asarray(step_size))
        return new_state, info

    return NUTSKernel(init=init, step=step, max_depth=max_depth)


def build_nuts_kernel(
    potential_fn: Callable[[Array], Array],
    *,
    max_depth: int = 8,
    temperature: Union[float, Array] = 1.0,
    constants: Constants = NATURAL,
    divergence_threshold: float = 1000.0,
    engine: str = "lockstep",
):
    """Build a NUTS transition kernel with the same state/step interface as
    :func:`~.hmc.build_hmc_kernel` (init -> HMCState; step(key, state,
    step_size) -> (HMCState, NUTSInfo)).

    ``engine="lockstep"`` (default) is the ENSEMBLE-NATIVE formulation:
    all walkers advance one leapfrog per
    iteration as a single [W, D]-batched update, and — the key
    structural fact — the iterative algorithm's checkpoint-stack pointer
    and leaf index are deterministic functions of the (shared) leaf
    counter, so ALL control flow and stack indexing is SCALAR; only the
    per-walker direction signs, stopping flags, and proposals vary, and
    they vary elementwise. The per-walker-vmap formulation
    (``engine="vmap"``, the r2-r4 implementation) turned the stack into
    [W, slots, D] gather/scatter per leapfrog and ran ~740x slower than
    ChEES (benchmarks/sampler_cost.py measures the engines side by
    side).
    """
    beta = constants.beta(temperature)
    value_and_grad = jax.value_and_grad(potential_fn)

    if engine not in ("lockstep", "vmap"):
        raise ValueError(f"bad engine={engine!r} (want lockstep|vmap)")
    if engine == "lockstep":
        return _build_lockstep_nuts_kernel(
            potential_fn, max_depth=max_depth, temperature=temperature,
            constants=constants,
            divergence_threshold=divergence_threshold)

    def single_walker_step(key, q0, u0, g0, step_size, mass):
        """One NUTS transition for one walker (q0: [D])."""
        inv_mass = 1.0 / mass
        key_mom, key_dirs = jax.random.split(key)
        p_std = thermal_momentum_std(mass, temperature, constants)
        p0 = p_std * jax.random.normal(key_mom, q0.shape, dtype=q0.dtype)
        h0 = 0.5 * jnp.sum(p0 * p0 * inv_mass) + u0

        def leapfrog(q, p, g, direction):
            dt = direction * step_size
            p = p - 0.5 * dt * g
            q = q + dt * p * inv_mass
            u, g = value_and_grad(q)
            p = p - 0.5 * dt * g
            return q, p, u, g

        num_slots = max_depth + 1
        d = q0.shape[0]

        # ---- one subtree of 2^depth leaves built leaf-by-leaf ------------
        def build_subtree(key, depth, q_edge, p_edge, g_edge, direction):
            """Returns (q_edge', p_edge', g_edge', proposal(q,u,g),
            logw_subtree, turned, divergent, sum_accept, n_leaves)."""
            ckpt_q = jnp.zeros((num_slots, d), q0.dtype)
            ckpt_p = jnp.zeros((num_slots, d), q0.dtype)
            n_leaves = jnp.asarray(1, jnp.int32) << depth

            def cond(c):
                i = c["i"]
                return (i < n_leaves) & ~c["turned"] & ~c["div"]

            def body(c):
                i = c["i"]
                key = c["key"]
                q, p, u, g = leapfrog(c["q"], c["p"], c["g"], direction)
                h = 0.5 * jnp.sum(p * p * inv_mass) + u
                energy_error = beta * (h - h0)
                energy_error = jnp.where(~jnp.isfinite(energy_error), jnp.inf,
                                         energy_error)
                div = energy_error > divergence_threshold
                logw_leaf = -energy_error
                # Metropolis stat for dual averaging (Stan's accept_stat)
                sum_acc = c["sum_acc"] + jnp.exp(
                    jnp.minimum(0.0, logw_leaf))

                # reservoir multinomial proposal within the subtree
                logw_new = jnp.logaddexp(c["logw"], logw_leaf)
                key, k_take = jax.random.split(key)
                take = (jnp.log(jax.random.uniform(k_take, (),
                                                   dtype=q0.dtype))
                        < logw_leaf - logw_new)
                prop_q = jnp.where(take, q, c["prop_q"])
                prop_u = jnp.where(take, u, c["prop_u"])
                prop_g = jnp.where(take, g, c["prop_g"])

                # checkpoint stack: push at even leaves, check at odd ones
                even = (i % 2) == 0
                ptr = c["ptr"]
                ckpt_q = jnp.where(even,
                                   c["ckpt_q"].at[ptr].set(q), c["ckpt_q"])
                ckpt_p = jnp.where(even,
                                   c["ckpt_p"].at[ptr].set(p), c["ckpt_p"])
                ptr = jnp.where(even, ptr + 1, ptr)

                m = _ctz(i + 1)  # trailing ones of odd i

                def check(j, turned):
                    # j = 1..m -> stored slot ptr - j
                    slot = ptr - j
                    valid = j <= m
                    qL = ckpt_q[slot]
                    pL = ckpt_p[slot]
                    t = jax.lax.cond(
                        direction > 0,
                        lambda: _uturn(qL, pL, q, p, inv_mass),
                        lambda: _uturn(q, p, qL, pL, inv_mass))
                    return turned | (valid & t)

                turned = jnp.where(
                    even, c["turned"],
                    jax.lax.fori_loop(1, num_slots, check, c["turned"]))
                ptr = jnp.where(even, ptr, ptr - (m - 1))

                return {
                    "i": i + 1, "key": key, "q": q, "p": p, "g": g, "u": u,
                    "logw": logw_new, "prop_q": prop_q, "prop_u": prop_u,
                    "prop_g": prop_g, "ckpt_q": ckpt_q, "ckpt_p": ckpt_p,
                    "ptr": ptr, "turned": turned, "div": div,
                    "sum_acc": sum_acc,
                }

            init = {
                "i": jnp.asarray(0, jnp.int32), "key": key,
                "q": q_edge, "p": p_edge, "g": g_edge,
                "u": jnp.asarray(0.0, q0.dtype),
                "logw": jnp.asarray(-jnp.inf, q0.dtype),
                "prop_q": q_edge, "prop_u": jnp.asarray(0.0, q0.dtype),
                "prop_g": g_edge,
                "ckpt_q": ckpt_q, "ckpt_p": ckpt_p,
                "ptr": jnp.asarray(0, jnp.int32),
                "turned": jnp.asarray(False), "div": jnp.asarray(False),
                "sum_acc": jnp.asarray(0.0, q0.dtype),
            }
            out = jax.lax.while_loop(cond, body, init)
            return out

        # ---- outer doubling loop ----------------------------------------
        def cond(c):
            return ((c["depth"] < max_depth)
                    & ~c["turned"] & ~c["div"])

        def body(c):
            key, k_dir, k_sub, k_merge = jax.random.split(c["key"], 4)
            direction = jnp.where(
                jax.random.bernoulli(k_dir), 1.0, -1.0).astype(q0.dtype)
            go_right = direction > 0
            q_edge = jnp.where(go_right, c["qR"], c["qL"])
            p_edge = jnp.where(go_right, c["pR"], c["pL"])
            g_edge = jnp.where(go_right, c["gR"], c["gL"])

            sub = build_subtree(k_sub, c["depth"], q_edge, p_edge, g_edge,
                                direction)
            ok = ~sub["turned"] & ~sub["div"]

            # merge proposal with multinomial-progressive probability
            logw_tree = jnp.logaddexp(c["logw"], sub["logw"])
            p_take = jnp.exp(sub["logw"] - logw_tree)
            take = ok & (jax.random.uniform(k_merge, (), dtype=q0.dtype)
                         < p_take)
            prop_q = jnp.where(take, sub["prop_q"], c["prop_q"])
            prop_u = jnp.where(take, sub["prop_u"], c["prop_u"])
            prop_g = jnp.where(take, sub["prop_g"], c["prop_g"])
            logw = jnp.where(ok, logw_tree, c["logw"])

            # extend the proper edge (even if subtree failed, its leapfrog
            # count contributes to the work diagnostic)
            qL = jnp.where(go_right, c["qL"], jnp.where(ok, sub["q"], c["qL"]))
            pL = jnp.where(go_right, c["pL"], jnp.where(ok, sub["p"], c["pL"]))
            gL = jnp.where(go_right, c["gL"], jnp.where(ok, sub["g"], c["gL"]))
            qR = jnp.where(go_right, jnp.where(ok, sub["q"], c["qR"]), c["qR"])
            pR = jnp.where(go_right, jnp.where(ok, sub["p"], c["pR"]), c["pR"])
            gR = jnp.where(go_right, jnp.where(ok, sub["g"], c["gR"]), c["gR"])

            turned_full = _uturn(qL, pL, qR, pR, inv_mass)
            return {
                "key": key, "depth": c["depth"] + 1,
                "qL": qL, "pL": pL, "gL": gL, "qR": qR, "pR": pR, "gR": gR,
                "prop_q": prop_q, "prop_u": prop_u, "prop_g": prop_g,
                "logw": logw,
                "turned": sub["turned"] | (ok & turned_full),
                "div": sub["div"],
                "sum_acc": c["sum_acc"] + sub["sum_acc"],
                "n_leap": c["n_leap"] + sub["i"],
            }

        init = {
            "key": key_dirs, "depth": jnp.asarray(0, jnp.int32),
            "qL": q0, "pL": p0, "gL": g0, "qR": q0, "pR": p0, "gR": g0,
            "prop_q": q0, "prop_u": u0, "prop_g": g0,
            "logw": jnp.asarray(0.0, q0.dtype),  # initial state: logw 0
            "turned": jnp.asarray(False), "div": jnp.asarray(False),
            "sum_acc": jnp.asarray(0.0, q0.dtype),
            "n_leap": jnp.asarray(0, jnp.int32),
        }
        out = jax.lax.while_loop(cond, body, init)
        n = jnp.maximum(out["n_leap"], 1)
        return (out["prop_q"], out["prop_u"], out["prop_g"],
                out["sum_acc"] / n.astype(q0.dtype), out["depth"],
                out["n_leap"], out["div"], out["turned"])

    def init(q: Array, *, mass: Union[float, Array] = 1.0) -> HMCState:
        q = jnp.asarray(q)
        if q.ndim != 2:
            raise ValueError(
                f"init positions must be [num_walkers, num_dims]; got "
                f"{q.shape}")
        u, g = jax.vmap(value_and_grad)(q)
        ens = EnsembleState(
            q=q, p=jnp.zeros_like(q),
            mass=jnp.asarray(mass, dtype=q.dtype),
            log_weight=jnp.zeros(q.shape[:1], dtype=q.dtype))
        return HMCState(ensemble=ens, potential_energy=u, grad=g)

    def step(key: Array, state: HMCState, step_size: Array,
             mass: Optional[Array] = None):
        ens = state.ensemble
        if mass is None:
            mass = ens.mass
        w = ens.num_walkers
        mass_b = jnp.broadcast_to(
            jnp.asarray(mass, dtype=ens.q.dtype), ens.q.shape)
        keys = jax.random.split(key, w)
        (q, u, g, acc, depth, n_leap, div, turned) = jax.vmap(
            single_walker_step, in_axes=(0, 0, 0, 0, None, 0))(
            keys, ens.q, state.potential_energy, state.grad,
            jnp.asarray(step_size), mass_b)
        new_state = HMCState(
            ensemble=ens.replace(q=q, mass=mass),
            potential_energy=u, grad=g)
        info = NUTSInfo(
            accept_prob=acc, depth=depth, num_leapfrogs=n_leap,
            divergent=div, turned=turned, potential_energy=u,
            step_size=jnp.asarray(step_size))
        return new_state, info

    return NUTSKernel(init=init, step=step, max_depth=max_depth)


@dataclasses.dataclass
class NUTSRunResult:
    state: HMCState
    samples: Optional[Array]        # [S, W, D]
    accept_rate: Array
    divergence_rate: Array
    mean_depth: Array
    step_size: Array
    mass: Array


def run_nuts(
    key: Array,
    potential_fn: Callable[[Array], Array],
    init_q: Array,
    *,
    num_warmup: int,
    num_samples: int,
    max_depth: int = 8,
    init_step_size: float = 0.1,
    target_accept: float = 0.8,
    adapt_mass: bool = True,
    mass: Union[float, Array] = 1.0,
    temperature: Union[float, Array] = 1.0,
    constants: Constants = NATURAL,
    collect: str = "samples",
) -> NUTSRunResult:
    """Dual-averaging warmup + sampling with the NUTS kernel (the full
    pipeline the reference's notes specify: U-turn trajectories + dual
    averaging + cross-walker metric estimation)."""
    kernel = build_nuts_kernel(
        potential_fn, max_depth=max_depth, temperature=temperature,
        constants=constants)
    state = kernel.init(jnp.asarray(init_q), mass=mass)
    num_dims = state.ensemble.num_dims
    dtype = state.ensemble.q.dtype

    key, warm_key = jax.random.split(key)
    step_size = jnp.asarray(init_step_size, dtype=dtype)
    mass_arr = jnp.broadcast_to(
        jnp.asarray(mass, dtype=dtype), (1, num_dims))[0]

    if num_warmup > 0:
        def warm_body(carry, key):
            st, da, varst = carry
            new_st, info = kernel.step(key, st, jnp.exp(da.log_step))
            da = da_update(da, jnp.mean(info.accept_prob),
                           target=target_accept)
            varst = variance_update(varst, new_st.ensemble.q)
            return (new_st, da, varst), None

        # the same Stan-like expanding-window schedule HMC warmup uses
        # (adaptation.build_warmup_schedule) — one schedule across samplers
        segments = build_warmup_schedule(num_warmup, adapt_mass=adapt_mass)
        warm_scan = jax.jit(lambda c, k: jax.lax.scan(warm_body, c, k))
        for seg in segments:
            da = da_init(step_size)
            varst = variance_init(num_dims, dtype)
            keys = jax.random.split(
                jax.random.fold_in(warm_key, seg.index), seg.length)
            (state, da, varst), _ = warm_scan((state, da, varst), keys)
            step_size = jnp.exp(da.log_avg_step)
            if seg.update_mass and adapt_mass:
                var = regularized_mass(varst)
                mass_arr = 1.0 / var
                state = state.replace(
                    ensemble=state.ensemble.replace(mass=mass_arr))

    def sample_body(st, key):
        new_st, info = kernel.step(key, st, step_size)
        out = new_st.ensemble.q if collect == "samples" else ()
        scal = (jnp.mean(info.accept_prob),
                jnp.mean(info.divergent.astype(dtype)),
                jnp.mean(info.depth.astype(dtype)))
        return new_st, (out, scal)

    keys = jax.random.split(key, num_samples)
    state, (outs, scals) = jax.jit(
        lambda s, k: jax.lax.scan(sample_body, s, k))(state, keys)
    samples = outs if collect == "samples" else None
    return NUTSRunResult(
        state=state, samples=samples,
        accept_rate=jnp.mean(scals[0]),
        divergence_rate=jnp.mean(scals[1]),
        mean_depth=jnp.mean(scals[2]),
        step_size=step_size, mass=mass_arr)
