"""ChEES-HMC: ensemble-native trajectory-length adaptation.

The reference leaves trajectory length (``simulTime``) as a hand-tuned
constructor argument (reference HMC.py:26-35, ``simulTime``/``stepSize``)
and its notes only specify NUTS as the alternative (reference
references/NotesOnParticleBasedHMC.pdf). ChEES-HMC (Hoffman, Radul &
Sountsov, AISTATS 2021) is the *ensemble-first* answer — it needs many
parallel chains to estimate its criterion, which is exactly what this
framework has, and unlike NUTS it keeps every walker on the same
trajectory schedule (no per-walker control flow), which keeps the whole
ensemble in one batched program.

Mechanics:

* Each transition integrates for a jittered time ``t = 2 h_t tau`` where
  ``h_t`` is a quasi-random Halton draw (jitter breaks the resonances of
  fixed-length HMC); the number of leapfrog steps is data-dependent but
  *rank-static*: the trajectory runs as a ``lax.fori_loop`` with a traced
  trip count, so XLA compiles one program for all lengths (capped at
  ``max_steps``).
* Warmup maximises the ChEES criterion
  ``E[(|q' - E q'|^2 - |q - E q|^2)^2] / 4`` by Adam on ``log tau``, with
  the paper's per-transition gradient estimator: accept-probability-
  weighted cross-walker means (psum-shaped reductions under sharding),
  alongside the usual dual-averaging step-size adaptation.
* Sampling keeps the adapted ``tau`` and continues to jitter.

All walkers share each transition's trajectory length, so walker-axis
sharding passes through unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from .adaptation import (
    build_warmup_schedule,
    da_init,
    da_update,
    regularized_mass,
    variance_init,
    variance_update,
)
from .constants import Constants, NATURAL
from .ensemble import thermal_momentum_std
from .hmc import HMCInfo, HMCState, require_xla_kernel
from .ops.potentials import batched_value_and_grad
from .utils import struct

Array = jax.Array


def halton_sequence(length: int, base: int = 2) -> np.ndarray:
    """Van der Corput / Halton quasi-random sequence in (0, 1)."""
    out = np.zeros((length,), np.float32)
    for i in range(length):
        f, r, n = 1.0, 0.0, i + 1
        while n > 0:
            f /= base
            r += f * (n % base)
            n //= base
        out[i] = r
    return out


@struct.dataclass
class ChEESAdaptState:
    """Adam state for log-tau ascent on the ChEES criterion."""

    log_tau: Array
    m: Array
    v: Array
    count: Array


def chees_init(init_tau: float, dtype=jnp.float32) -> ChEESAdaptState:
    z = jnp.zeros((), dtype)
    return ChEESAdaptState(
        log_tau=jnp.log(jnp.asarray(init_tau, dtype)), m=z, v=z, count=z)


def chees_update(st: ChEESAdaptState, grad: Array, *,
                 lr: float = 0.025, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8) -> ChEESAdaptState:
    """One Adam ascent step on log tau (gradient is d ChEES / d log tau)."""
    grad = jnp.where(jnp.isfinite(grad), grad, 0.0)
    count = st.count + 1.0
    m = b1 * st.m + (1.0 - b1) * grad
    v = b2 * st.v + (1.0 - b2) * grad * grad
    m_hat = m / (1.0 - b1**count)
    v_hat = v / (1.0 - b2**count)
    log_tau = st.log_tau + lr * m_hat / (jnp.sqrt(v_hat) + eps)
    return ChEESAdaptState(log_tau=log_tau, m=m, v=v, count=count)


def build_jittered_hmc_kernel(
    potential_fn: Callable[[Array], Array],
    *,
    max_steps: int = 1024,
    temperature: Union[float, Array] = 1.0,
    constants: Constants = NATURAL,
    divergence_threshold: float = 1000.0,
):
    """HMC transition whose leapfrog count is a TRACED value:
    ``step(key, state, step_size, num_steps) -> (state', info, proposal)``
    where ``proposal = (q1, p1)`` (pre-accept endpoint, needed by the
    ChEES gradient estimator). The trajectory is a ``fori_loop`` with a
    data-dependent trip count clipped to ``[1, max_steps]`` — one compiled
    program serves every jittered length."""
    vg = batched_value_and_grad(potential_fn)
    beta = constants.beta(temperature)

    def init(q: Array, *, mass: Union[float, Array] = 1.0) -> HMCState:
        q = jnp.asarray(q)
        if q.ndim != 2:
            raise ValueError(
                f"init positions must be [num_walkers, num_dims]; got "
                f"{q.shape}")
        from .ensemble import EnsembleState
        u, g = vg(q)
        return HMCState(
            ensemble=EnsembleState(
                q=q, p=jnp.zeros_like(q),
                mass=jnp.asarray(mass, q.dtype),
                log_weight=jnp.zeros(q.shape[:1], q.dtype)),
            potential_energy=u, grad=g)

    def step(key: Array, state: HMCState, step_size: Array,
             num_steps: Array, mass: Optional[Array] = None):
        ens = state.ensemble
        if mass is None:
            mass = ens.mass
        key_mom, key_acc = jax.random.split(key)
        p_std = thermal_momentum_std(mass, temperature, constants)
        p0 = p_std * jax.random.normal(key_mom, ens.p.shape, ens.p.dtype)
        inv_mass = 1.0 / mass
        n = jnp.clip(jnp.asarray(num_steps, jnp.int32), 1, max_steps)

        def body(_, carry):
            q, p, u, g = carry
            p = p - 0.5 * step_size * g
            q = q + step_size * p * inv_mass
            u, g = vg(q)
            p = p - 0.5 * step_size * g
            return (q, p, u, g)

        q1, p1, u1, g1 = jax.lax.fori_loop(
            0, n, body, (ens.q, p0, state.potential_energy, state.grad))
        p1 = -p1

        h0 = 0.5 * jnp.sum(p0 * p0 * inv_mass, axis=-1) \
            + state.potential_energy
        h1 = 0.5 * jnp.sum(p1 * p1 * inv_mass, axis=-1) + u1
        energy_error = beta * (h1 - h0)
        energy_error = jnp.where(
            jnp.isfinite(energy_error), energy_error, jnp.inf)
        divergent = energy_error > divergence_threshold
        log_u = jnp.log(jax.random.uniform(
            key_acc, energy_error.shape, dtype=ens.q.dtype,
            minval=jnp.finfo(ens.q.dtype).tiny))
        accepted = (log_u < -energy_error) & ~divergent
        accept_prob = jnp.where(
            divergent, 0.0, jnp.exp(jnp.minimum(0.0, -energy_error)))

        sel = accepted[:, None]
        new_state = HMCState(
            ensemble=ens.replace(
                q=jnp.where(sel, q1, ens.q),
                p=jnp.where(sel, p1, p0),
                mass=mass),
            potential_energy=jnp.where(accepted, u1, state.potential_energy),
            grad=jnp.where(sel, g1, state.grad))
        info = HMCInfo(
            accept_prob=accept_prob, accepted=accepted,
            energy_error=energy_error, divergent=divergent,
            potential_energy=new_state.potential_energy,
            step_size=jnp.asarray(step_size))
        return new_state, info, (q1, p1)

    return init, step


def chees_gradient(q0: Array, q1: Array, p1: Array, accept_prob: Array,
                   halton: Array, inv_mass) -> Array:
    """The ChEES-HMC d/d(log tau) estimator (Hoffman et al. 2021, eq. 8):
    accept-weighted over walkers,

        g = E_w[ (|q1 - q1bar|^2 - |q0 - q0bar|^2) * ((q1 - q1bar) . v1) ]
            * h_t

    with v1 the end-point velocity and centred means taken over the
    ensemble (these reductions become psum collectives when sharded)."""
    w = accept_prob + 1e-8
    wsum = jnp.sum(w)
    q0c = q0 - jnp.mean(q0, axis=0)
    q1bar = jnp.sum(w[:, None] * q1, axis=0) / wsum
    q1c = q1 - q1bar
    a = jnp.sum(q1c * q1c, axis=-1) - jnp.sum(q0c * q0c, axis=-1)
    # -p1 undoes the momentum flip: velocity in the forward direction
    b = jnp.sum(q1c * (-p1 * inv_mass), axis=-1)
    g = jnp.sum(w * a * b) / wsum
    # normalise for scale-freeness across targets (sign is what matters)
    scale = jnp.sqrt(jnp.mean(a * a) * jnp.mean(b * b)) + 1e-10
    return halton * g / scale


@dataclasses.dataclass
class ChEESRunResult:
    state: HMCState
    samples: Optional[Array]   # [S, W, D]
    mean: Optional[Array]
    var: Optional[Array]
    accept_rate: Array
    divergence_rate: Array
    step_size: Array
    trajectory_time: Array     # adapted tau
    mean_num_steps: Array
    kernel_used: str = "xla"   # the one engine: the XLA jittered kernel


def run_chees_hmc(
    key: Array,
    potential_fn: Callable[[Array], Array],
    init_q: Array,
    *,
    num_warmup: int,
    num_samples: int,
    init_step_size: float = 0.1,
    init_tau: float = 1.0,
    max_steps: int = 1024,
    target_accept: float = 0.8,
    adapt_lr: float = 0.025,
    adapt_mass: bool = True,
    mass: Union[float, Array] = 1.0,
    temperature: Union[float, Array] = 1.0,
    constants: Constants = NATURAL,
    collect: str = "samples",
    kernel: str = "auto",
) -> ChEESRunResult:
    """Warmup (joint dual-averaging step size + ChEES trajectory time) then
    sample with Halton-jittered trajectory lengths ``t = 2 h tau``.

    ``kernel``: "auto" or "xla" — both run the XLA jittered kernel, whose
    trajectory is a ``fori_loop`` with a traced trip count; anything else
    raises ``ValueError``."""
    if collect not in ("samples", "moments", "none"):
        raise ValueError(f"bad collect={collect!r}")
    require_xla_kernel(kernel, "run_chees_hmc")
    init_q = jnp.asarray(init_q)
    num_dims = init_q.shape[-1]
    dtype = init_q.dtype
    init_fn, step_fn = build_jittered_hmc_kernel(
        potential_fn, max_steps=max_steps, temperature=temperature,
        constants=constants)
    state = init_fn(init_q, mass=mass)

    halton_all = jnp.asarray(
        halton_sequence(num_warmup + num_samples), dtype)

    def steps_for(tau, h, step_size):
        t = 2.0 * h * tau
        return jnp.clip(jnp.round(t / step_size).astype(jnp.int32),
                        1, max_steps)

    key, k_warm, k_sample = jax.random.split(key, 3)

    # ---- warmup: joint (step size, tau, diag metric) adaptation ------------
    # Stan-like expanding segments (adaptation.build_warmup_schedule, the
    # same schedule run_hmc uses): dual averaging + ChEES Adam run inside
    # each segment's scan; between segments the CROSS-WALKER variance
    # refreshes the diagonal mass (r5 — previously ChEES never adapted a
    # metric, leaving per-dimension scale differences to the step size).
    step_size = jnp.asarray(init_step_size, dtype)
    tau = jnp.asarray(init_tau, dtype)
    if num_warmup > 0:
        z = jnp.zeros((), dtype)

        @jax.jit
        def warm_seg(state, keys, haltons, step_size0, tau0):
            da = da_init(step_size0)
            ch = ChEESAdaptState(log_tau=jnp.log(tau0), m=z, v=z, count=z)
            varst = variance_init(num_dims, dtype)

            def body(carry, xs):
                st, da, ch, varst = carry
                k, h = xs
                eps = jnp.exp(da.log_step)
                n = steps_for(jnp.exp(ch.log_tau), h, eps)
                q0 = st.ensemble.q
                st, info, (q1, p1) = step_fn(k, st, eps, n)
                da = da_update(da, jnp.mean(info.accept_prob),
                               target=target_accept)
                g = chees_gradient(q0, q1, p1, info.accept_prob, h,
                                   1.0 / st.ensemble.mass)
                ch = chees_update(ch, g, lr=adapt_lr)
                varst = variance_update(varst, st.ensemble.q)
                return (st, da, ch, varst), None

            (state, da, ch, varst), _ = jax.lax.scan(
                body, (state, da, ch, varst), (keys, haltons))
            return (state, jnp.exp(da.log_avg_step), jnp.exp(ch.log_tau),
                    varst)

        segments = build_warmup_schedule(num_warmup, adapt_mass=adapt_mass)
        h_idx = 0
        for seg in segments:
            keys = jax.random.split(
                jax.random.fold_in(k_warm, seg.index), seg.length)
            hs = halton_all[h_idx:h_idx + seg.length]
            h_idx += seg.length
            state, step_size, tau, varst = warm_seg(
                state, keys, hs, step_size, tau)
            if seg.update_mass and adapt_mass:
                mass_arr = 1.0 / regularized_mass(varst)
                state = state.replace(
                    ensemble=state.ensemble.replace(mass=mass_arr))

    # ---- sampling -----------------------------------------------------------
    @jax.jit
    def sample(state, keys, haltons):
        def body(carry, xs):
            st, mean, m2, n_cnt = carry
            k, h = xs
            n = steps_for(tau, h, step_size)
            st, info, _ = step_fn(k, st, step_size, n)
            out = {}
            if collect == "samples":
                out["q"] = st.ensemble.q
            elif collect == "moments":
                q = st.ensemble.q
                w = q.shape[0]
                n_new = n_cnt + w
                bm = jnp.mean(q, axis=0)
                delta = bm - mean
                mean = mean + delta * (w / n_new)
                m2 = m2 + jnp.sum((q - bm) ** 2, axis=0) \
                    + delta**2 * (n_cnt * w / n_new)
                n_cnt = n_new
            scal = (jnp.mean(info.accept_prob),
                    jnp.mean(info.divergent.astype(dtype)),
                    n.astype(dtype))
            return (st, mean, m2, n_cnt), (out, scal)

        mean0 = jnp.zeros((num_dims,), dtype)
        m2_0 = jnp.zeros((num_dims,), dtype)
        (state, mean, m2, n_cnt), (outs, scals) = jax.lax.scan(
            body, (state, mean0, m2_0, jnp.zeros((), dtype)),
            (keys, haltons))
        return state, mean, m2, n_cnt, outs, scals

    state, mean, m2, n_cnt, outs, scals = sample(
        state, jax.random.split(k_sample, num_samples),
        halton_all[num_warmup:])

    samples = outs.get("q") if collect == "samples" else None
    post_mean = post_var = None
    if collect == "moments":
        post_mean = mean
        post_var = m2 / jnp.maximum(n_cnt - 1.0, 1.0)

    return ChEESRunResult(
        state=state, samples=samples, mean=post_mean, var=post_var,
        accept_rate=jnp.mean(scals[0]),
        divergence_rate=jnp.mean(scals[1]),
        step_size=step_size, trajectory_time=tau,
        mean_num_steps=jnp.mean(scals[2]))
