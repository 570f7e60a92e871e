"""Tempered sequential Monte Carlo over the walker ensemble.

The capability the reference planned but never built (reference
references/PhysicsBasedHMC_SoHPC2022_WeekPlan.md:39 "Further development of
SMC"; the commented-out Boltzmann ensemble weights, ensemble.py:52-61; the
microcanonical weight formula e^{-beta H_i}/sum_j e^{-beta H_j} in
references/NotesOnParticleBasedHMC.pdf eq. 1), designed ensemble-first:

* every stage is a fused jittable pass over the whole ensemble: reweight
  (log-space, no underflow) -> adaptive next-temperature by on-device
  bisection on the effective sample size -> systematic resample (one
  sorted-uniform gather, SPMD-friendly) -> K HMC mutation steps at the
  current temperature;
* the annealing variable is the physical inverse temperature
  beta = 1/(k_B T): pi_beta(q) ∝ exp(-beta U(q)) interpolates from hot
  (near-flat, beta_0 ~ 0) to the target (beta = 1 in natural units) —
  physical-constants tempering is exactly the reference's framing of HMC
  as statistical mechanics (README.md:6-9);
* the log of the stage-wise mean incremental weight accumulates into an
  unbiased log-normalising-constant (free energy / model evidence)
  estimate — a capability HMC alone cannot provide.

Walker-axis sharding: all per-walker ops are elementwise; the collectives
are logsumexp/weight normalisation (scalar psum under GSPMD) and the
resampling gather (all-to-all over the walker axis). ``run_smc`` composes
with ``parallel.sharded.sharded_run_hmc``-style device placement
unchanged.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from .adaptation import da_init, da_update
from .constants import Constants, NATURAL
from .hmc import build_hmc_kernel, require_xla_kernel
from .ops.potentials import batched_value_and_grad
from .parallel.mesh import WALKER_AXIS
from .utils import struct

Array = jax.Array


# ---------------------------------------------------------------------------
# Weights and effective sample size
# ---------------------------------------------------------------------------


def normalize_log_weights(log_w: Array) -> Array:
    """log w_i - logsumexp(log w) (the log-space version of the reference's
    intended setWeights normalisation, ensemble.py:52-61)."""
    return log_w - jax.scipy.special.logsumexp(log_w)


def effective_sample_size(log_w: Array) -> Array:
    """ESS = (sum w)^2 / sum w^2 = exp(2 lse(lw) - lse(2 lw)) in [1, W]."""
    lse1 = jax.scipy.special.logsumexp(log_w)
    lse2 = jax.scipy.special.logsumexp(2.0 * log_w)
    return jnp.exp(2.0 * lse1 - lse2)


# ---------------------------------------------------------------------------
# Resampling (systematic / stratified / multinomial / residual-free)
# ---------------------------------------------------------------------------


def _inverse_cdf_indices(cum_w: Array, positions: Array) -> Array:
    """For sorted positions u in [0,1): index i with cum_w[i-1] <= u < cum_w[i].
    searchsorted lowers to a vectorised binary search — O(W log W) total,
    no data-dependent shapes."""
    return jnp.clip(jnp.searchsorted(cum_w, positions, side="right"),
                    0, cum_w.shape[0] - 1)


def systematic_indices(key: Array, log_w: Array, num: int) -> Array:
    """Systematic (low-variance) resampling: one uniform offset, W evenly
    spaced points through the weight CDF."""
    w = jnp.exp(normalize_log_weights(log_w))
    cum = jnp.cumsum(w)
    u0 = jax.random.uniform(key, (), dtype=w.dtype)
    positions = (u0 + jnp.arange(num, dtype=w.dtype)) / num
    return _inverse_cdf_indices(cum, positions)


def stratified_indices(key: Array, log_w: Array, num: int) -> Array:
    w = jnp.exp(normalize_log_weights(log_w))
    cum = jnp.cumsum(w)
    u = jax.random.uniform(key, (num,), dtype=w.dtype)
    positions = (u + jnp.arange(num, dtype=w.dtype)) / num
    return _inverse_cdf_indices(cum, positions)


def multinomial_indices(key: Array, log_w: Array, num: int) -> Array:
    return jax.random.categorical(key, normalize_log_weights(log_w),
                                  shape=(num,))


RESAMPLERS = {
    "systematic": systematic_indices,
    "stratified": stratified_indices,
    "multinomial": multinomial_indices,
}


def resample(key: Array, tree, log_w: Array,
             method: str = "systematic"):
    """Resample every walker-leading array in ``tree`` by the weights;
    returns (tree', zeroed log-weights)."""
    num = log_w.shape[0]
    idx = RESAMPLERS[method](key, log_w, num)
    out = jax.tree_util.tree_map(lambda x: jnp.take(x, idx, axis=0), tree)
    return out, jnp.zeros_like(log_w)


# ---------------------------------------------------------------------------
# Adaptive temperature ladder
# ---------------------------------------------------------------------------


def next_beta_by_ess(u: Array, log_w: Array, beta: Array, *,
                     target_frac: float = 0.5, beta_max: float = 1.0,
                     num_bisect: int = 30) -> Array:
    """Largest beta' in (beta, beta_max] whose incremental weights
    ``-(beta' - beta) U`` keep ESS >= target_frac * W, found by fixed-depth
    on-device bisection (SPMD-safe: no data-dependent trip counts)."""
    num = u.shape[0]
    target = target_frac * num

    def ess_at(b):
        lw = log_w - (b - beta) * u
        return effective_sample_size(lw)

    def body(_, bounds):
        lo, hi = bounds
        mid = 0.5 * (lo + hi)
        ok = ess_at(mid) >= target
        return (jnp.where(ok, mid, lo), jnp.where(ok, hi, mid))

    full = jnp.asarray(beta_max, dtype=jnp.asarray(beta).dtype)
    lo, hi = jax.lax.fori_loop(
        0, num_bisect, body, (jnp.asarray(beta), full))
    # if even beta_max keeps ESS above target, jump straight to it
    return jnp.where(ess_at(full) >= target, full, lo)


# ---------------------------------------------------------------------------
# SMC driver
# ---------------------------------------------------------------------------


@struct.dataclass
class SMCResult:
    """Output of :func:`run_smc`."""

    q: Array                 # [W, D] final (posterior) positions
    log_evidence: Array      # log Z estimate (free energy: -log Z = beta F)
    num_stages: Array        # tempering stages actually used
    betas: Array             # [max_stages+1] ladder (padded with beta_max)
    ess_history: Array       # [max_stages] ESS before each resample
    accept_history: Array    # [max_stages] HMC acceptance per stage
    final_step_size: Array


def run_smc(
    key: Array,
    potential_fn: Callable[[Array], Array],
    init_q: Array,
    *,
    num_mutation_steps: int = 3,
    num_leapfrog_steps: int = 10,
    init_step_size: float = 0.5,
    beta0: float = 0.0,
    beta_max: float = 1.0,
    target_ess_frac: float = 0.5,
    resample_threshold_frac: float = 0.5,
    max_stages: int = 50,
    resampler: str = "systematic",
    temperature: Union[float, Array] = 1.0,
    constants: Constants = NATURAL,
    mutation_target_accept: float = 0.75,
    mesh: Optional[Mesh] = None,
    mesh_axis: str = WALKER_AXIS,
    kernel: str = "auto",
) -> SMCResult:
    """Anneal the ensemble from pi_{beta0} (near-flat) to pi_{beta_max}
    (the target) with ESS-adaptive tempering, systematic resampling, and
    HMC mutation moves; estimate log Z along the way.

    ``init_q`` should be draws from the beta0 distribution (for beta0 = 0
    any broad cloud works — weights at stage 1 correct it).

    The whole run is one jitted while_loop over stages; `max_stages`
    bounds compilation. The mutation step size is adapted by dual
    averaging on the ensemble-mean mutation acceptance (state is O(1) and
    lives in the stage carry), targeting ``mutation_target_accept`` — it
    tracks the narrowing tempered target both down AND up, unlike a decay
    heuristic.

    When ``mesh`` is given and walkers are sharded over ``mesh_axis``,
    resampling uses :func:`.parallel.resample.ring_systematic_resample`:
    per-device memory O(W/K) and K-1 neighbor ppermute hops instead of the
    dense all-to-all gather (requires ``resampler="systematic"``).

    ``kernel``: "auto" or "xla" — the mutation moves run the XLA HMC
    kernel; anything else raises ``ValueError``.
    """
    init_q = jnp.asarray(init_q)
    m = build_smc_machinery(
        potential_fn, init_q.shape[0], init_q.dtype,
        num_mutation_steps=num_mutation_steps,
        num_leapfrog_steps=num_leapfrog_steps,
        init_step_size=init_step_size, beta0=beta0, beta_max=beta_max,
        target_ess_frac=target_ess_frac,
        resample_threshold_frac=resample_threshold_frac,
        max_stages=max_stages, resampler=resampler,
        temperature=temperature, constants=constants,
        mutation_target_accept=mutation_target_accept, mesh=mesh,
        mesh_axis=mesh_axis, kernel=kernel)

    @jax.jit
    def smc(key, init_q):
        carry = m["init_carry"](key, init_q)
        carry = jax.lax.while_loop(m["cond"], m["body"], carry)
        return m["finalize"](carry)

    return smc(key, init_q)


def build_smc_machinery(
    potential_fn: Callable[[Array], Array],
    num_walkers: int,
    dtype,
    *,
    num_mutation_steps: int = 3,
    num_leapfrog_steps: int = 10,
    init_step_size: float = 0.5,
    beta0: float = 0.0,
    beta_max: float = 1.0,
    target_ess_frac: float = 0.5,
    resample_threshold_frac: float = 0.5,
    max_stages: int = 50,
    resampler: str = "systematic",
    temperature: Union[float, Array] = 1.0,
    constants: Constants = NATURAL,
    mutation_target_accept: float = 0.75,
    mesh: Optional[Mesh] = None,
    mesh_axis: str = WALKER_AXIS,
    kernel: str = "auto",
) -> dict:
    """The SMC stage machinery as standalone jittable pieces:

    ``{"init_carry": (key, init_q) -> carry, "cond": carry -> bool,
    "body": carry -> carry, "finalize": carry -> SMCResult}``.

    :func:`run_smc` composes them into one jitted ``while_loop`` (the
    fast path); the CLI's fault-tolerant SMC driver
    (main._checkpointed_smc_run) instead jits ``body`` alone and drives
    the stage loop host-side, checkpointing the carry after every
    stage — the annealing ladder is sequential and stages are the
    natural recovery grain. Both paths execute the identical stage
    program, so a resumed run reproduces the uninterrupted one.
    """

    vg = batched_value_and_grad(potential_fn)
    if mesh is not None:
        if resampler != "systematic":
            raise ValueError(
                "sharded SMC (mesh=...) supports only the systematic "
                f"resampler; got {resampler!r}")
        from .parallel.resample import ring_systematic_resample

        def do_resample_fn(k_res, q, log_w):
            q_res, lw0 = ring_systematic_resample(
                k_res, q, log_w, mesh=mesh, axis_name=mesh_axis)
            return q_res
    else:
        def do_resample_fn(k_res, q, log_w):
            idx = RESAMPLERS[resampler](k_res, log_w, num_walkers)
            return jnp.take(q, idx, axis=0)

    base_beta = 1.0 / (constants.k_B * temperature)
    require_xla_kernel(kernel, "run_smc")

    # tempered kernel: scale the potential by beta (relative to base).
    # beta enters only as a traced multiplier (a closure const), so the
    # while_loop body compiles once for all stages.
    def tempered_step(key, q, beta, step_size):
        """One HMC transition targeting exp(-beta * U / (k_B T))."""
        def beta_potential(qq):
            return beta * potential_fn(qq)
        k = build_hmc_kernel(
            beta_potential, num_steps=num_leapfrog_steps,
            temperature=temperature, constants=constants)
        state = k.init(q)
        new_state, info = k.step(key, state, step_size)
        return new_state.ensemble.q, jnp.mean(info.accept_prob)

    def cond(carry):
        (_, _, beta, _, _, stage, *_) = carry
        return (beta < beta_max) & (stage < max_stages)

    def body(carry):
        (q, u, beta, log_w, log_z, stage, key, da,
         betas, ess_h, acc_h) = carry
        key, k_res, k_mut = jax.random.split(key, 3)

        new_beta = next_beta_by_ess(
            base_beta * u, log_w, beta, target_frac=target_ess_frac,
            beta_max=beta_max)
        inc = -(new_beta - beta) * base_beta * u
        # evidence increment: log mean incremental weight under the
        # *normalised* current weights
        norm_w = normalize_log_weights(log_w)
        log_z = log_z + jax.scipy.special.logsumexp(norm_w + inc)
        log_w = log_w + inc
        ess = effective_sample_size(normalize_log_weights(log_w))

        # resample when depleted
        do_resample = ess < resample_threshold_frac * num_walkers
        q_res = do_resample_fn(k_res, q, log_w)
        q = jnp.where(do_resample, q_res, q)
        log_w = jnp.where(do_resample, jnp.zeros_like(log_w), log_w)

        # mutation: K tempered-HMC sweeps, each feeding its
        # ensemble-mean acceptance into the dual-averaging state
        # (per-stage adaptation)
        def mut(carry, k):
            q, da, _ = carry
            step_size = jnp.exp(da.log_step).astype(dtype)
            q, acc = tempered_step(k, q, new_beta, step_size)
            da = da_update(da, acc, target=mutation_target_accept)
            return (q, da, acc), None

        (q, da, acc), _ = jax.lax.scan(
            mut, (q, da, jnp.asarray(0.0, dtype)),
            jax.random.split(k_mut, num_mutation_steps))
        # unscaled target potential for the next reweighting step
        u, _ = vg(q)

        betas = betas.at[stage + 1].set(new_beta)
        ess_h = ess_h.at[stage].set(ess)
        acc_h = acc_h.at[stage].set(acc)
        return (q, u, new_beta, log_w, log_z, stage + 1, key,
                da, betas, ess_h, acc_h)

    def init_carry(key, init_q):
        u0, _ = vg(init_q)
        betas0 = jnp.full((max_stages + 1,), beta_max, dtype)
        betas0 = betas0.at[0].set(beta0)
        return (init_q, u0, jnp.asarray(beta0, dtype),
                jnp.zeros((num_walkers,), dtype),
                jnp.asarray(0.0, dtype), jnp.asarray(0),
                key, da_init(jnp.asarray(init_step_size, dtype)),
                betas0, jnp.zeros((max_stages,), dtype),
                jnp.zeros((max_stages,), dtype))

    def finalize(carry):
        (q, u, beta, log_w, log_z, stage, key, da,
         betas, ess_h, acc_h) = carry
        # final resample so the returned ensemble is unweighted
        key, k_final = jax.random.split(key)
        q = do_resample_fn(k_final, q, log_w)
        return SMCResult(
            q=q, log_evidence=log_z, num_stages=stage, betas=betas,
            ess_history=ess_h, accept_history=acc_h,
            final_step_size=jnp.exp(da.log_step).astype(dtype))

    return {"init_carry": init_carry, "cond": cond, "body": body,
            "finalize": finalize}

