"""Ensemble Hamiltonian Monte Carlo: one fused, jittable kernel.

Redesign of the reference sampler (reference src/HMC.py:20-183).
The reference's ``getSamples`` is a Python loop over samples around Python
loops over walkers, with one ``jax.grad`` dispatch per walker per integration
step (SURVEY.md §3.1). Here a *single* sampling transition is one pure
function

    step(key, state, step_size) -> (state', info)

containing {thermal momentum refresh -> L leapfrog steps (lax.scan) ->
momentum flip -> per-walker Metropolis accept} entirely inside XLA, batched
over all walkers. ``run_hmc`` then drives warmup (dual-averaging step size +
cross-walker metric estimation) and sampling with ``lax.scan`` over
transitions; the whole chain is a handful of compiled programs regardless of
``num_samples * num_walkers * num_steps``.

Physical-constants semantics: the target at temperature T is
``pi_T(q) ∝ exp(-U(q) / (k_B T))``; momenta are Maxwell-Boltzmann
(std ``sqrt(m k_B T)``, reference ensemble.py:88) and the Metropolis ratio is
``exp(-(H_new - H_old) / (k_B T))``. At ``k_B T = 1`` (the default NATURAL
constants) this is standard HMC and matches the reference's test configs
(reference test_HMC.py uses ``temperature = 1/k_B`` to the same effect).
NOTE: the reference accepts with ``exp(H_old - H_new)`` (HMC.py:115)
regardless of T, which is inconsistent with its thermal momenta for
``k_B T != 1``; the tempered form here is the physically consistent one
(reference references/NotesOnParticleBasedHMC.pdf, eq. 1: weights e^{-beta H})
and reduces to the reference behaviour in every configuration its tests
exercise.

Fixed (not ported) reference bugs — SURVEY.md §7: rejected-walker momenta
restored from *positions* (HMC.py:176); unseeded global RNG (HMC.py:170);
in-place aliasing of ensemble arrays (integrator.py:40-43).
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable, Optional, Union

import jax
import jax.numpy as jnp

from .adaptation import (
    build_warmup_schedule,
    da_init,
    da_update,
    variance_init,
    variance_update,
    regularized_mass,
)
from .constants import Constants, NATURAL
from .ensemble import EnsembleState, kinetic_energy, thermal_momentum_std
from .ops.integrators import get_integrator
from .ops.potentials import batched_value_and_grad
from .utils import struct

Array = jax.Array


@struct.dataclass
class HMCState:
    """Sampler state: ensemble + cached potential energy and gradient."""

    ensemble: EnsembleState
    potential_energy: Array  # [W]
    grad: Array  # [W, D]


@struct.dataclass
class HMCInfo:
    """Per-transition diagnostics (the reference computes acceptance

    probabilities per walker, HMC.py:168, then discards them — SURVEY.md §5
    'Metrics' gap)."""

    accept_prob: Array  # [W]
    accepted: Array  # [W] bool
    energy_error: Array  # [W] beta * (H_new - H_old)
    divergent: Array  # [W] bool
    potential_energy: Array  # [W]
    step_size: Array  # scalar


@dataclasses.dataclass(frozen=True)
class HMCKernel:
    """A built HMC transition kernel (static config closed over)."""

    init: Callable[..., HMCState]
    step: Callable[[Array, HMCState, Array], tuple[HMCState, HMCInfo]]
    num_steps: int
    grad_evals_per_step: int
    # the engine a step runs: "xla" | "fused" | "dense", with
    # "+shard_map" appended by parallel.sharded.shard_map_kernel
    kind: str = "xla"


def build_hmc_kernel(
    potential_fn: Callable[[Array], Array],
    *,
    num_steps: int,
    integrator: str = "leapfrog",
    temperature: Union[float, Array] = 1.0,
    constants: Constants = NATURAL,
    divergence_threshold: float = 1000.0,
    use_analytic_grad: bool = True,
) -> HMCKernel:
    """Build the fused ensemble-HMC transition kernel.

    Args:
      potential_fn: per-walker potential ``q:[D] -> scalar`` (negative log
        density). Batched internally; a closed-form ``analytic_grad``
        attribute is used when present.
      num_steps: leapfrog steps per trajectory (static; the scan length).
      integrator: one of ``ops.integrators.INTEGRATORS``.
      temperature: tempering temperature T; target is exp(-U/(k_B T)).
      divergence_threshold: energy error (in units of k_B T) above which a
        trajectory is flagged divergent and rejected.
    """
    integ = get_integrator(integrator)
    vg = batched_value_and_grad(potential_fn, use_analytic=use_analytic_grad)
    beta = constants.beta(temperature)

    def init(q: Array, *, mass: Union[float, Array] = 1.0) -> HMCState:
        q = jnp.asarray(q)
        if q.ndim != 2:
            raise ValueError(
                f"init positions must be [num_walkers, num_dims]; got shape "
                f"{q.shape}. For a single walker pass q[None, :].")
        mass_arr = jnp.asarray(mass, dtype=q.dtype)
        u, g = vg(q)
        ens = EnsembleState(
            q=q,
            p=jnp.zeros_like(q),
            mass=mass_arr,
            log_weight=jnp.zeros(q.shape[:1], dtype=q.dtype),
        )
        return HMCState(ensemble=ens, potential_energy=u, grad=g)

    def step(key: Array, state: HMCState, step_size: Array,
             mass: Optional[Array] = None) -> tuple[HMCState, HMCInfo]:
        ens = state.ensemble
        if mass is None:
            mass = ens.mass
        key_mom, key_acc = jax.random.split(key)

        # Thermal momentum refresh (reference HMC.py:154 -> ensemble.py:78-93)
        p_std = thermal_momentum_std(mass, temperature, constants)
        p0 = p_std * jax.random.normal(key_mom, ens.p.shape, dtype=ens.p.dtype)

        inv_mass = 1.0 / mass
        q1, p1, u1, g1 = integ(
            vg, ens.q, p0, step_size=step_size, num_steps=num_steps,
            inv_mass=inv_mass, grad=state.grad,
            potential_energy=state.potential_energy)
        # Momentum flip for formal reversibility (reference HMC.py:164);
        # statistically a no-op under full refresh but kept so the proposal
        # is exactly its own inverse.
        p1 = -p1

        h0 = kinetic_energy(p0, mass) + state.potential_energy
        h1 = kinetic_energy(p1, mass) + u1
        energy_error = beta * (h1 - h0)
        energy_error = jnp.where(
            jnp.isfinite(energy_error), energy_error, jnp.inf)
        divergent = energy_error > divergence_threshold

        log_u = jnp.log(jax.random.uniform(
            key_acc, energy_error.shape, dtype=ens.q.dtype,
            minval=jnp.finfo(ens.q.dtype).tiny))
        accepted = (log_u < -energy_error) & ~divergent
        accept_prob = jnp.exp(jnp.minimum(0.0, -energy_error))
        accept_prob = jnp.where(divergent, 0.0, accept_prob)

        sel = accepted[:, None]
        new_ens = ens.replace(
            q=jnp.where(sel, q1, ens.q),
            p=jnp.where(sel, p1, p0),  # NOT oldQ — reference HMC.py:176 bug
            mass=mass,
        )
        new_state = HMCState(
            ensemble=new_ens,
            potential_energy=jnp.where(accepted, u1, state.potential_energy),
            grad=jnp.where(sel, g1, state.grad),
        )
        info = HMCInfo(
            accept_prob=accept_prob,
            accepted=accepted,
            energy_error=energy_error,
            divergent=divergent,
            potential_energy=new_state.potential_energy,
            step_size=jnp.asarray(step_size),
        )
        return new_state, info

    return HMCKernel(
        init=init,
        step=step,
        num_steps=num_steps,
        grad_evals_per_step=getattr(integ, "grad_evals_per_step", 1),
    )


@dataclasses.dataclass
class HMCRunResult:
    """Output of :func:`run_hmc`."""

    state: HMCState
    samples: Optional[Array]  # [S, W, D] if collect="samples"
    mean: Optional[Array]  # [D] streaming posterior mean (collect="moments")
    var: Optional[Array]  # [D] streaming posterior variance
    accept_rate: Array  # scalar, post-warmup mean
    divergence_rate: Array  # scalar
    step_size: Array  # adapted step size
    mass: Array  # adapted (diagonal) mass / metric
    num_grad_evals: int  # total potential-gradient evaluations (all walkers)
    kernel_used: str = "xla"  # engine that ran: HMCKernel.kind
    sampling_seconds: float = 0.0  # wall time of the sampling scan (synced)
    metric_cov: Optional[Array] = None  # [D, D] adapted Sigma (metric="dense")


KERNEL_CHOICES = ("auto", "xla", "fused")


def resolve_kernel_choice(kernel: str, *,
                          integrator: str = "leapfrog") -> str:
    """The one place that turns a ``kernel=`` request into the engine that
    will run: "xla" (the ``lax.scan`` engine, :func:`build_hmc_kernel`) or
    "fused" (the Pallas Triton transition, :func:`build_fused_hmc_kernel`).

    "auto" and "xla" run the XLA engine on every backend. "fused" is
    honoured only on a GPU backend and for the leapfrog integrator;
    otherwise it raises ``ValueError`` rather than running something else.
    """
    if kernel not in KERNEL_CHOICES:
        raise ValueError(
            f"bad kernel={kernel!r} (want one of {', '.join(KERNEL_CHOICES)})")
    if kernel != "fused":
        return "xla"
    if integrator not in ("leapfrog", "velocity_verlet"):
        raise ValueError(
            f"kernel='fused' runs leapfrog only; integrator={integrator!r} "
            f"needs kernel='xla'")
    backend = jax.default_backend()
    if backend != "gpu":
        raise ValueError(
            f"kernel='fused': no fused engine on this backend ({backend}); "
            f"use kernel='auto' or 'xla'")
    return "fused"


def require_xla_kernel(kernel: str, sampler: str) -> None:
    """Samplers with a single (XLA) engine accept only "auto" and "xla"."""
    if kernel not in ("auto", "xla"):
        raise ValueError(
            f"{sampler}: kernel={kernel!r} is not supported; this sampler "
            f"runs the XLA engine only (kernel='auto' or 'xla')")


# Cross-call caches: repeated run_hmc calls with the same potential reuse
# the built kernel and its jitted warmup/sampling scans, so jax.jit's own
# cache hits instead of re-tracing. Keyed by object identity of the
# potential/kernel (strong refs pinned in the value so ids stay valid);
# unhashable configs (array temperature) simply skip the cache.
_KERNEL_CACHE: dict = {}
_SCAN_CACHE: dict = {}


def _sample_scan_for(kernel: HMCKernel, collect: str):
    """A jitted sampling scan reusable across run_hmc calls for the same
    built kernel: step_size and the streaming-moment carry ride as
    arguments, so repeated runs (bench double-call, CLI re-invocations
    in-process, chunked drivers) hit jax.jit's cache instead of
    re-tracing."""
    cache_key = (id(kernel), collect)
    hit = _SCAN_CACHE.get(cache_key)
    if hit is not None:
        return hit[0]

    @jax.jit
    def scan_fn(state, keys, step_size, mean0, m2_0, n0):
        dtype = state.ensemble.q.dtype

        def body(carry, key):
            st, mean, m2, n = carry
            new_st, info = kernel.step(key, st, step_size)
            out = {}
            scal = {
                "accept": jnp.mean(info.accept_prob),
                "div": jnp.mean(info.divergent.astype(dtype)),
            }
            if collect == "samples":
                out["q"] = new_st.ensemble.q
            elif collect == "moments":
                q = new_st.ensemble.q
                w = q.shape[0]
                n_new = n + w
                batch_mean = jnp.mean(q, axis=0)
                delta = batch_mean - mean
                mean = mean + delta * (w / n_new)
                batch_m2 = jnp.sum((q - batch_mean) ** 2, axis=0)
                m2 = m2 + batch_m2 + delta**2 * (n * w / n_new)
                n = n_new
            return (new_st, mean, m2, n), (out, scal)

        return jax.lax.scan(body, (state, mean0, m2_0, n0), keys)

    _SCAN_CACHE[cache_key] = (scan_fn, kernel)
    return scan_fn


def run_hmc(
    key: Array,
    potential_fn: Callable[[Array], Array],
    init_q: Array,
    *,
    num_warmup: int,
    num_samples: int,
    num_steps: int,
    init_step_size: float = 0.1,
    target_accept: float = 0.8,
    adapt_step_size: bool = True,
    adapt_mass: bool = True,
    mass: Union[float, Array] = 1.0,
    integrator: str = "leapfrog",
    temperature: Union[float, Array] = 1.0,
    constants: Constants = NATURAL,
    collect: str = "samples",
    thin: int = 1,
    kernel: str = "auto",
    metric: str = "diag",
) -> HMCRunResult:
    """Warmup-adapt and sample with ensemble HMC.

    Warmup uses dual averaging for the step size (Hoffman & Gelman 2014, the
    adaptation scheme specified in the reference's NotesOnParticleBasedHMC.pdf
    and checked-in NUTS paper) with the acceptance statistic averaged over the
    whole ensemble, and — uniquely possible with many walkers — a
    *cross-walker* variance estimate for the diagonal metric (mass = 1/var),
    far lower-variance than single-chain Welford at equal wall-clock.

    ``collect``: "samples" stacks thinned positions ``[S, W, D]``;
    "moments" streams posterior mean/variance (O(D) memory — required at
    10^5 walkers, BASELINE.json config 5); "none" keeps only diagnostics.

    ``kernel``: "auto" (default) and "xla" run the XLA scan engine;
    "fused" runs the Pallas Triton transition on a GPU (see
    :func:`resolve_kernel_choice`). Both engines draw the same random
    numbers and take the same decisions walker by walker. A prebuilt
    :class:`HMCKernel` instance is also accepted (e.g. a shard_map-wrapped
    kernel from ``parallel.sharded.shard_map_kernel``), so warmup,
    adaptation and collection are one code path for every engine.
    """
    if collect not in ("samples", "moments", "none"):
        raise ValueError(f"bad collect={collect!r}")
    if metric not in ("diag", "dense"):
        raise ValueError(f"bad metric={metric!r} (want diag|dense)")
    if metric == "dense":
        # full mass-matrix path (Stan dense_e analog): its metric rides
        # as traced [D, D] kernel inputs — see build_dense_hmc_kernel.
        # The fused engine is diag-metric only.
        if kernel == "fused":
            raise ValueError("kernel='fused' has no dense-metric variant; "
                             "use kernel='auto' or 'xla' with "
                             "metric='dense'")
        return _run_hmc_dense(
            key, potential_fn, init_q, num_warmup=num_warmup,
            num_samples=num_samples, num_steps=num_steps,
            init_step_size=init_step_size, target_accept=target_accept,
            adapt_step_size=adapt_step_size, adapt_mass=adapt_mass,
            temperature=temperature, constants=constants,
            collect=collect, thin=thin)
    if isinstance(kernel, HMCKernel):
        pass  # prebuilt (e.g. shard_map-wrapped) kernel: use as-is
    else:
        choice = resolve_kernel_choice(kernel, integrator=integrator)
        num_dims = jnp.shape(init_q)[-1]
        try:
            ck = (choice, id(potential_fn), num_steps, integrator,
                  float(temperature), id(constants), num_dims)
        except TypeError:
            ck = None  # array temperature: skip the cross-call cache
        cached = _KERNEL_CACHE.get(ck) if ck is not None else None
        if cached is not None:
            kernel = cached[0]
        else:
            if choice == "fused":
                kernel = build_fused_hmc_kernel(
                    potential_fn, num_steps=num_steps, num_dims=num_dims,
                    temperature=temperature, constants=constants)
            else:
                kernel = build_hmc_kernel(
                    potential_fn, num_steps=num_steps, integrator=integrator,
                    temperature=temperature, constants=constants)
            if ck is not None:
                # pin potential_fn/constants so their ids stay valid
                _KERNEL_CACHE[ck] = (kernel, potential_fn, constants)
    state = kernel.init(jnp.asarray(init_q), mass=mass)
    num_dims = state.ensemble.num_dims
    dtype = state.ensemble.q.dtype

    key, warm_key = jax.random.split(key)

    # ---- warmup -----------------------------------------------------------
    step_size = jnp.asarray(init_step_size, dtype=dtype)
    mass_arr = jnp.broadcast_to(
        jnp.asarray(mass, dtype=dtype), (1, num_dims))[0]

    if num_warmup > 0:
        segments = build_warmup_schedule(num_warmup, adapt_mass=adapt_mass)

        warm_key_cache = (id(kernel), "warm", float(target_accept),
                          bool(adapt_step_size))
        hit = _SCAN_CACHE.get(warm_key_cache)
        if hit is not None:
            warm_scan = hit[0]
        else:
            def warm_body(carry, key):
                st, da, varst = carry
                new_st, info = kernel.step(key, st, jnp.exp(da.log_step))
                da = da_update(da, jnp.mean(info.accept_prob),
                               target=target_accept,
                               enabled=adapt_step_size)
                varst = variance_update(varst, new_st.ensemble.q)
                return (new_st, da, varst), None

            warm_scan = jax.jit(lambda carry, keys: jax.lax.scan(
                warm_body, carry, keys))
            _SCAN_CACHE[warm_key_cache] = (warm_scan, kernel)

        for seg in segments:
            da = da_init(step_size)
            varst = variance_init(num_dims, dtype)
            keys = jax.random.split(
                jax.random.fold_in(warm_key, seg.index), seg.length)
            (state, da, varst), _ = warm_scan((state, da, varst), keys)
            step_size = jnp.exp(da.log_avg_step) if adapt_step_size \
                else step_size
            if seg.update_mass and adapt_mass:
                var = regularized_mass(varst)
                mass_arr = 1.0 / var
                state = state.replace(
                    ensemble=state.ensemble.replace(mass=mass_arr))

    # ---- sampling ---------------------------------------------------------
    # streaming Welford over (step, walker) pairs inside a jitted scan
    # memoized per (kernel, collect) across run_hmc calls
    mean0 = jnp.zeros((num_dims,), dtype)
    m2_0 = jnp.zeros((num_dims,), dtype)
    n0 = jnp.zeros((), dtype)
    keys = jax.random.split(key, num_samples)
    sample_scan = _sample_scan_for(kernel, collect)

    t0 = _time.perf_counter()
    (state, mean, m2, n), (outs, scals) = sample_scan(
        state, keys, jnp.asarray(step_size, dtype), mean0, m2_0, n0)
    accept_rate = jnp.mean(scals["accept"])
    float(accept_rate)  # scalar readback = reliable device sync
    sampling_seconds = _time.perf_counter() - t0

    samples = None
    post_mean = post_var = None
    if collect == "samples":
        samples = outs["q"][::thin]
    elif collect == "moments":
        post_mean = mean
        post_var = m2 / jnp.maximum(n - 1.0, 1.0)

    num_walkers = state.ensemble.num_walkers
    total_grads = ((num_warmup + num_samples) * num_walkers
                   * (kernel.num_steps * kernel.grad_evals_per_step + 1))
    return HMCRunResult(
        state=state,
        samples=samples,
        mean=post_mean,
        var=post_var,
        accept_rate=accept_rate,
        divergence_rate=jnp.mean(scals["div"]),
        step_size=step_size,
        mass=mass_arr,
        num_grad_evals=total_grads,
        kernel_used=kernel.kind,
        sampling_seconds=sampling_seconds,
    )


def build_fused_hmc_kernel(
    potential_fn: Callable[[Array], Array],
    *,
    num_steps: int,
    num_dims: int,
    temperature: Union[float, Array] = 1.0,
    constants: Constants = NATURAL,
    divergence_threshold: float = 1000.0,
    interpret: bool = False,
) -> HMCKernel:
    """HMC with the whole transition (trajectory, Metropolis test,
    accept-select) in one Pallas kernel on the Triton route
    (ops/fused_hmc.py). Same interface and statistics as
    :func:`build_hmc_kernel`, and the same random numbers: the step draws
    momenta and Metropolis uniforms with the XLA step's key splits and
    passes them to the kernel.

    Leapfrog with a diagonal mass broadcastable to ``[num_dims]``;
    ``num_dims`` must be a power of two and the potential's jaxpr must
    lower through Triton — otherwise this raises ``ValueError`` naming
    the cause. ``interpret=True`` runs the kernel under the Pallas
    interpreter (CPU tests).
    """
    from .ops.fused_hmc import make_fused_transition

    base = build_hmc_kernel(
        potential_fn, num_steps=num_steps, temperature=temperature,
        constants=constants, divergence_threshold=divergence_threshold)
    vg = batched_value_and_grad(potential_fn)
    beta = constants.beta(temperature)
    transition = make_fused_transition(
        vg, num_dims=num_dims, num_steps=num_steps,
        divergence_threshold=divergence_threshold, interpret=interpret)

    def step(key: Array, state: HMCState, step_size: Array,
             mass: Optional[Array] = None) -> tuple[HMCState, HMCInfo]:
        ens = state.ensemble
        if mass is None:
            mass = ens.mass
        dtype = ens.q.dtype
        key_mom, key_acc = jax.random.split(key)
        p_std = thermal_momentum_std(mass, temperature, constants)
        p0 = p_std * jax.random.normal(key_mom, ens.p.shape, dtype=dtype)
        log_u = jnp.log(jax.random.uniform(
            key_acc, (ens.num_walkers,), dtype=dtype,
            minval=jnp.finfo(dtype).tiny))
        q1, p1, u1, g1, accept_prob, accepted, energy_error = transition(
            ens.q, state.potential_energy, state.grad, p0, log_u, mass,
            step_size, beta)
        new_state = HMCState(
            ensemble=ens.replace(q=q1, p=p1, mass=mass),
            potential_energy=u1, grad=g1)
        info = HMCInfo(
            accept_prob=accept_prob,
            accepted=accepted,
            energy_error=energy_error,
            divergent=energy_error > divergence_threshold,
            potential_energy=u1,
            step_size=jnp.asarray(step_size),
        )
        return new_state, info

    return HMCKernel(init=base.init, step=step, num_steps=num_steps,
                     grad_evals_per_step=1, kind="fused")


def build_dense_hmc_kernel(
    potential_fn: Callable[[Array], Array],
    *,
    num_steps: int,
    temperature: Union[float, Array] = 1.0,
    constants: Constants = NATURAL,
    divergence_threshold: float = 1000.0,
) -> HMCKernel:
    """HMC transition with a DENSE metric (full mass matrix M = Sigma^-1).

    The reference's mass is a per-walker scalar (reference
    ensemble.py:38-43); the diagonal metric of :func:`run_hmc` already
    generalises it. This kernel goes one further — the Stan "dense_e"
    analog: the sampler consumes the COVARIANCE Sigma directly (never M),
    so every metric-dependent operation is a [W, D] x [D, D] matmul:

      momentum draw   p = sqrt(k_B T) * z @ inv_chol,
                      inv_chol = inv(cholesky(Sigma))  (cov(p) = k_B T M)
      drift           q += dt * p @ Sigma              (M^-1 p = Sigma p)
      kinetic energy  0.5 * sum(p * (p @ Sigma))       (p^T M^-1 p)

    No per-step triangular solves, no explicit inverse of Sigma anywhere
    in the hot loop. ``step(key, state, step_size, cov=Sigma,
    inv_chol=...)`` takes the metric as TRACED arguments, so one compiled
    kernel serves every warmup refinement of Sigma.
    """
    vg = batched_value_and_grad(potential_fn)
    beta = constants.beta(temperature)

    def init(q: Array, *, mass: Union[float, Array] = 1.0) -> HMCState:
        q = jnp.asarray(q)
        if q.ndim != 2:
            raise ValueError(
                f"init positions must be [num_walkers, num_dims]; got "
                f"shape {q.shape}")
        u, g = vg(q)
        ens = EnsembleState(
            q=q, p=jnp.zeros_like(q),
            mass=jnp.asarray(mass, q.dtype),
            log_weight=jnp.zeros(q.shape[:1], dtype=q.dtype))
        return HMCState(ensemble=ens, potential_energy=u, grad=g)

    kBT = 1.0 / beta

    def step(key: Array, state: HMCState, step_size: Array,
             cov: Array, inv_chol: Array) -> tuple[HMCState, HMCInfo]:
        ens = state.ensemble
        key_mom, key_acc = jax.random.split(key)
        z = jax.random.normal(key_mom, ens.q.shape, dtype=ens.q.dtype)
        p0 = jnp.sqrt(kBT).astype(ens.q.dtype) * (z @ inv_chol)

        def ke(p):
            return 0.5 * jnp.sum(p * (p @ cov), axis=-1)

        dt = step_size

        def body(carry, _):
            q, p, u, g = carry
            p = p - (0.5 * dt) * g
            q = q + dt * (p @ cov)
            u, g = vg(q)
            p = p - (0.5 * dt) * g
            return (q, p, u, g), None

        (q1, p1, u1, g1), _ = jax.lax.scan(
            body, (ens.q, p0, state.potential_energy, state.grad),
            None, length=num_steps)
        p1 = -p1

        h0 = ke(p0) + state.potential_energy
        h1 = ke(p1) + u1
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
                p=jnp.where(sel, p1, p0)),
            potential_energy=jnp.where(accepted, u1,
                                       state.potential_energy),
            grad=jnp.where(sel, g1, state.grad))
        info = HMCInfo(
            accept_prob=accept_prob, accepted=accepted,
            energy_error=energy_error, divergent=divergent,
            potential_energy=new_state.potential_energy,
            step_size=jnp.asarray(step_size))
        return new_state, info

    return HMCKernel(init=init, step=step, num_steps=num_steps,
                     grad_evals_per_step=1, kind="dense")


def _run_hmc_dense(
    key, potential_fn, init_q, *, num_warmup, num_samples, num_steps,
    init_step_size, target_accept, adapt_step_size, adapt_mass,
    temperature, constants, collect, thin,
) -> HMCRunResult:
    """Dense-metric driver behind ``run_hmc(metric="dense")``: warmup
    jointly dual-averages the step size and streams the cross-walker
    covariance (adaptation.CovarianceState — one matmul per
    transition); between segments the regularised Sigma and
    inv(chol(Sigma)) refresh as TRACED kernel inputs (no recompiles)."""
    from .adaptation import (covariance_init, covariance_update,
                             regularized_covariance)

    kernel = build_dense_hmc_kernel(
        potential_fn, num_steps=num_steps, temperature=temperature,
        constants=constants)
    state = kernel.init(jnp.asarray(init_q))
    num_dims = state.ensemble.num_dims
    dtype = state.ensemble.q.dtype
    key, warm_key = jax.random.split(key)

    step_size = jnp.asarray(init_step_size, dtype)
    cov = jnp.eye(num_dims, dtype=dtype)
    inv_chol = jnp.eye(num_dims, dtype=dtype)

    if num_warmup > 0:
        segments = build_warmup_schedule(num_warmup, adapt_mass=adapt_mass)

        @jax.jit
        def warm_scan(carry, keys, cov, inv_chol):
            def body(carry, k):
                st, da, cst = carry
                new_st, info = kernel.step(
                    k, st, jnp.exp(da.log_step), cov, inv_chol)
                da = da_update(da, jnp.mean(info.accept_prob),
                               target=target_accept,
                               enabled=adapt_step_size)
                cst = covariance_update(cst, new_st.ensemble.q)
                return (new_st, da, cst), None
            return jax.lax.scan(body, carry, keys)

        for seg in segments:
            da = da_init(step_size)
            cst = covariance_init(num_dims, dtype)
            keys = jax.random.split(
                jax.random.fold_in(warm_key, seg.index), seg.length)
            (state, da, cst), _ = warm_scan(
                (state, da, cst), keys, cov, inv_chol)
            if adapt_step_size:
                step_size = jnp.exp(da.log_avg_step)
            if seg.update_mass and adapt_mass:
                cov = regularized_covariance(cst)
                chol = jnp.linalg.cholesky(cov)
                inv_chol = jax.scipy.linalg.solve_triangular(
                    chol, jnp.eye(num_dims, dtype=dtype), lower=True)

    # ---- sampling -------------------------------------------------------
    mean0 = jnp.zeros((num_dims,), dtype)
    m2_0 = jnp.zeros((num_dims,), dtype)
    n0 = jnp.zeros((), dtype)

    @jax.jit
    def sample_scan(state, keys, step_size, cov, inv_chol, mean0, m2_0, n0):
        def body(carry, k):
            st, mean, m2, n = carry
            new_st, info = kernel.step(k, st, step_size, cov, inv_chol)
            out = {}
            scal = {"accept": jnp.mean(info.accept_prob),
                    "div": jnp.mean(info.divergent.astype(dtype))}
            if collect == "samples":
                out["q"] = new_st.ensemble.q
            elif collect == "moments":
                q = new_st.ensemble.q
                w = q.shape[0]
                n_new = n + w
                bm = jnp.mean(q, axis=0)
                delta = bm - mean
                mean = mean + delta * (w / n_new)
                m2 = m2 + jnp.sum((q - bm) ** 2, axis=0) \
                    + delta**2 * (n * w / n_new)
                n = n_new
            return (new_st, mean, m2, n), (out, scal)
        return jax.lax.scan(body, (state, mean0, m2_0, n0), keys)

    keys = jax.random.split(key, num_samples)
    t0 = _time.perf_counter()
    (state, mean, m2, n), (outs, scals) = sample_scan(
        state, keys, step_size, cov, inv_chol, mean0, m2_0, n0)
    accept_rate = jnp.mean(scals["accept"])
    float(accept_rate)
    sampling_seconds = _time.perf_counter() - t0

    samples = None
    post_mean = post_var = None
    if collect == "samples":
        samples = outs["q"][::thin]
    elif collect == "moments":
        post_mean = mean
        post_var = m2 / jnp.maximum(n - 1.0, 1.0)

    num_walkers = state.ensemble.num_walkers
    total_grads = ((num_warmup + num_samples) * num_walkers
                   * (num_steps + 1))
    return HMCRunResult(
        state=state, samples=samples, mean=post_mean, var=post_var,
        accept_rate=accept_rate,
        divergence_rate=jnp.mean(scals["div"]),
        step_size=step_size,
        mass=1.0 / jnp.diagonal(cov),
        num_grad_evals=total_grads,
        kernel_used="dense",
        sampling_seconds=sampling_seconds,
        metric_cov=cov,
    )
