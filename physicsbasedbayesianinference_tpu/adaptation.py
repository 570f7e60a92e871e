"""Warmup adaptation: dual-averaging step size + cross-walker metric.

The reference schedules these capabilities but never implemented them: its
algorithm notes specify dual averaging and the NUTS acceptance-statistic
machinery (reference references/NotesOnParticleBasedHMC.pdf;
references/TheNoUTurnSampler_[Hoffman_Gelman].pdf is checked in), and the
week plan lists step-size adaptation (reference
references/PhysicsBasedHMC_SoHPC2022_WeekPlan.md). This module supplies both,
designed for the ensemble setting:

* **Dual averaging** (Nesterov primal-dual; Hoffman & Gelman 2014, §3.2) on
  the *ensemble-mean* acceptance probability. With W walkers the acceptance
  statistic per transition has variance ~1/W of a single chain's, so the
  step size converges in far fewer warmup iterations — an ensemble-native
  advantage. The mean is a ``psum``-shaped reduction when sharded.
* **Cross-walker variance metric**: the diagonal metric (mass = 1/var) is
  estimated by streaming Welford moments over (step, walker) pairs; one
  time-slice of 10^4+ walkers already pins the posterior scale, where a
  single chain needs hundreds of draws.

All state is scalar/O(D) pytrees living inside the warmup ``lax.scan``.
"""

from __future__ import annotations

import dataclasses
from typing import List

import jax
import jax.numpy as jnp

from .utils import struct

Array = jax.Array


# ---------------------------------------------------------------------------
# Dual averaging (step size)
# ---------------------------------------------------------------------------


@struct.dataclass
class DualAveragingState:
    log_step: Array
    log_avg_step: Array
    h_bar: Array
    t: Array
    mu: Array


def da_init(step_size, *, mu_factor: float = 10.0) -> DualAveragingState:
    log_step = jnp.log(jnp.asarray(step_size))
    z = jnp.zeros_like(log_step)
    return DualAveragingState(
        log_step=log_step,
        log_avg_step=log_step,
        h_bar=z,
        t=z,
        mu=jnp.log(mu_factor) + log_step,
    )


def da_update(
    state: DualAveragingState,
    accept_prob: Array,
    *,
    target: float = 0.8,
    gamma: float = 0.05,
    t0: float = 10.0,
    kappa: float = 0.75,
    enabled: bool = True,
) -> DualAveragingState:
    """One dual-averaging update from the ensemble-mean acceptance.

    Standard parameters from Hoffman & Gelman (2014), eq. (6).
    """
    if not enabled:
        return state
    t = state.t + 1.0
    eta_h = 1.0 / (t + t0)
    h_bar = (1.0 - eta_h) * state.h_bar + eta_h * (target - accept_prob)
    log_step = state.mu - jnp.sqrt(t) / gamma * h_bar
    eta = t ** (-kappa)
    log_avg_step = eta * log_step + (1.0 - eta) * state.log_avg_step
    return DualAveragingState(
        log_step=log_step, log_avg_step=log_avg_step, h_bar=h_bar, t=t,
        mu=state.mu)


# ---------------------------------------------------------------------------
# Streaming cross-walker variance (diagonal metric)
# ---------------------------------------------------------------------------


@struct.dataclass
class VarianceState:
    mean: Array  # [D]
    m2: Array  # [D]
    count: Array  # scalar


def variance_init(num_dims: int, dtype=jnp.float32) -> VarianceState:
    return VarianceState(
        mean=jnp.zeros((num_dims,), dtype),
        m2=jnp.zeros((num_dims,), dtype),
        count=jnp.zeros((), dtype),
    )


def _valid_rows(q: Array, max_abs: float) -> Array:
    """[W] mask of walkers safe to stream into a metric estimate.

    A finite-but-huge position (|q| ~ 1e13+ in f32) OVERFLOWS the squared
    cross-moments even though q itself is representable, and one poisoned
    slab makes the covariance NaN -> cholesky NaN -> every subsequent
    proposal rejected -> dual averaging drives the step to zero (the
    dense-warmup death spiral found in r4). Such walkers are divergent
    transients of the not-yet-adapted sampler, not posterior information
    — excluding them from the ESTIMATE (never from the chain itself)
    leaves the adapted metric unbiased and the stream finite."""
    return jnp.all(jnp.isfinite(q) & (jnp.abs(q) < max_abs), axis=-1)


def variance_update(state: VarianceState, q: Array, *,
                    max_abs: float = 1e6) -> VarianceState:
    """Chan et al. parallel-Welford batch update with a [W, D] slab
    (rows failing :func:`_valid_rows` are excluded — see there).

    The per-dimension reductions over walkers become psum collectives under
    sharding.
    """
    valid = _valid_rows(q, max_abs)
    w = jnp.sum(valid.astype(q.dtype))
    n_new = state.count + w
    vcol = valid[:, None].astype(q.dtype)
    # zero non-finite ENTRIES before any masked arithmetic: 0 * inf = NaN
    qf = jnp.where(jnp.isfinite(q), q, 0.0)
    batch_mean = jnp.sum(qf * vcol, axis=0) / jnp.maximum(w, 1.0)
    delta = batch_mean - state.mean
    mean = state.mean + delta * (w / jnp.maximum(n_new, 1.0))
    batch_m2 = jnp.sum(((qf - batch_mean) * vcol) ** 2, axis=0)
    m2 = state.m2 + batch_m2 \
        + delta**2 * (state.count * w / jnp.maximum(n_new, 1.0))
    return VarianceState(mean=mean, m2=m2, count=n_new)


def regularized_mass(state: VarianceState, *, shrink: float = 5.0,
                     floor: float = 1e-3) -> Array:
    """Regularised variance estimate (Stan-style shrinkage toward identity):

    var_reg = n/(n+shrink) * var + floor * shrink/(n+shrink). Returns the
    variance; the metric (mass) is its reciprocal.
    """
    n = jnp.maximum(state.count, 2.0)
    var = state.m2 / (n - 1.0)
    w = n / (n + shrink)
    return w * var + (1.0 - w) * floor


# ---------------------------------------------------------------------------
# Cross-walker DENSE covariance (full-metric adaptation)
# ---------------------------------------------------------------------------


@struct.dataclass
class CovarianceState:
    """Streaming full covariance over (step, walker) pairs — the dense
    analog of :class:`VarianceState`. With 10^4+ walkers one time-slice
    already pins the posterior covariance (a single chain needs O(D)
    *correlated* draws just to make it full-rank), which is what makes a
    dense metric practical in the ensemble setting. The [W, D]^T [W, D]
    cross-moment update is one matmul per transition."""

    mean: Array   # [D]
    m2: Array     # [D, D] centered cross-moment sum
    count: Array  # scalar


def covariance_init(num_dims: int, dtype=jnp.float32) -> CovarianceState:
    return CovarianceState(
        mean=jnp.zeros((num_dims,), dtype),
        m2=jnp.zeros((num_dims, num_dims), dtype),
        count=jnp.zeros((), dtype),
    )


def covariance_update(state: CovarianceState, q: Array, *,
                      max_abs: float = 1e6) -> CovarianceState:
    """Chan et al. batch merge with a [W, D] slab (dense form; rows
    failing :func:`_valid_rows` are excluded — see there)."""
    valid = _valid_rows(q, max_abs)
    w = jnp.sum(valid.astype(q.dtype))
    n_new = state.count + w
    vcol = valid[:, None].astype(q.dtype)
    # zero non-finite ENTRIES before any masked arithmetic: 0 * inf = NaN
    qf = jnp.where(jnp.isfinite(q), q, 0.0)
    batch_mean = jnp.sum(qf * vcol, axis=0) / jnp.maximum(w, 1.0)
    delta = batch_mean - state.mean
    mean = state.mean + delta * (w / jnp.maximum(n_new, 1.0))
    qc = (qf - batch_mean) * vcol
    batch_m2 = qc.T @ qc
    m2 = state.m2 + batch_m2 \
        + jnp.outer(delta, delta) * (state.count * w
                                     / jnp.maximum(n_new, 1.0))
    return CovarianceState(mean=mean, m2=m2, count=n_new)


def regularized_covariance(state: CovarianceState, *, shrink: float = 5.0,
                           floor: float = 1e-3) -> Array:
    """Stan-style shrinkage toward a scaled identity:

    cov_reg = n/(n+shrink) * cov + floor * shrink/(n+shrink) * I.
    Returns the covariance Sigma; the metric (mass matrix) is its
    inverse, and samplers consume Sigma directly (drift q += dt * p @
    Sigma; momentum draw through inv(chol(Sigma)))."""
    n = jnp.maximum(state.count, 2.0)
    cov = state.m2 / (n - 1.0)
    w = n / (n + shrink)
    eye = jnp.eye(cov.shape[0], dtype=cov.dtype)
    return w * cov + (1.0 - w) * floor * eye


# ---------------------------------------------------------------------------
# Warmup schedule
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WarmupSegment:
    index: int
    length: int
    update_mass: bool


def build_warmup_schedule(num_warmup: int, *, adapt_mass: bool = True
                          ) -> List[WarmupSegment]:
    """Stan-like three-phase warmup, compressed for the ensemble setting.

    Phase 1 (~15%): step size only (find the typical set).
    Phase 2 (~60%, split into expanding windows): step size + metric;
      the metric is refreshed (and dual averaging restarted) at each window
      boundary.
    Phase 3 (~25%): step size only, under the final metric.

    With cross-walker variance estimation the windows can be much shorter
    than Stan's single-chain defaults.
    """
    if num_warmup <= 0:
        return []
    if not adapt_mass or num_warmup < 20:
        return [WarmupSegment(0, num_warmup, update_mass=False)]

    n1 = max(1, int(0.15 * num_warmup))
    n3 = max(1, int(0.25 * num_warmup))
    n2 = num_warmup - n1 - n3
    segments = [WarmupSegment(0, n1, update_mass=False)]
    # expanding windows: w, 2w, 4w ... covering n2
    num_windows = 3 if n2 >= 12 else 1
    base = n2 // (2**num_windows - 1) if num_windows > 1 else n2
    base = max(base, 1)
    used = 0
    idx = 1
    for k in range(num_windows):
        length = base * (2**k)
        if k == num_windows - 1:
            length = n2 - used
        length = max(length, 1)
        used += length
        segments.append(WarmupSegment(idx, length, update_mass=True))
        idx += 1
    segments.append(WarmupSegment(idx, n3, update_mass=False))
    return segments
