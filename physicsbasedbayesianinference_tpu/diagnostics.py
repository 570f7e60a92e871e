"""MCMC diagnostics and observability, computed on device.

The reference computes per-walker acceptance probabilities and discards
them (reference HMC.py:168; SURVEY.md §5 "no acceptance-rate reporting
exists"), and its only observability is ``print`` statements
(HMC.py:118-121,151-152). This module supplies the quantitative layer:

* effective sample size via initial-positive-sequence autocorrelation
  (Geyer 1992), batched over walkers and dims on device;
* split-R-hat (Gelman-Rubin) across walkers — an ensemble sampler gets
  this diagnostic almost for free, the per-walker chains are the "chains";
* posterior summaries (mean/sd/quantiles) in one pass;
* ``trace_annotation`` wrapping ``jax.profiler.TraceAnnotation`` so hot
  sections show up named in device profiles (the upgrade path from the
  reference's cProfile harness, test_integrator_benchmarks_*.py:71-77);
* a tiny metrics logger: per-iteration scalar dict -> host-side log lines
  at a configurable cadence (the reference prints every 100 iterations,
  HMC.py:151-152).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp

Array = jax.Array


# ---------------------------------------------------------------------------
# Effective sample size / autocorrelation
# ---------------------------------------------------------------------------


def autocorrelation(x: Array, max_lag: Optional[int] = None) -> Array:
    """Normalised autocorrelation over the leading (time) axis via FFT
    (O(T log T); the per-lag loop the naive estimator needs would not
    fuse). x: [T, ...] -> [max_lag, ...]."""
    t = x.shape[0]
    if max_lag is None:
        max_lag = t
    x = x - jnp.mean(x, axis=0, keepdims=True)
    n_fft = 2 * t
    f = jnp.fft.rfft(x, n=n_fft, axis=0)
    acov = jnp.fft.irfft(f * jnp.conj(f), n=n_fft, axis=0)[:t]
    acov = acov / jnp.arange(t, 0, -1).reshape((-1,) + (1,) * (x.ndim - 1))
    return (acov / acov[0])[:max_lag]


def effective_sample_size(samples: Array,
                          max_lag: Optional[int] = None) -> Array:
    """ESS per dimension from [T, W, D] samples: walker-averaged
    autocorrelations (the many-chain estimator) with Geyer (1992)
    initial-monotone truncation.

    Lag pairs Gamma_m = rho_{2m} + rho_{2m+1} are (a) truncated at the
    first non-positive pair (initial positive sequence) and (b) clamped to
    be non-increasing (initial monotone) — so tau adapts to however slowly
    the chain mixes instead of being cut at a fixed window (a fixed
    ``max_lag`` truncates tau and OVERestimates ESS for slow chains).
    ``max_lag=None`` uses every available lag; the FFT makes that free.
    tau = -1 + 2 sum_m Gamma_m (rho_0 = 1 included), ESS = T*W / tau.
    """
    t, w = samples.shape[0], samples.shape[1]
    rho = jnp.mean(autocorrelation(samples, max_lag), axis=1)  # [L, D]
    num_pairs = rho.shape[0] // 2
    gamma = rho[0:2 * num_pairs:2] + rho[1:2 * num_pairs:2]   # [m, D]
    positive = jnp.cumprod(gamma > 0.0, axis=0) > 0
    gamma = jnp.where(positive, gamma, 0.0)
    gamma = jax.lax.associative_scan(jnp.minimum, gamma, axis=0)
    tau = -1.0 + 2.0 * jnp.sum(jnp.maximum(gamma, 0.0), axis=0)
    tau = jnp.maximum(tau, 1.0 / (t * w))
    return t * w / tau


def split_rhat(samples: Array) -> Array:
    """Split-R-hat per dimension from [T, W, D] samples: each walker's
    chain is split in half; R-hat = sqrt((W_var + B/T)/W_var) over the
    2*num_walkers half-chains (Gelman et al., BDA3 eq. 11.4)."""
    t = samples.shape[0] - (samples.shape[0] % 2)
    half = t // 2
    x = samples[:t]
    chains = jnp.concatenate([x[:half], x[half:]], axis=1)  # [half, 2W, D]
    mean_c = jnp.mean(chains, axis=0)          # [2W, D]
    var_c = jnp.var(chains, axis=0, ddof=1)    # [2W, D]
    w_var = jnp.mean(var_c, axis=0)
    b_var = half * jnp.var(mean_c, axis=0, ddof=1)
    var_plus = (half - 1) / half * w_var + b_var / half
    return jnp.sqrt(var_plus / w_var)


def summary(samples: Array, quantiles=(0.05, 0.5, 0.95)) -> dict:
    """Posterior summary dict from [T, W, D] samples (per dimension)."""
    flat = samples.reshape(-1, samples.shape[-1])
    qs = jnp.quantile(flat, jnp.asarray(quantiles), axis=0)
    return {
        "mean": jnp.mean(flat, axis=0),
        "sd": jnp.std(flat, axis=0),
        "quantiles": qs,
        "ess": effective_sample_size(samples),
        "rhat": split_rhat(samples),
    }


# ---------------------------------------------------------------------------
# Profiling / tracing
# ---------------------------------------------------------------------------


def trace_annotation(name: str):
    """Named profiler region (shows up in device traces via
    ``jax.profiler.trace`` / TensorBoard)."""
    return jax.profiler.TraceAnnotation(name)


@contextlib.contextmanager
def wall_clock(label: str, sink: Optional[Callable[[str], None]] = print):
    """Host-side wall-clock region (the reference's time.time() pattern,
    NBody.py:60-64, as a context manager)."""
    t0 = time.perf_counter()
    yield
    if sink is not None:
        sink(f"[{label}] {time.perf_counter() - t0:.3f}s")


@dataclasses.dataclass
class MetricsLogger:
    """Throttled scalar metrics logging (reference prints every 100th
    iteration, HMC.py:151-152; here cadence + sink are configurable and
    values arrive as jitted-scan outputs, not per-step host syncs)."""

    every: int = 100
    sink: Callable[[str], None] = print
    _count: int = dataclasses.field(default=0, init=False)

    def log(self, step: int, metrics: dict) -> None:
        if step % self.every != 0:
            return
        parts = [f"step={step}"]
        for k, v in metrics.items():
            try:
                parts.append(f"{k}={float(v):.4g}")
            except (TypeError, ValueError):
                parts.append(f"{k}={v}")
        self.sink("  ".join(parts))

    def log_series(self, metrics: dict) -> None:
        """Log a whole scan-output series ({name: [T] array}) at cadence."""
        lengths = {jnp.asarray(v).shape[0] for v in metrics.values()}
        (t,) = lengths
        for step in range(0, t, self.every):
            self.log(step, {k: jnp.asarray(v)[step]
                            for k, v in metrics.items()})
