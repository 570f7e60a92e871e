"""Probability distributions for the native model DSL.

The distribution vocabulary the reference's example models draw on
(reference samples/NumpyroExamples/CoinToss/CoinToss.py:19-22 uses
Uniform + Bernoulli; eight_schools.py:5-10 uses Normal + HalfCauchy), plus
the standard companions needed for the BASELINE.json model configs
(logistic regression, hierarchical models).

All log-probabilities are written directly in log space (never
``log(pdf)``), float32-safe on accelerators — the reference requires
float64 to avoid NaN gradients precisely because it exponentiates then
re-logs (reference HMC.py:17,84; SURVEY.md §7 risks).

Each distribution provides:
  ``log_prob(value)`` elementwise over broadcast batch shape;
  ``sample(key, shape)`` draws;
  ``support`` a transform from transforms.py (None for discrete
  distributions, which can only be observed, not latent — HMC needs a
  continuous unconstrained parameterisation);
  ``batch_shape`` / ``event_dim``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
from jax.scipy import special as jsp

from . import transforms as tfm

Array = jax.Array


def _bshape(*params) -> tuple:
    return jnp.broadcast_shapes(*(jnp.shape(p) for p in params))


class Distribution:
    """Base (plain class — subclasses are frozen dataclasses of array-like
    params, or plain classes where the support depends on the params)."""

    event_dim = 0
    support: Optional[tfm.Transform] = tfm.IDENTITY

    @property
    def batch_shape(self) -> tuple:
        return ()

    def log_prob(self, value: Array) -> Array:
        raise NotImplementedError

    def sample(self, key: Array, shape: tuple = ()) -> Array:
        raise NotImplementedError

    @property
    def is_discrete(self) -> bool:
        return self.support is None


def _field(v):
    return jnp.asarray(v, dtype=jnp.result_type(float, v))


@dataclasses.dataclass(frozen=True)
class Normal(Distribution):
    loc: Array = 0.0
    scale: Array = 1.0

    @property
    def batch_shape(self):
        return _bshape(self.loc, self.scale)

    def log_prob(self, value):
        loc, scale = _field(self.loc), _field(self.scale)
        z = (value - loc) / scale
        return -0.5 * z * z - jnp.log(scale) - 0.5 * jnp.log(2.0 * jnp.pi)

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, self.batch_shape)
        return _field(self.loc) + _field(self.scale) * jax.random.normal(
            key, shape)


@dataclasses.dataclass(frozen=True)
class HalfNormal(Distribution):
    scale: Array = 1.0
    support = tfm.POSITIVE

    @property
    def batch_shape(self):
        return _bshape(self.scale)

    def log_prob(self, value):
        scale = _field(self.scale)
        z = value / scale
        return (jnp.log(2.0) - 0.5 * z * z - jnp.log(scale)
                - 0.5 * jnp.log(2.0 * jnp.pi))

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, self.batch_shape)
        return jnp.abs(_field(self.scale) * jax.random.normal(key, shape))


@dataclasses.dataclass(frozen=True)
class Cauchy(Distribution):
    loc: Array = 0.0
    scale: Array = 1.0

    @property
    def batch_shape(self):
        return _bshape(self.loc, self.scale)

    def log_prob(self, value):
        loc, scale = _field(self.loc), _field(self.scale)
        z = (value - loc) / scale
        return -jnp.log(jnp.pi) - jnp.log(scale) - jnp.log1p(z * z)

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, self.batch_shape)
        return _field(self.loc) + _field(self.scale) * jax.random.cauchy(
            key, shape)


@dataclasses.dataclass(frozen=True)
class HalfCauchy(Distribution):
    """Reference eight_schools.py:7: ``tau = sample("tau", HalfCauchy(5))``."""

    scale: Array = 1.0
    support = tfm.POSITIVE

    @property
    def batch_shape(self):
        return _bshape(self.scale)

    def log_prob(self, value):
        scale = _field(self.scale)
        z = value / scale
        return (jnp.log(2.0) - jnp.log(jnp.pi) - jnp.log(scale)
                - jnp.log1p(z * z))

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, self.batch_shape)
        return jnp.abs(_field(self.scale) * jax.random.cauchy(key, shape))


class Uniform(Distribution):
    """Reference CoinToss.py:19-20: ``theta = sample("p1", Uniform(0, 1))``.

    Not a frozen dataclass because ``support`` depends on the bounds
    (they define the unconstrained bijection). Bounds may be scalars or
    arrays (e.g. per-plate-site bounds); arrays broadcast elementwise
    through the interval bijection and its Jacobian.
    """

    event_dim = 0

    def __init__(self, lo=0.0, hi=1.0):
        self.lo = jnp.asarray(lo) if jnp.ndim(lo) else float(lo)
        self.hi = jnp.asarray(hi) if jnp.ndim(hi) else float(hi)
        self.support = tfm.IntervalTransform(self.lo, self.hi)

    @property
    def batch_shape(self):
        return _bshape(self.lo, self.hi)

    def log_prob(self, value):
        value = jnp.asarray(value)
        in_support = (value >= self.lo) & (value <= self.hi)
        lp = jnp.broadcast_to(
            -jnp.log(jnp.asarray(self.hi, jnp.result_type(float, value))
                     - self.lo),
            jnp.broadcast_shapes(jnp.shape(value), self.batch_shape))
        return jnp.where(in_support, lp, -jnp.inf)

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, self.batch_shape)
        u = jax.random.uniform(key, shape)
        return self.lo + (self.hi - self.lo) * u


@dataclasses.dataclass(frozen=True)
class Exponential(Distribution):
    rate: Array = 1.0
    support = tfm.POSITIVE

    @property
    def batch_shape(self):
        return _bshape(self.rate)

    def log_prob(self, value):
        rate = _field(self.rate)
        return jnp.log(rate) - rate * value

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, self.batch_shape)
        return jax.random.exponential(key, shape) / _field(self.rate)


@dataclasses.dataclass(frozen=True)
class Gamma(Distribution):
    concentration: Array = 1.0
    rate: Array = 1.0
    support = tfm.POSITIVE

    @property
    def batch_shape(self):
        return _bshape(self.concentration, self.rate)

    def log_prob(self, value):
        a, b = _field(self.concentration), _field(self.rate)
        return (a * jnp.log(b) + (a - 1.0) * jnp.log(value) - b * value
                - jsp.gammaln(a))

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, self.batch_shape)
        return jax.random.gamma(key, _field(self.concentration),
                                shape) / _field(self.rate)


@dataclasses.dataclass(frozen=True)
class InverseGamma(Distribution):
    """Conjugate variance prior: value ~ InvGamma(a, b) iff 1/value ~
    Gamma(a, rate=b)."""

    concentration: Array = 1.0
    scale: Array = 1.0
    support = tfm.POSITIVE

    @property
    def batch_shape(self):
        return _bshape(self.concentration, self.scale)

    def log_prob(self, value):
        a, b = _field(self.concentration), _field(self.scale)
        return (a * jnp.log(b) - (a + 1.0) * jnp.log(value)
                - b / value - jsp.gammaln(a))

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, self.batch_shape)
        return _field(self.scale) / jax.random.gamma(
            key, _field(self.concentration), shape)


@dataclasses.dataclass(frozen=True)
class Weibull(Distribution):
    """Weibull(concentration k, scale lambda): the standard survival /
    reliability prior."""

    concentration: Array = 1.0
    scale: Array = 1.0
    support = tfm.POSITIVE

    @property
    def batch_shape(self):
        return _bshape(self.concentration, self.scale)

    def log_prob(self, value):
        k, lam = _field(self.concentration), _field(self.scale)
        z = value / lam
        return (jnp.log(k) - jnp.log(lam) + (k - 1.0) * jnp.log(z)
                - z**k)

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, self.batch_shape)
        u = jax.random.uniform(key, shape,
                               minval=jnp.finfo(jnp.float32).tiny)
        return _field(self.scale) * (-jnp.log(u)) ** (
            1.0 / _field(self.concentration))


@dataclasses.dataclass(frozen=True)
class Beta(Distribution):
    a: Array = 1.0
    b: Array = 1.0
    support = tfm.UNIT_INTERVAL

    @property
    def batch_shape(self):
        return _bshape(self.a, self.b)

    def log_prob(self, value):
        a, b = _field(self.a), _field(self.b)
        return ((a - 1.0) * jnp.log(value) + (b - 1.0) * jnp.log1p(-value)
                - jsp.betaln(a, b))

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, self.batch_shape)
        return jax.random.beta(key, _field(self.a), _field(self.b), shape)


@dataclasses.dataclass(frozen=True)
class LogNormal(Distribution):
    loc: Array = 0.0
    scale: Array = 1.0
    support = tfm.POSITIVE

    @property
    def batch_shape(self):
        return _bshape(self.loc, self.scale)

    def log_prob(self, value):
        loc, scale = _field(self.loc), _field(self.scale)
        logv = jnp.log(value)
        z = (logv - loc) / scale
        return (-0.5 * z * z - jnp.log(scale)
                - 0.5 * jnp.log(2.0 * jnp.pi) - logv)

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, self.batch_shape)
        return jnp.exp(_field(self.loc)
                       + _field(self.scale) * jax.random.normal(key, shape))


@dataclasses.dataclass(frozen=True)
class StudentT(Distribution):
    df: Array = 1.0
    loc: Array = 0.0
    scale: Array = 1.0

    @property
    def batch_shape(self):
        return _bshape(self.df, self.loc, self.scale)

    def log_prob(self, value):
        df, loc, scale = _field(self.df), _field(self.loc), _field(self.scale)
        z = (value - loc) / scale
        return (jsp.gammaln(0.5 * (df + 1.0)) - jsp.gammaln(0.5 * df)
                - 0.5 * jnp.log(df * jnp.pi) - jnp.log(scale)
                - 0.5 * (df + 1.0) * jnp.log1p(z * z / df))

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, self.batch_shape)
        return _field(self.loc) + _field(self.scale) * jax.random.t(
            key, _field(self.df), shape)


@dataclasses.dataclass(frozen=True)
class Laplace(Distribution):
    loc: Array = 0.0
    scale: Array = 1.0

    @property
    def batch_shape(self):
        return _bshape(self.loc, self.scale)

    def log_prob(self, value):
        loc, scale = _field(self.loc), _field(self.scale)
        return -jnp.abs(value - loc) / scale - jnp.log(2.0 * scale)

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, self.batch_shape)
        return _field(self.loc) + _field(self.scale) * jax.random.laplace(
            key, shape)


# -- discrete (observation-only for HMC) ------------------------------------


@dataclasses.dataclass(frozen=True)
class Bernoulli(Distribution):
    """Reference CoinToss.py:22: ``sample("obs1", Bernoulli(theta), obs=c1)``.

    log p(x) computed via xlogy for p in {0, 1} safety.
    """

    probs: Array = 0.5
    support = None

    @property
    def batch_shape(self):
        return _bshape(self.probs)

    def log_prob(self, value):
        p = _field(self.probs)
        return jsp.xlogy(value, p) + jsp.xlog1py(1.0 - value, -p)

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, self.batch_shape)
        return jax.random.bernoulli(
            key, _field(self.probs), shape).astype(jnp.int32)


@dataclasses.dataclass(frozen=True)
class BernoulliLogits(Distribution):
    """Bernoulli parameterised by logits (the numerically right choice for
    logistic regression, BASELINE.json config 3):
    log p = value * logits - softplus(logits)."""

    logits: Array = 0.0
    support = None

    @property
    def batch_shape(self):
        return _bshape(self.logits)

    def log_prob(self, value):
        logits = _field(self.logits)
        # tfm.softplus: lean custom derivative (single lax.logistic) so
        # fused-kernel gradient loops stay off the VPU-bound logaddexp
        # guard chain jax.nn.softplus's autodiff produces
        return value * logits - tfm.softplus(logits)

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, self.batch_shape)
        return jax.random.bernoulli(
            key, jax.nn.sigmoid(_field(self.logits)), shape).astype(jnp.int32)


@dataclasses.dataclass(frozen=True)
class Binomial(Distribution):
    total_count: Array = 1
    probs: Array = 0.5
    support = None

    @property
    def batch_shape(self):
        return _bshape(self.total_count, self.probs)

    def log_prob(self, value):
        n = jnp.asarray(self.total_count)
        p = _field(self.probs)
        logcomb = (jsp.gammaln(n + 1.0) - jsp.gammaln(value + 1.0)
                   - jsp.gammaln(n - value + 1.0))
        return logcomb + jsp.xlogy(value, p) + jsp.xlog1py(n - value, -p)

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, self.batch_shape)
        n = int(jnp.max(jnp.asarray(self.total_count)))
        draws = jax.random.bernoulli(
            key, _field(self.probs), (n,) + shape)
        return jnp.sum(draws, axis=0).astype(jnp.int32)


@dataclasses.dataclass(frozen=True)
class Poisson(Distribution):
    rate: Array = 1.0
    support = None

    @property
    def batch_shape(self):
        return _bshape(self.rate)

    def log_prob(self, value):
        rate = _field(self.rate)
        return jsp.xlogy(value, rate) - rate - jsp.gammaln(value + 1.0)

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, self.batch_shape)
        return jax.random.poisson(key, _field(self.rate), shape)


@dataclasses.dataclass(frozen=True)
class NegativeBinomial(Distribution):
    """Overdispersed counts, (total_count r, probs p) parameterisation:
    log p(k) = log C(k + r - 1, k) + r log(1-p) + k log p."""

    total_count: Array = 1.0
    probs: Array = 0.5
    support = None

    @property
    def batch_shape(self):
        return _bshape(self.total_count, self.probs)

    def log_prob(self, value):
        r, p = _field(self.total_count), _field(self.probs)
        return (jsp.gammaln(value + r) - jsp.gammaln(r)
                - jsp.gammaln(value + 1.0)
                + r * jnp.log1p(-p) + jsp.xlogy(value, p))

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, self.batch_shape)
        k_g, k_p = jax.random.split(key)
        lam = jax.random.gamma(key=k_g, a=_field(self.total_count),
                               shape=shape) \
            * _field(self.probs) / (1.0 - _field(self.probs))
        return jax.random.poisson(k_p, lam, shape)


@dataclasses.dataclass(frozen=True)
class Categorical(Distribution):
    """Categorical over the last axis of ``logits`` (observation-only for
    HMC, like every discrete distribution here)."""

    logits: Array = None  # [..., K]
    support = None

    @property
    def batch_shape(self):
        return jnp.shape(self.logits)[:-1]

    def log_prob(self, value):
        logits = _field(self.logits)
        norm = logits - jsp.logsumexp(logits, axis=-1, keepdims=True)
        value = jnp.asarray(value, jnp.int32)
        return jnp.take_along_axis(
            norm, value[..., None], axis=-1)[..., 0]

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, self.batch_shape)
        return jax.random.categorical(key, _field(self.logits),
                                      shape=shape)


# -- multivariate ------------------------------------------------------------


class MultivariateNormal(Distribution):
    """MVN with dense covariance (event_dim 1). The quadratic form is a
    matmul over the event axis — a matmul when batched over walkers."""

    event_dim = 1
    support = tfm.IDENTITY

    def __init__(self, loc, cov=None, scale_tril=None):
        self.loc = jnp.asarray(loc, dtype=jnp.result_type(float, loc))
        if scale_tril is None:
            if cov is None:
                raise ValueError("need cov or scale_tril")
            scale_tril = jnp.linalg.cholesky(
                jnp.asarray(cov, dtype=self.loc.dtype))
        self.scale_tril = jnp.asarray(scale_tril, dtype=self.loc.dtype)

    @property
    def batch_shape(self):
        return jnp.broadcast_shapes(
            self.loc.shape[:-1], self.scale_tril.shape[:-2])

    @property
    def event_shape(self):
        return self.loc.shape[-1:]

    def log_prob(self, value):
        d = value - self.loc
        z = jax.scipy.linalg.solve_triangular(
            self.scale_tril, d[..., None], lower=True)[..., 0]
        half_logdet = jnp.sum(
            jnp.log(jnp.diagonal(self.scale_tril, axis1=-2, axis2=-1)),
            axis=-1)
        k = self.loc.shape[-1]
        return (-0.5 * jnp.sum(z * z, axis=-1) - half_logdet
                - 0.5 * k * jnp.log(2.0 * jnp.pi))

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, self.batch_shape)
        eps = jax.random.normal(key, shape + self.event_shape)
        return self.loc + jnp.einsum("...ij,...j->...i", self.scale_tril, eps)


__all__ = [
    "Distribution", "Normal", "HalfNormal", "Cauchy", "HalfCauchy",
    "Uniform", "Exponential", "Gamma", "Beta", "LogNormal", "StudentT",
    "Laplace", "InverseGamma", "Weibull",
    "Bernoulli", "BernoulliLogits", "Binomial", "Poisson",
    "NegativeBinomial", "Categorical",
    "MultivariateNormal",
]
