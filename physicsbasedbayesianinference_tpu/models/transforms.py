"""Bijective constraint transforms (unconstrained R^n <-> support).

HMC runs in unconstrained space; each latent site's support is mapped
through one of these bijections and the log|Jacobian| is added to the log
density. This is the machinery the reference delegates to NumPyro
(reference samples/NumpyroExamples/CoinTossExample.py:75-107 extracts
``log_density`` of models whose Uniform/HalfCauchy sites NumPyro transforms
internally; SURVEY.md §7 step 2 calls this plumbing out as the hard part).

Every transform maps elementwise (event_dim 0) unless noted:
  ``forward(x)``: unconstrained -> constrained;
  ``inverse(y)``: constrained -> unconstrained;
  ``log_det_jacobian(x)``: log|d forward / dx| at unconstrained x, same
  shape as x (summed by the caller over event dims).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

Array = jax.Array


@jax.custom_jvp
def softplus(x: Array) -> Array:
    """``log(1 + exp(x))`` with a LEAN custom derivative.

    ``jax.nn.softplus``'s autodiff re-derives sigmoid through logaddexp's
    inf/NaN guards — ~25 elementwise ops per use inside a gradient loop,
    which bounds data-heavy potentials such as logreg_32_n256 by
    elementwise work. The primal here is the same stable
    ``max(x, 0) + log1p(exp(-|x|))``; the tangent is the single
    ``lax.logistic`` primitive, so gradient jaxprs stay 2 ops.
    """
    return jnp.maximum(x, 0.0) + jnp.log1p(jnp.exp(-jnp.abs(x)))


@softplus.defjvp
def _softplus_jvp(primals, tangents):
    (x,), (t,) = primals, tangents
    # sigmoid via the exact tanh identity: one transcendental per
    # element, with the 0.5 scalings left for XLA to fuse.
    return softplus(x), (0.5 * jnp.tanh(0.5 * x) + 0.5) * t


@dataclasses.dataclass(frozen=True)
class Transform:
    """Identity: support = all reals. ``name`` is a class attribute, not a
    dataclass field (keeps subclass constructors positional over their own
    parameters)."""

    name = "identity"

    def forward(self, x: Array) -> Array:
        return x

    def inverse(self, y: Array) -> Array:
        return y

    def log_det_jacobian(self, x: Array) -> Array:
        return jnp.zeros_like(x)


IDENTITY = Transform()


@dataclasses.dataclass(frozen=True)
class ExpTransform(Transform):
    """y = exp(x): support = positive reals. log|J| = x."""

    name = "exp"

    def forward(self, x: Array) -> Array:
        return jnp.exp(x)

    def inverse(self, y: Array) -> Array:
        return jnp.log(y)

    def log_det_jacobian(self, x: Array) -> Array:
        return x


POSITIVE = ExpTransform()


@dataclasses.dataclass(frozen=True)
class IntervalTransform(Transform):
    """y = lo + (hi - lo) * sigmoid(x): support = (lo, hi).

    log|J| = log(hi - lo) - softplus(x) - softplus(-x), computed in log
    space (float32-safe; never log(sigmoid)).
    """

    lo: float = 0.0
    hi: float = 1.0
    name = "interval"

    def forward(self, x: Array) -> Array:
        return self.lo + (self.hi - self.lo) * jax.nn.sigmoid(x)

    def inverse(self, y: Array) -> Array:
        u = (y - self.lo) / (self.hi - self.lo)
        return jnp.log(u) - jnp.log1p(-u)

    def log_det_jacobian(self, x: Array) -> Array:
        return (jnp.log(self.hi - self.lo)
                - softplus(x) - softplus(-x))


UNIT_INTERVAL = IntervalTransform(0.0, 1.0)


@dataclasses.dataclass(frozen=True)
class OrderedTransform(Transform):
    """y_0 = x_0; y_i = y_{i-1} + exp(x_i): support = increasing vectors.

    Event dim 1 (acts on the last axis). log|J| = sum_{i>0} x_i.
    """

    name = "ordered"

    def forward(self, x: Array) -> Array:
        first = x[..., :1]
        rest = jnp.exp(x[..., 1:])
        return jnp.concatenate([first, first + jnp.cumsum(rest, axis=-1)],
                               axis=-1)

    def inverse(self, y: Array) -> Array:
        first = y[..., :1]
        rest = jnp.log(jnp.diff(y, axis=-1))
        return jnp.concatenate([first, rest], axis=-1)

    def log_det_jacobian(self, x: Array) -> Array:
        # Returned elementwise (zero at index 0) so the caller's sum over
        # the event axis gives the correct total.
        return jnp.asarray(x).at[..., 0].set(0.0)


ORDERED = OrderedTransform()
