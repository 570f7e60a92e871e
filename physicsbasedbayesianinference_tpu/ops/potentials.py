"""Analytic target potentials and N-body energies/forces.

Redesign of the reference potential library (reference
src/potential.py). Every potential here is a *pure function of a single
walker's position vector* ``q: [D] -> scalar``; the sampler batches it with
``vmap`` and differentiates it with ``value_and_grad`` — there are no
per-particle Python loops (contrast reference potential.py:88-99, an O(N^2)
double Python loop) and no finite differences on the hot path (contrast
reference ``nBodyForce``/``getForceArray`` built on
``scipy.optimize.approx_fprime``, potential.py:104-138 — autodiff replaces
them exactly; a vmapped central-difference oracle is kept as
:func:`numerical_grad`/:func:`numerical_force` for testing).

Potentials that have cheap closed-form gradients also expose them via the
``analytic_grad`` attribute, so the samplers (and the fused GPU kernel,
ops/fused_hmc.py) evaluate the force without autodiff.

Sign conventions (fixing a reference inconsistency): gravitational potential
energy is **negative**, ``U = -G m_i m_j / r`` — the reference returns
``+G m1 m2 / r`` (potential.py:69) while its acceleration routine implements
the attractive force (potential.py:51-53); here energy and force are
consistent, ``F = -grad U``.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..constants import Constants, NATURAL

Array = jax.Array
PotentialFn = Callable[[Array], Array]


def _attach(fn: PotentialFn, *, analytic_grad: Optional[Callable] = None,
            name: str = "") -> PotentialFn:
    fn.analytic_grad = analytic_grad  # type: ignore[attr-defined]
    fn.name = name or fn.__name__  # type: ignore[attr-defined]
    return fn


# ---------------------------------------------------------------------------
# Simple analytic targets
# ---------------------------------------------------------------------------


def harmonic_potential(q: Array, spring_consts: Array) -> Array:
    """ND harmonic potential ``0.5 * sum_d k_d q_d^2``.

    Parity: reference ``harmonicPotentialND`` (potential.py:18-27); e.g.
    q=(3,4), k=(2,3) -> 33 (reference test_potential.py:13-25). Works on a
    single position ``[D]`` or any batch ``[..., D]`` (reduces the last axis).
    """
    spring_consts = jnp.asarray(spring_consts, dtype=q.dtype)
    return 0.5 * jnp.sum(spring_consts * q * q, axis=-1)


def make_harmonic(spring_consts) -> PotentialFn:
    k = jnp.asarray(spring_consts)

    def potential(q):
        return harmonic_potential(q, k.astype(q.dtype))

    def grad(q):
        return k.astype(q.dtype) * q

    return _attach(potential, analytic_grad=grad, name="harmonic")


def make_standard_normal(num_dims: int) -> PotentialFn:
    """U(q) = 0.5 |q|^2 (+ const dropped): standard normal target.

    Parity: the reference's toy 2D Gaussian density/potential (HMC.py:186-195)
    computed as ``-log(exp(-|q|^2/2)/Z)``; here written directly in log space
    (never ``-log(pdf)``, which is float32-unsafe — see SURVEY.md §7 risks).
    """

    def potential(q):
        return 0.5 * jnp.sum(q * q, axis=-1)

    def grad(q):
        return q

    return _attach(potential, analytic_grad=grad,
                   name=f"std_normal_{num_dims}d")


def make_gaussian(mean: Array, cov: Optional[Array] = None,
                  precision: Optional[Array] = None) -> PotentialFn:
    """Multivariate Gaussian target: U(q) = 0.5 (q-mu)^T P (q-mu).

    Supply either ``cov`` (inverted via Cholesky once, at trace time) or
    ``precision`` directly. The quadratic form is a matmul — tensor-core
    work when batched over walkers.
    """
    mean = jnp.asarray(mean)
    if precision is None:
        if cov is None:
            raise ValueError("need cov or precision")
        cov = jnp.asarray(cov)
        chol = jnp.linalg.cholesky(cov)
        eye = jnp.eye(cov.shape[-1], dtype=cov.dtype)
        inv_chol = jax.scipy.linalg.solve_triangular(chol, eye, lower=True)
        precision = inv_chol.T @ inv_chol
    else:
        precision = jnp.asarray(precision)

    def potential(q):
        d = q - mean.astype(q.dtype)
        return 0.5 * jnp.sum(d * (d @ precision.astype(q.dtype)), axis=-1)

    def grad(q):
        return (q - mean.astype(q.dtype)) @ precision.astype(q.dtype)

    return _attach(potential, analytic_grad=grad, name="gaussian")


def make_banana(a: float = 1.0, b: float = 100.0) -> PotentialFn:
    """2D Rosenbrock ("banana") target:

    U(q) = (a - q0)^2 + b (q1 - q0^2)^2, a standard curved-geometry MCMC
    stress test (SURVEY.md §7 step 1; BASELINE.json config 2 'banana').
    """

    def potential(q):
        q0, q1 = q[..., 0], q[..., 1]
        return (a - q0) ** 2 + b * (q1 - q0**2) ** 2

    def grad(q):
        q0, q1 = q[..., 0], q[..., 1]
        d0 = -2.0 * (a - q0) - 4.0 * b * q0 * (q1 - q0**2)
        d1 = 2.0 * b * (q1 - q0**2)
        return jnp.stack([d0, d1], axis=-1)

    return _attach(potential, analytic_grad=grad, name="banana")


def make_logistic_regression(x: Array, labels: Array) -> PotentialFn:
    """Bayesian logistic regression in closed form: ``q = (w, b)`` with
    ``w ~ N(0, 1)^P``, ``b ~ N(0, 1)``, ``labels ~ Bernoulli(logits = x @ w
    + b)`` — the posterior of ``models.examples.logistic_regression`` up to
    an additive constant, with ``q`` flattened in the same (w, b) order.

    The intercept rides as a column of ones appended to ``x``, so the
    potential is one ``[..., P+1] x [P+1, N]`` product and elementwise work
    with no slicing — a form the fused GPU kernel (ops/fused_hmc.py) can
    lower when ``P + 1`` and ``N`` are powers of two.
    """
    x = jnp.asarray(x)
    x_aug = jnp.concatenate([x, jnp.ones((x.shape[0], 1), x.dtype)], axis=1)
    y = jnp.asarray(labels, x.dtype)

    def potential(q):
        z = q @ x_aug.T.astype(q.dtype)
        softplus = jnp.maximum(z, 0.0) + jnp.log1p(jnp.exp(-jnp.abs(z)))
        return 0.5 * jnp.sum(q * q, axis=-1) + jnp.sum(
            softplus - y.astype(q.dtype) * z, axis=-1)

    def grad(q):
        z = q @ x_aug.T.astype(q.dtype)
        resid = 1.0 / (1.0 + jnp.exp(-z)) - y.astype(q.dtype)
        return q + resid @ x_aug.astype(q.dtype)

    return _attach(potential, analytic_grad=grad,
                   name=f"logreg_{x_aug.shape[1]}_n{x.shape[0]}")


def make_funnel(num_dims: int = 10, sigma: float = 3.0) -> PotentialFn:
    """Neal's funnel: v ~ N(0, sigma^2); x_i | v ~ N(0, e^v).

    U(v, x) = v^2/(2 sigma^2) + (D-1) v / 2 + e^{-v} |x|^2 / 2.
    A standard hierarchical-geometry stress test (the same pathology as the
    centered eight-schools model the reference ships,
    samples/NumpyroExamples/eight_schools.py).
    """

    def potential(q):
        v = q[..., 0]
        x = q[..., 1:]
        return (v * v / (2.0 * sigma**2)
                + 0.5 * (num_dims - 1) * v
                + 0.5 * jnp.exp(-v) * jnp.sum(x * x, axis=-1))

    return _attach(potential, name=f"funnel_{num_dims}d")


def make_gaussian_mixture(means: Array, sigma: float = 1.0,
                          log_weights: Optional[Array] = None) -> PotentialFn:
    """Isotropic Gaussian mixture ``U(q) = -logsumexp_k (log w_k
    - |q - mu_k|^2 / (2 sigma^2))`` — the canonical multimodal target for
    the tempering methods (tempering.py / smc.py). Written directly in log
    space (float32-safe, SURVEY.md §7 risks). ``means``: ``[K, D]``."""
    mu = jnp.asarray(means)
    k_comp = mu.shape[0]
    if log_weights is None:
        lw = jnp.zeros((k_comp,))
    else:
        lw = jnp.asarray(log_weights)
    inv_var = 1.0 / (sigma * sigma)

    def potential(q):
        # q: [..., D]; component log densities: [..., K]
        d2 = jnp.sum(
            (q[..., None, :] - mu.astype(q.dtype)) ** 2, axis=-1)
        comp = lw.astype(q.dtype) - 0.5 * inv_var * d2
        return -jax.scipy.special.logsumexp(comp, axis=-1)

    return _attach(potential, name=f"gaussian_mixture_{k_comp}")


def no_potential(q: Array) -> Array:
    """U = 0 (reference ``noPotential``, potential.py:141-142): free flight."""
    return jnp.zeros(q.shape[:-1], dtype=q.dtype)


_attach(no_potential, analytic_grad=lambda q: jnp.zeros_like(q),
        name="no_potential")


# ---------------------------------------------------------------------------
# Gravitational N-body
# ---------------------------------------------------------------------------


def pairwise_displacements(x: Array) -> Array:
    """r_ij = x_j - x_i for x: [..., N, D] -> [..., N, N, D]."""
    return x[..., None, :, :] - x[..., :, None, :]


def nbody_potential_energy(
    x: Array,
    mass: Array,
    *,
    constants: Constants = NATURAL,
    softening: float = 0.0,
) -> Array:
    """Total gravitational potential energy ``-G sum_{i<j} m_i m_j / r_ij``.

    Vectorised O(N^2) with a masked pairwise matrix — replaces the reference's
    double Python loop (potential.py:72-101) and fixes its sign (the
    reference's ``gravitationalPotential`` returns +G m m / r,
    potential.py:69, inconsistent with its own attractive forces).

    Args:
      x: body positions ``[N, D]``.
      mass: body masses ``[N]``.
      softening: Plummer softening length epsilon; r -> sqrt(r^2 + eps^2).
    """
    n = x.shape[-2]
    r = pairwise_displacements(x)
    dist2 = jnp.sum(r * r, axis=-1) + softening**2
    # Mask the diagonal with inf distance instead of np.delete (reference
    # potential.py:44): static shapes, no data-dependent indexing.
    eye = jnp.eye(n, dtype=bool)
    inv_dist = jnp.where(eye, 0.0, jax.lax.rsqrt(jnp.where(eye, 1.0, dist2)))
    mm = mass[:, None] * mass[None, :]
    # each unordered pair counted once
    return -0.5 * constants.G * jnp.sum(mm * inv_dist, axis=(-2, -1))


def nbody_accelerations(
    x: Array,
    mass: Array,
    *,
    constants: Constants = NATURAL,
    softening: float = 0.0,
) -> Array:
    """Gravitational accelerations ``a_i = G sum_{j != i} m_j r_ij / |r_ij|^3``.

    Parity: reference ``getAccelNBody`` (potential.py:30-53), vectorised to
    all bodies at once ``[N, D] -> [N, D]`` (the reference computes one body
    per call with ``np.delete``). This closed form is also exactly
    ``-grad(nbody_potential_energy)/m`` — verified in tests.
    """
    n = x.shape[-2]
    r = pairwise_displacements(x)  # [..., N, N, D]
    dist2 = jnp.sum(r * r, axis=-1) + softening**2
    eye = jnp.eye(n, dtype=bool)
    inv_dist3 = jnp.where(eye, 0.0, jax.lax.rsqrt(jnp.where(eye, 1.0, dist2)) ** 3)
    contrib = (mass[None, :] * inv_dist3)[..., :, :, None] * r
    return constants.G * jnp.sum(contrib, axis=-2)


def make_nbody_potential(
    mass: Array,
    num_bodies: int,
    num_space_dims: int = 3,
    *,
    constants: Constants = NATURAL,
    softening: float = 0.0,
) -> PotentialFn:
    """N-body gravitational energy as a *sampling target* over the flattened

    configuration vector ``q: [N * D]`` (BASELINE.json config 4: N-body
    potential ensemble with tempering). ``analytic_grad`` is the exact force,
    so no autodiff is needed on the hot path.
    """
    mass = jnp.asarray(mass)

    def potential(q):
        x = q.reshape(*q.shape[:-1], num_bodies, num_space_dims)
        return nbody_potential_energy(
            x, mass.astype(q.dtype), constants=constants, softening=softening)

    def grad(q):
        x = q.reshape(*q.shape[:-1], num_bodies, num_space_dims)
        acc = nbody_accelerations(
            x, mass.astype(q.dtype), constants=constants, softening=softening)
        # dU/dx_i = -m_i a_i
        return (-mass[:, None].astype(q.dtype) * acc).reshape(q.shape)

    return _attach(potential, analytic_grad=grad,
                   name=f"nbody_{num_bodies}x{num_space_dims}")


# ---------------------------------------------------------------------------
# Numerical differentiation (reference parity: nBodyForce / getForceArray)
# ---------------------------------------------------------------------------


def numerical_grad(potential_fn: PotentialFn,
                   eps: float = 1e-4) -> Callable[[Array], Array]:
    """Central-difference gradient ``q:[D] -> dU/dq:[D]``.

    Parity with the reference's numerical force path (``nBodyForce`` /
    ``getForceArray`` built on forward-difference ``scipy.optimize
    .approx_fprime``, potential.py:104-138), as an *oracle for testing
    autodiff/analytic gradients* — never used on the hot path. Central
    differences (O(eps^2), vs the reference's O(eps) forward differences)
    keep the oracle usable in float32. All 2D perturbed evaluations run as
    one vmapped batch, not a per-dimension Python loop.
    """

    def grad(q):
        basis = eps * jnp.eye(q.shape[-1], dtype=q.dtype)
        u_plus = jax.vmap(potential_fn)(q[None, :] + basis)
        u_minus = jax.vmap(potential_fn)(q[None, :] - basis)
        return (u_plus - u_minus) / (2.0 * eps)

    return grad


def numerical_force(potential_fn: PotentialFn,
                    eps: float = 1e-4) -> Callable[[Array], Array]:
    """``F = -grad U`` by central differences (reference ``nBodyForce``,
    potential.py:104-119, returns the negative gradient of the N-body
    potential)."""
    g = numerical_grad(potential_fn, eps)
    return lambda q: -g(q)


def pad_potential(potential_fn: PotentialFn, num_dims: int,
                  padded_dims: Optional[int] = None) -> PotentialFn:
    """Embed a D-dim target in R^{D'} (default D' = the next power of two)
    by appending independent standard-normal auxiliary coordinates:
    U'(q') = U(q'[:D]) + 0.5 |q'[D:]|^2. The first-D marginals of the
    padded target are exactly the original posterior; samplers report
    q'[..., :D].

    The returned potential carries ``orig_dims``/``padded_dims`` attributes
    and a composed ``analytic_grad`` when the base potential has one.
    """
    if padded_dims is None:
        padded_dims = 1 << max(num_dims - 1, 0).bit_length()
    if padded_dims < num_dims:
        raise ValueError("padded_dims < num_dims")
    if padded_dims == num_dims:
        return potential_fn
    d, dp = num_dims, padded_dims

    def padded(q):
        extra = q[..., d:]
        return potential_fn(q[..., :d]) + 0.5 * jnp.sum(
            extra * extra, axis=-1)

    ag = getattr(potential_fn, "analytic_grad", None)
    grad = None
    if ag is not None:
        def grad(q):
            return jnp.concatenate([ag(q[..., :d]), q[..., d:]], axis=-1)
    _attach(padded, analytic_grad=grad,
            name=getattr(potential_fn, "name", "potential") + f"_pad{dp}")
    padded.orig_dims = d  # type: ignore[attr-defined]
    padded.padded_dims = dp  # type: ignore[attr-defined]
    return padded


# ---------------------------------------------------------------------------
# Batched value-and-grad plumbing
# ---------------------------------------------------------------------------


def batched_value_and_grad(
    potential_fn: PotentialFn, *, use_analytic: bool = True
) -> Callable[[Array], tuple[Array, Array]]:
    """Build ``q:[W, D] -> (U:[W], grad:[W, D])`` for a per-walker potential.

    Uses the potential's closed-form gradient when available (skips autodiff
    entirely — one fewer pass for the XLA scheduler to fuse), else
    ``vmap(value_and_grad(f))``. This is the single batching point that
    replaces the reference's per-walker-per-step ``jax.grad`` dispatch
    (reference integrator.py:61-73 + HMC.py:57-60 — the dominant cost in the
    reference, SURVEY.md §3.1).
    """
    ag = getattr(potential_fn, "analytic_grad", None)
    if use_analytic and ag is not None:
        def vg(q):
            return potential_fn(q), ag(q)
        return vg
    return jax.vmap(jax.value_and_grad(potential_fn))


@functools.lru_cache(maxsize=None)
def builtin_potentials() -> dict:
    """Registry of zero-arg builtin target constructors for the CLI/config."""
    return {
        "std_normal_2d": lambda: make_standard_normal(2),
        "std_normal_32d": lambda: make_standard_normal(32),
        "banana": make_banana,
        "funnel_10d": lambda: make_funnel(10),
        "bimodal_2d": lambda: make_gaussian_mixture(
            jnp.asarray([[-3.0, 0.0], [3.0, 0.0]])),
    }
