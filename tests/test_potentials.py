"""Potential library tests (parity + gradient consistency)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from physicsbasedbayesianinference_tpu import Constants
from physicsbasedbayesianinference_tpu.ops import potentials as pot


def test_harmonic_value_parity():
    # Parity: reference test_potential.test_potential — U((3,4), k=(2,3)) = 33
    # (reference src/tests/test_potential.py:13-25).
    q = jnp.array([3.0, 4.0])
    k = jnp.array([2.0, 3.0])
    assert float(pot.harmonic_potential(q, k)) == pytest.approx(33.0)


def test_harmonic_batched_shape():
    q = jnp.ones((10, 4))
    k = jnp.arange(1.0, 5.0)
    u = pot.harmonic_potential(q, k)
    assert u.shape == (10,)
    np.testing.assert_allclose(np.asarray(u), 0.5 * (1 + 2 + 3 + 4))


@pytest.mark.parametrize("maker", [
    lambda: pot.make_harmonic(jnp.array([2.0, 3.0])),
    lambda: pot.make_standard_normal(2),
    pot.make_banana,
    lambda: pot.make_gaussian(jnp.array([1.0, -1.0]),
                              cov=jnp.array([[2.0, 0.5], [0.5, 1.0]])),
    lambda: pot.make_nbody_potential(jnp.array([1.0, 2.0, 3.0]), 3, 2,
                                     softening=0.1),
])
def test_analytic_grad_matches_autodiff(maker):
    fn = maker()
    dim = 6 if "nbody" in fn.name else 2
    q = jax.random.normal(jax.random.key(0), (7, dim)) * 1.5
    auto = jax.vmap(jax.grad(fn))(q)
    analytic = fn.analytic_grad(q)
    np.testing.assert_allclose(np.asarray(analytic), np.asarray(auto),
                               rtol=2e-4, atol=2e-5)


def test_gaussian_precision_vs_cov():
    cov = jnp.array([[2.0, 0.5], [0.5, 1.0]])
    prec = jnp.linalg.inv(cov)
    f1 = pot.make_gaussian(jnp.zeros(2), cov=cov)
    f2 = pot.make_gaussian(jnp.zeros(2), precision=prec)
    q = jax.random.normal(jax.random.key(1), (5, 2))
    np.testing.assert_allclose(np.asarray(jax.vmap(f1)(q)),
                               np.asarray(jax.vmap(f2)(q)), rtol=1e-5)


def test_no_potential():
    q = jnp.ones((4, 3))
    np.testing.assert_array_equal(np.asarray(pot.no_potential(q)), 0.0)
    np.testing.assert_array_equal(
        np.asarray(pot.no_potential.analytic_grad(q)), 0.0)


def test_nbody_energy_sign_and_value():
    # Two unit masses at distance 2 with G=1: U = -1*1/2 = -0.5.
    # (Fixes the reference's +G m m / r sign, potential.py:69.)
    x = jnp.array([[0.0, 0.0, 0.0], [2.0, 0.0, 0.0]])
    m = jnp.ones(2)
    u = pot.nbody_potential_energy(x, m)
    assert float(u) == pytest.approx(-0.5)


def test_nbody_accel_is_negative_grad_over_mass():
    # a_i = -grad_{x_i} U / m_i, consistency between the closed form and the
    # energy (the reference's force/energy disagree in sign).
    key = jax.random.key(2)
    x = jax.random.normal(key, (5, 3)) * 2.0
    m = jnp.abs(jax.random.normal(jax.random.key(3), (5,))) + 0.5
    const = Constants(k_B=1.0, G=2.5)

    def energy(xf):
        return pot.nbody_potential_energy(xf, m, constants=const)

    grad = jax.grad(energy)(x)
    acc = pot.nbody_accelerations(x, m, constants=const)
    np.testing.assert_allclose(np.asarray(acc),
                               np.asarray(-grad / m[:, None]),
                               rtol=1e-4, atol=1e-5)


def test_nbody_accel_two_body():
    # Reference getAccelNBody semantics (potential.py:30-53): attractive,
    # a_1 = G m_2 / r^2 toward body 2.
    x = jnp.array([[0.0, 0.0], [3.0, 0.0]])
    m = jnp.array([1.0, 5.0])
    const = Constants(G=2.0)
    acc = pot.nbody_accelerations(x, m, constants=const)
    # |a_0| = G m_1 / 9 pointing +x; |a_1| = G m_0 / 9 pointing -x
    np.testing.assert_allclose(np.asarray(acc[0]), [2.0 * 5.0 / 9.0, 0.0],
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(acc[1]), [-2.0 * 1.0 / 9.0, 0.0],
                               rtol=1e-6)


def test_batched_value_and_grad_paths():
    fn = pot.make_banana()
    q = jax.random.normal(jax.random.key(4), (9, 2))
    vg_analytic = pot.batched_value_and_grad(fn, use_analytic=True)
    vg_auto = pot.batched_value_and_grad(fn, use_analytic=False)
    u1, g1 = vg_analytic(q)
    u2, g2 = vg_auto(q)
    np.testing.assert_allclose(np.asarray(u1), np.asarray(u2), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-4,
                               atol=1e-5)


def test_funnel_finite():
    fn = pot.make_funnel(5)
    q = jax.random.normal(jax.random.key(5), (11, 5))
    u, g = pot.batched_value_and_grad(fn)(q)
    assert np.all(np.isfinite(np.asarray(u)))
    assert np.all(np.isfinite(np.asarray(g)))
    assert u.shape == (11,)
    assert g.shape == (11, 5)


def test_numerical_grad_oracle():
    """Central-difference oracle (reference nBodyForce/getForceArray parity,
    potential.py:104-138) agrees with analytic gradients, and force = -grad."""
    from physicsbasedbayesianinference_tpu.ops.potentials import (
        make_harmonic, make_nbody_potential, numerical_force, numerical_grad)
    import jax

    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        k = jnp.asarray([2.0, 3.0, 0.5], dtype=jnp.float64)
        pot = make_harmonic(k)
        q = jnp.asarray([3.0, -4.0, 1.5], dtype=jnp.float64)
        np.testing.assert_allclose(
            np.asarray(numerical_grad(pot, 1e-6)(q)),
            np.asarray(pot.analytic_grad(q)), rtol=1e-6)

        mass = jnp.asarray([1.0, 2.0, 3.0], dtype=jnp.float64)
        npot = make_nbody_potential(mass, 3, 3)
        qn = jnp.asarray(
            np.random.default_rng(1).normal(size=9), dtype=jnp.float64)
        np.testing.assert_allclose(
            np.asarray(numerical_force(npot, 1e-6)(qn)),
            -np.asarray(npot.analytic_grad(qn)), rtol=1e-5, atol=1e-8)
    finally:
        jax.config.update("jax_enable_x64", old)


@pytest.mark.parametrize("n", [100, 300, 512])
def test_nbody_accelerations_match_float64_pairwise(n):
    """The XLA pairwise accelerations against a float64 NumPy double loop
    over bodies (vectorised over sources)."""
    x = np.asarray(jax.random.normal(jax.random.key(4), (n, 3)), np.float64)
    m = np.asarray(jax.random.uniform(jax.random.key(5), (n,), minval=0.5,
                                      maxval=2.0), np.float64)
    ref = np.zeros_like(x)
    for i in range(n):
        r = x - x[i]
        d2 = np.sum(r * r, axis=1)
        d2[i] = 1.0
        w = m / d2 ** 1.5
        w[i] = 0.0
        ref[i] = np.sum(w[:, None] * r, axis=0)
    got = np.asarray(pot.nbody_accelerations(jnp.asarray(x, jnp.float32),
                                             jnp.asarray(m, jnp.float32)))
    np.testing.assert_allclose(got, ref, rtol=2e-3,
                               atol=2e-4 * np.abs(ref).max())


def test_pad_potential_marginals_exact():
    """The padded target's first-D marginal is exactly the original:
    U'(q') = U(q[:D]) + 0.5|q'[D:]|^2 separates."""
    base = pot.make_funnel(10)
    padded = pot.pad_potential(base, 10)
    assert padded.padded_dims == 16 and padded.orig_dims == 10
    q = jax.random.normal(jax.random.key(0), (16,))
    expected = base(q[:10]) + 0.5 * jnp.sum(q[10:] ** 2)
    np.testing.assert_allclose(float(padded(q)), float(expected), rtol=1e-6)
    assert pot.pad_potential(base, 16) is base
    with pytest.raises(ValueError):
        pot.pad_potential(base, 10, padded_dims=8)


def test_pad_potential_analytic_grad():
    base = pot.make_harmonic(jnp.arange(1.0, 11.0))
    padded = pot.pad_potential(base, 10, padded_dims=12)
    q = jax.random.normal(jax.random.key(1), (5, 12))
    g = padded.analytic_grad(q)
    g_ref = jax.vmap(jax.grad(lambda x: padded(x)))(q)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), rtol=1e-5,
                               atol=1e-6)


def test_logistic_regression_matches_model_dsl():
    """The closed-form logreg potential is the DSL model's posterior up to
    an additive constant, with the same (w, b) flattening."""
    from physicsbasedbayesianinference_tpu.models.examples import (
        logistic_regression, synthetic_logreg_data)
    from physicsbasedbayesianinference_tpu.models.potential import (
        make_model_potential)
    x, y = synthetic_logreg_data(num_rows=64, num_features=7)
    mp = make_model_potential(logistic_regression, (x, y), {})
    closed = pot.make_logistic_regression(x, y)
    q = 0.5 * jax.random.normal(jax.random.key(3), (16, 8))
    u_dsl, g_dsl = pot.batched_value_and_grad(mp.potential)(q)
    u_cf, g_cf = pot.batched_value_and_grad(closed)(q)
    offset = np.asarray(u_dsl - u_cf)
    np.testing.assert_allclose(offset, offset[0], atol=1e-4)
    np.testing.assert_allclose(np.asarray(g_cf), np.asarray(g_dsl),
                               rtol=1e-4, atol=1e-4)
