"""HMC sampler tests: posterior-moment oracles, adaptation, determinism.

Quantitative versions of the reference's scatter-plot validation (reference
src/tests/test_HMC.py:110-175 eyeballs HMC samples against
np.random.multivariate_normal draws; here we assert moments to MC tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import physicsbasedbayesianinference_tpu as pbbi
from physicsbasedbayesianinference_tpu.ops import potentials as pot


def test_hmc_standard_normal_moments():
    # Reference config analog: 2D standard normal target (reference
    # HMC.py:186-195, test_HMC.py:110-130), ensemble of walkers.
    fn = pot.make_standard_normal(2)
    kernel = pbbi.build_hmc_kernel(fn, num_steps=20)
    q0 = jax.random.normal(jax.random.key(0), (2048, 2)) * 0.5
    state = kernel.init(q0)
    step = jax.jit(lambda k, s: kernel.step(k, s, 0.25))

    qs = []
    key = jax.random.key(1)
    for i in range(60):
        key, sub = jax.random.split(key)
        state, info = step(sub, state)
        if i >= 20:
            qs.append(np.asarray(state.ensemble.q))
    samples = np.concatenate(qs, axis=0)
    assert np.abs(samples.mean(axis=0)).max() < 0.05
    np.testing.assert_allclose(samples.std(axis=0), 1.0, rtol=0.05)
    assert float(jnp.mean(info.accept_prob)) > 0.8


def test_run_hmc_gaussian_correlated():
    mean = jnp.array([1.0, -2.0, 0.5])
    cov = jnp.array([[1.0, 0.6, 0.0], [0.6, 2.0, 0.3], [0.0, 0.3, 0.5]])
    fn = pot.make_gaussian(mean, cov=cov)
    q0 = jax.random.normal(jax.random.key(2), (1024, 3))
    res = pbbi.run_hmc(
        jax.random.key(3), fn, q0, num_warmup=300, num_samples=300,
        num_steps=15, collect="samples")
    s = np.asarray(res.samples).reshape(-1, 3)
    np.testing.assert_allclose(s.mean(axis=0), np.asarray(mean), atol=0.08)
    np.testing.assert_allclose(np.cov(s.T), np.asarray(cov), atol=0.15)
    assert 0.6 < float(res.accept_rate) <= 1.0
    assert float(res.divergence_rate) < 0.01


def test_run_hmc_moments_mode():
    fn = pot.make_standard_normal(4)
    q0 = jax.random.normal(jax.random.key(4), (4096, 4))
    res = pbbi.run_hmc(
        jax.random.key(5), fn, q0, num_warmup=200, num_samples=200,
        num_steps=10, collect="moments")
    assert res.samples is None
    np.testing.assert_allclose(np.asarray(res.mean), 0.0, atol=0.05)
    np.testing.assert_allclose(np.asarray(res.var), 1.0, rtol=0.08)


def test_adaptation_finds_scale():
    # Anisotropic Gaussian: metric adaptation must recover per-dim variances
    # so the adapted mass approximates the precision diag(1/var).
    var = jnp.array([0.01, 1.0, 100.0])
    fn = pot.make_gaussian(jnp.zeros(3), precision=jnp.diag(1.0 / var))
    q0 = jax.random.normal(jax.random.key(6), (2048, 3)) * jnp.sqrt(var)
    res = pbbi.run_hmc(
        jax.random.key(7), fn, q0, num_warmup=400, num_samples=100,
        num_steps=10, collect="none")
    mass = np.asarray(res.mass)
    # mass ~= 1/var within a factor ~2
    ratio = mass * np.asarray(var)
    assert np.all(ratio > 0.4) and np.all(ratio < 2.5), ratio
    assert 0.6 < float(res.accept_rate) <= 1.0


def test_dual_averaging_hits_target_accept():
    fn = pot.make_standard_normal(8)
    q0 = jax.random.normal(jax.random.key(8), (1024, 8))
    res = pbbi.run_hmc(
        jax.random.key(9), fn, q0, num_warmup=400, num_samples=200,
        num_steps=10, init_step_size=1e-3, target_accept=0.8,
        adapt_mass=False, collect="none")
    # started 1000x too small; DA must bring acceptance near target
    assert 0.65 < float(res.accept_rate) < 0.95
    assert float(res.step_size) > 0.05


def test_determinism_same_seed():
    # The reference uses the unseeded global numpy RNG (HMC.py:170);
    # determinism is a build requirement (SURVEY.md §4).
    fn = pot.make_banana()
    q0 = jnp.zeros((64, 2))
    r1 = pbbi.run_hmc(jax.random.key(10), fn, q0, num_warmup=50,
                      num_samples=50, num_steps=10)
    r2 = pbbi.run_hmc(jax.random.key(10), fn, q0, num_warmup=50,
                      num_samples=50, num_steps=10)
    np.testing.assert_array_equal(np.asarray(r1.samples),
                                  np.asarray(r2.samples))


def test_divergence_detection():
    # A huge step size on a stiff target must produce divergences, be
    # rejected, and never propagate NaNs into the chain.
    fn = pot.make_banana(b=100.0)
    kernel = pbbi.build_hmc_kernel(fn, num_steps=10)
    q0 = jnp.zeros((128, 2)) + jnp.array([1.0, 1.0])
    state = kernel.init(q0)
    state2, info = jax.jit(lambda k, s: kernel.step(k, s, 50.0))(
        jax.random.key(11), state)
    assert bool(jnp.any(info.divergent))
    assert np.all(np.isfinite(np.asarray(state2.ensemble.q)))
    # all divergent walkers kept their old position
    div = np.asarray(info.divergent)
    np.testing.assert_array_equal(np.asarray(state2.ensemble.q)[div],
                                  np.asarray(q0)[div])


def test_tempered_target_variance():
    # At temperature T (k_B=1) the target is exp(-U/T): for U = q^2/2 the
    # stationary variance is T. Physical-constants semantics, consistent
    # (unlike reference HMC.py:115 which ignores T in the accept ratio).
    fn = pot.make_standard_normal(1)
    temperature = 4.0
    kernel = pbbi.build_hmc_kernel(fn, num_steps=20, temperature=temperature)
    q0 = jax.random.normal(jax.random.key(12), (4096, 1)) * 2.0
    state = kernel.init(q0)
    step = jax.jit(lambda k, s: kernel.step(k, s, 0.4))
    key = jax.random.key(13)
    qs = []
    for i in range(50):
        key, sub = jax.random.split(key)
        state, info = step(sub, state)
        if i >= 20:
            qs.append(np.asarray(state.ensemble.q))
    samples = np.concatenate(qs, axis=0)
    np.testing.assert_allclose(samples.var(), temperature, rtol=0.08)


@pytest.mark.parametrize("integrator", ["leapfrog", "mclachlan", "yoshida4"])
def test_integrator_choices_sample_correctly(integrator):
    fn = pot.make_standard_normal(2)
    q0 = jax.random.normal(jax.random.key(14), (512, 2))
    res = pbbi.run_hmc(
        jax.random.key(15), fn, q0, num_warmup=150, num_samples=150,
        num_steps=8, integrator=integrator)
    s = np.asarray(res.samples).reshape(-1, 2)
    np.testing.assert_allclose(s.std(axis=0), 1.0, rtol=0.08)


def test_run_hmc_kernel_option_cpu_fallback():
    """kernel="auto" runs the XLA engine (identical results to an
    explicit kernel="xla" run at equal seed); kernel="fused" off the GPU
    raises instead of silently running another engine."""
    fn = pot.make_standard_normal(3)
    q0 = jax.random.normal(jax.random.key(0), (256, 3))
    kw = dict(num_warmup=50, num_samples=50, num_steps=8,
              collect="moments")
    res_a = pbbi.run_hmc(jax.random.key(1), fn, q0, kernel="auto", **kw)
    res_x = pbbi.run_hmc(jax.random.key(1), fn, q0, kernel="xla", **kw)
    assert res_a.kernel_used == "xla"
    assert not hasattr(res_a, "kernel_variant")
    np.testing.assert_allclose(np.asarray(res_a.mean),
                               np.asarray(res_x.mean), rtol=1e-6)
    assert res_a.sampling_seconds > 0.0
    with pytest.raises(ValueError, match="no fused engine on this backend"):
        pbbi.run_hmc(jax.random.key(1), fn, q0, kernel="fused", **kw)


def test_run_hmc_rejects_bad_kernel():
    fn = pot.make_standard_normal(2)
    with pytest.raises(ValueError, match="kernel"):
        pbbi.run_hmc(jax.random.key(0), fn, jnp.zeros((8, 2)),
                     num_warmup=0, num_samples=1, num_steps=2,
                     kernel="cuda")


def test_resolve_kernel_choice():
    from physicsbasedbayesianinference_tpu.hmc import resolve_kernel_choice
    assert resolve_kernel_choice("xla") == "xla"
    # "auto" is the XLA engine on every backend
    assert resolve_kernel_choice("auto") == "xla"
    assert resolve_kernel_choice("auto", integrator="yoshida4") == "xla"
    # the fused engine runs leapfrog only, and only on a GPU backend
    with pytest.raises(ValueError, match="leapfrog"):
        resolve_kernel_choice("fused", integrator="yoshida4")
    with pytest.raises(ValueError, match="no fused engine"):
        resolve_kernel_choice("fused")
    with pytest.raises(ValueError, match="auto, xla, fused"):
        resolve_kernel_choice("packed")


def test_dense_metric_whitens_correlated_target():
    """run_hmc(metric="dense") — the Stan dense_e analog, estimated from
    the cross-walker covariance (one matmul per transition): on a
    strongly correlated target the adapted dense metric must (a) recover
    the target covariance, (b) allow a much larger step than the diag
    metric at equal acceptance target, and (c) match the posterior
    moments."""
    import numpy as onp
    rng = onp.random.RandomState(0)
    a = rng.randn(8, 8)
    cov_t = a @ a.T + 0.1 * onp.eye(8)
    mean_t = jnp.arange(8.0)
    target = pot.make_gaussian(mean_t, cov=jnp.asarray(cov_t, jnp.float32))
    q0 = jax.random.normal(jax.random.key(0), (4096, 8))
    kw = dict(num_warmup=400, num_samples=400, num_steps=8,
              collect="moments")
    res_d = pbbi.run_hmc(jax.random.key(1), target, q0, metric="dense",
                         **kw)
    res_i = pbbi.run_hmc(jax.random.key(1), target, q0, metric="diag",
                         kernel="xla", **kw)
    assert res_d.kernel_used == "dense"
    np.testing.assert_allclose(np.asarray(res_d.mean),
                               np.asarray(mean_t), atol=0.05)
    np.testing.assert_allclose(np.asarray(res_d.var),
                               onp.diagonal(cov_t), rtol=0.1)
    # whitening: dense step size should be several x the diag step
    assert float(res_d.step_size) > 2.0 * float(res_i.step_size)
    # adapted Sigma tracks the target covariance
    cc = np.asarray(res_d.metric_cov)
    assert onp.max(onp.abs(cc - cov_t) / (onp.abs(cov_t) + 0.1)) < 0.5
    assert 0.6 < float(res_d.accept_rate) <= 1.0


def test_dense_metric_validates_inputs():
    with pytest.raises(ValueError, match="metric"):
        pbbi.run_hmc(jax.random.key(0), pot.make_standard_normal(2),
                     jnp.zeros((8, 2)), num_warmup=0, num_samples=1,
                     num_steps=2, metric="bogus")


def test_dense_metric_sharded_matches_unsharded():
    """metric='dense' under GSPMD walker sharding must track the
    unsharded run (this config hit the r4 dense-warmup death spiral
    before the -inf accept guard + masked covariance stream)."""
    import numpy as onp
    from physicsbasedbayesianinference_tpu.parallel.sharded import (
        sharded_run_hmc)
    rng = onp.random.RandomState(0)
    a = rng.randn(4, 4)
    cov_t = a @ a.T + 0.1 * onp.eye(4)
    target = pot.make_gaussian(jnp.zeros(4),
                               cov=jnp.asarray(cov_t, jnp.float32))
    q0 = jax.random.normal(jax.random.key(0), (2048, 4))
    kw = dict(num_warmup=200, num_samples=200, num_steps=8,
              collect="moments", metric="dense")
    r_s = sharded_run_hmc(jax.random.key(1), target, q0, **kw)
    r_u = pbbi.run_hmc(jax.random.key(1), target, q0, **kw)
    assert float(r_s.accept_rate) > 0.5
    assert float(r_u.accept_rate) > 0.5
    np.testing.assert_allclose(np.asarray(r_s.mean),
                               np.asarray(r_u.mean), atol=0.15)
    np.testing.assert_allclose(np.asarray(r_s.var),
                               np.asarray(r_u.var), rtol=0.25)


def test_metric_streams_mask_pathological_walkers():
    """A finite-but-huge walker (|q| ~ 1e13 overflows squared
    cross-moments in f32) must not poison the streaming metric
    estimators; it is excluded from the ESTIMATE, not the chain."""
    from physicsbasedbayesianinference_tpu.adaptation import (
        covariance_init, covariance_update, regularized_covariance,
        regularized_mass, variance_init, variance_update)
    q = jax.random.normal(jax.random.key(0), (256, 4))
    q_bad = q.at[7].set(1e13).at[100, 2].set(jnp.inf)
    vs = variance_update(variance_init(4), q_bad)
    assert bool(jnp.isfinite(regularized_mass(vs)).all())
    cs = covariance_update(covariance_init(4), q_bad)
    cov = regularized_covariance(cs)
    assert bool(jnp.isfinite(cov).all())
    # estimate ~ the clean slab's covariance (254 of 256 rows kept)
    cs_clean = covariance_update(covariance_init(4), q)
    np.testing.assert_allclose(np.asarray(cov),
                               np.asarray(regularized_covariance(cs_clean)),
                               atol=0.25)


def test_negative_inf_energy_error_rejects():
    """The accept test must treat ANY non-finite energy error as
    divergent: a -inf error (current Hamiltonian overflowed to +inf)
    would otherwise auto-accept an arbitrarily bad proposal (the r4
    dense-warmup failure class)."""
    kernel = pbbi.build_hmc_kernel(pot.make_standard_normal(2),
                                   num_steps=4)
    # poison the cached potential energy to +inf: h0 = inf, h1 finite
    state = kernel.init(jax.random.normal(jax.random.key(0), (64, 2)))
    state = state.replace(
        potential_energy=jnp.full_like(state.potential_energy, jnp.inf))
    _, info = jax.jit(kernel.step)(jax.random.key(1), state,
                                   jnp.float32(0.3))
    assert bool(jnp.all(info.divergent))
    assert bool(jnp.all(~info.accepted))
