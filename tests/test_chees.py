"""ChEES-HMC: trajectory-time adaptation + jittered-length correctness."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from physicsbasedbayesianinference_tpu.chees import (
    build_jittered_hmc_kernel,
    chees_init,
    chees_update,
    halton_sequence,
    run_chees_hmc,
)
from physicsbasedbayesianinference_tpu.ops import potentials as pot


def test_halton_low_discrepancy():
    h = halton_sequence(256)
    assert h.shape == (256,)
    assert 0.0 < h.min() and h.max() < 1.0
    # quasi-random: mean much closer to 0.5 than sqrt(1/12n) Monte Carlo
    assert abs(float(h.mean()) - 0.5) < 0.01


def test_jittered_kernel_traced_length():
    """One compiled program serves every trajectory length."""
    target = pot.make_standard_normal(3)
    init, step = build_jittered_hmc_kernel(target, max_steps=64)
    state = init(jax.random.normal(jax.random.key(0), (128, 3)))
    jitted = jax.jit(step)
    for n in (1, 7, 64):
        st, info, _ = jitted(jax.random.key(n), state,
                             jnp.float32(0.3), jnp.int32(n))
        assert st.ensemble.q.shape == (128, 3)
        assert 0.0 <= float(jnp.mean(info.accept_prob)) <= 1.0


def test_chees_update_moves_log_tau_toward_gradient():
    st = chees_init(1.0)
    st2 = chees_update(st, jnp.asarray(1.0))
    assert float(st2.log_tau) > float(st.log_tau)
    st3 = chees_update(st, jnp.asarray(-1.0))
    assert float(st3.log_tau) < float(st.log_tau)
    # non-finite gradients are ignored, not propagated
    st4 = chees_update(st, jnp.asarray(jnp.nan))
    assert np.isfinite(float(st4.log_tau))


def test_chees_adapts_tau_and_samples_correctly():
    """Std normal: the ChEES-optimal trajectory time is O(pi/2); start far
    below and check warmup grows tau into a sane band while the posterior
    stays correct."""
    target = pot.make_standard_normal(8)
    res = run_chees_hmc(
        jax.random.key(0), target,
        jax.random.normal(jax.random.key(1), (1024, 8)),
        num_warmup=300, num_samples=300, init_tau=0.1,
        init_step_size=0.2, collect="moments")
    tau = float(res.trajectory_time)
    assert 0.5 < tau < 6.0, tau
    assert float(res.accept_rate) > 0.6
    np.testing.assert_allclose(np.asarray(res.mean), 0.0, atol=0.1)
    np.testing.assert_allclose(np.asarray(res.var), 1.0, atol=0.2)


def test_chees_handles_anisotropic_target():
    """Correlated Gaussian: adaptation must stay stable and unbiased."""
    mean = jnp.asarray([1.0, -1.0])
    cov = jnp.asarray([[2.0, 0.9], [0.9, 1.0]])
    target = pot.make_gaussian(mean, cov=cov)
    res = run_chees_hmc(
        jax.random.key(2), target,
        mean + jax.random.normal(jax.random.key(3), (1024, 2)),
        num_warmup=300, num_samples=300, init_tau=0.5,
        init_step_size=0.2, collect="moments")
    np.testing.assert_allclose(np.asarray(res.mean),
                               np.asarray(mean), atol=0.15)
    np.testing.assert_allclose(np.asarray(res.var),
                               np.asarray(jnp.diag(cov)), atol=0.4)


def test_chees_validates_collect():
    target = pot.make_standard_normal(2)
    with pytest.raises(ValueError, match="collect"):
        run_chees_hmc(jax.random.key(0), target,
                      jnp.zeros((8, 2)), num_warmup=0, num_samples=1,
                      collect="bad")


def test_chees_kernel_option_cpu_fallback():
    target = pot.make_standard_normal(2)
    q0 = jax.random.normal(jax.random.key(0), (512, 2))
    kw = dict(num_warmup=100, num_samples=100, init_step_size=0.3,
              collect="moments")
    res_a = run_chees_hmc(jax.random.key(1), target, q0, kernel="auto",
                          **kw)
    res_x = run_chees_hmc(jax.random.key(1), target, q0, kernel="xla",
                          **kw)
    assert res_a.kernel_used == "xla"
    np.testing.assert_allclose(np.asarray(res_a.mean),
                               np.asarray(res_x.mean), rtol=1e-6)
    with pytest.raises(ValueError, match="'auto' or 'xla'"):
        run_chees_hmc(jax.random.key(1), target, q0, kernel="fused", **kw)


def test_chees_mass_adaptation_scales_step():
    """r5: ChEES warmup adapts a cross-walker diagonal metric (the same
    Stan-like segment schedule run_hmc uses). On a badly scaled Gaussian
    the adapted mass must absorb the per-dimension variances (mass ~
    1/var) and let dual averaging settle at a much larger step size than
    the unadapted run, with posterior variances still correct."""
    scales = jnp.asarray([0.1, 0.1, 1.0, 1.0, 10.0, 10.0, 1.0, 1.0])
    target = pot.make_harmonic(1.0 / scales**2)  # var_d = scales^2
    q0 = scales * jax.random.normal(jax.random.key(0), (1024, 8))

    res_on = run_chees_hmc(
        jax.random.key(1), target, q0, num_warmup=400, num_samples=200,
        init_step_size=0.05, adapt_mass=True, collect="moments")
    res_off = run_chees_hmc(
        jax.random.key(1), target, q0, num_warmup=400, num_samples=200,
        init_step_size=0.05, adapt_mass=False, collect="moments")

    mass = np.asarray(res_on.state.ensemble.mass)
    assert mass.shape == (8,)
    # mass ~ 1/var: the 0.1-scale dims get ~100x the mass of unit dims
    ratio = mass[0] / mass[2]
    assert 30.0 < ratio < 300.0, mass
    assert float(res_on.step_size) > 2.0 * float(res_off.step_size), (
        float(res_on.step_size), float(res_off.step_size))
    np.testing.assert_allclose(np.asarray(res_on.var), scales**2,
                               rtol=0.25)
