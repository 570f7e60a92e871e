"""SMC/tempering tests: weights, resampling, adaptive ladder, and
end-to-end annealing with an analytic log-evidence oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from physicsbasedbayesianinference_tpu import smc
from physicsbasedbayesianinference_tpu.ops import potentials as pot


def test_ess_limits():
    w = jnp.zeros(100)  # uniform
    np.testing.assert_allclose(float(smc.effective_sample_size(w)), 100.0,
                               rtol=1e-5)
    one_hot = jnp.full(100, -1e9).at[3].set(0.0)
    np.testing.assert_allclose(float(smc.effective_sample_size(one_hot)),
                               1.0, rtol=1e-4)


def test_normalize_log_weights():
    lw = jnp.array([0.0, 1.0, 2.0])
    n = smc.normalize_log_weights(lw)
    np.testing.assert_allclose(float(jnp.sum(jnp.exp(n))), 1.0, rtol=1e-6)


@pytest.mark.parametrize("method", ["systematic", "stratified",
                                    "multinomial"])
def test_resampling_proportional(method):
    """Resampled counts must be proportional to weights (exact within 1
    for systematic resampling, statistically for the others)."""
    key = jax.random.key(0)
    w = jnp.array([0.5, 0.3, 0.15, 0.05])
    log_w = jnp.log(w)
    num = 4000
    idx = smc.RESAMPLERS[method](key, log_w, num)
    counts = np.bincount(np.asarray(idx), minlength=4) / num
    tol = 1.0 / num if method == "systematic" else 0.03
    np.testing.assert_allclose(counts, np.asarray(w), atol=tol + 1e-9)


def test_resample_tree():
    key = jax.random.key(1)
    tree = {"q": jnp.arange(8.0)[:, None], "e": jnp.arange(8.0)}
    log_w = jnp.full(8, -1e9).at[5].set(0.0)
    out, lw = smc.resample(key, tree, log_w)
    np.testing.assert_allclose(np.asarray(out["q"]), 5.0)
    np.testing.assert_allclose(np.asarray(out["e"]), 5.0)
    np.testing.assert_allclose(np.asarray(lw), 0.0)


def test_next_beta_by_ess_monotone():
    key = jax.random.key(2)
    u = jax.random.normal(key, (512,)) ** 2 * 10.0
    log_w = jnp.zeros(512)
    b1 = smc.next_beta_by_ess(u, log_w, jnp.asarray(0.0), target_frac=0.9)
    b2 = smc.next_beta_by_ess(u, log_w, jnp.asarray(0.0), target_frac=0.3)
    assert 0.0 < float(b1) <= float(b2) <= 1.0


def test_next_beta_jumps_to_max_when_easy():
    u = jnp.ones(64) * 0.001  # nearly-constant potential: no degeneracy
    b = smc.next_beta_by_ess(u, jnp.zeros(64), jnp.asarray(0.0))
    np.testing.assert_allclose(float(b), 1.0)


def test_smc_gaussian_evidence_and_moments():
    """Anneal N(0, I/beta0) -> N(0, I) for U = |q|^2/2 in 4D. Oracle:
    log(Z_1 / Z_beta0) = (d/2) log(beta0). Posterior var -> 1."""
    d = 4
    beta0 = 0.1
    target = pot.make_standard_normal(d)
    key = jax.random.key(0)
    w = 4096
    init_q = jax.random.normal(key, (w, d)) / np.sqrt(beta0)
    res = smc.run_smc(
        jax.random.key(1), target, init_q,
        num_mutation_steps=3, num_leapfrog_steps=10,
        init_step_size=0.8, beta0=beta0, max_stages=40)
    expected_logz = 0.5 * d * np.log(beta0)
    assert int(res.num_stages) >= 2
    np.testing.assert_allclose(float(res.log_evidence), expected_logz,
                               atol=0.25)
    np.testing.assert_allclose(float(jnp.var(res.q)), 1.0, atol=0.1)
    np.testing.assert_allclose(float(jnp.mean(res.q)), 0.0, atol=0.1)


def test_smc_multimodal_mixture():
    """Tempering must populate both modes of a symmetric 1D bimodal target
    (plain HMC mixes badly between well-separated modes — the use case SMC
    exists for)."""
    sep = 4.0

    def potential(q):
        x = q[..., 0]
        return -jnp.logaddexp(-0.5 * (x - sep) ** 2,
                              -0.5 * (x + sep) ** 2)

    potential.analytic_grad = None
    key = jax.random.key(3)
    init_q = jax.random.normal(key, (4096, 1)) * 6.0
    res = smc.run_smc(
        jax.random.key(4), potential, init_q,
        num_mutation_steps=5, num_leapfrog_steps=10,
        init_step_size=1.0, beta0=0.05, max_stages=40)
    frac_right = float(jnp.mean((res.q[:, 0] > 0).astype(jnp.float32)))
    assert 0.3 < frac_right < 0.7, frac_right
    # mode locations
    right = res.q[res.q[:, 0] > 0, 0]
    np.testing.assert_allclose(float(jnp.mean(right)), sep, atol=0.3)


def test_smc_acceptance_reasonable():
    target = pot.make_standard_normal(2)
    init_q = jax.random.normal(jax.random.key(5), (1024, 2)) * 3.0
    res = smc.run_smc(jax.random.key(6), target, init_q,
                      beta0=0.1, max_stages=30)
    n = int(res.num_stages)
    acc = np.asarray(res.accept_history)[:n]
    assert acc.mean() > 0.5


def test_smc_sharded_matches_unsharded_statistically():
    """SMC under a walker-sharded mesh (GSPMD): moments must agree with
    the unsharded run within MC error (the resampling gather crosses
    shards)."""
    from physicsbasedbayesianinference_tpu.parallel import mesh as meshmod
    target = pot.make_standard_normal(3)
    init_q = jax.random.normal(jax.random.key(7), (2048, 3)) * 3.0
    mesh = meshmod.make_walker_mesh()
    init_sharded = jax.device_put(init_q, meshmod.walker_sharding(mesh, 2))
    kw = dict(beta0=0.1, max_stages=30, num_mutation_steps=3,
              num_leapfrog_steps=10)
    r1 = smc.run_smc(jax.random.key(8), target, init_q, **kw)
    r2 = smc.run_smc(jax.random.key(8), target, init_sharded, **kw)
    np.testing.assert_allclose(float(jnp.var(r2.q)), 1.0, atol=0.1)
    np.testing.assert_allclose(float(jnp.var(r1.q)), float(jnp.var(r2.q)),
                               atol=0.1)
    np.testing.assert_allclose(float(r1.log_evidence),
                               float(r2.log_evidence), atol=0.3)


def test_smc_ring_resampler_end_to_end():
    """run_smc(mesh=...) must use the O(W/K) ring resampler and still
    recover the target moments + evidence of the dense path."""
    from physicsbasedbayesianinference_tpu.parallel import mesh as meshmod
    target = pot.make_standard_normal(3)
    init_q = jax.random.normal(jax.random.key(7), (2048, 3)) * 3.0
    mesh = meshmod.make_walker_mesh()
    init_sharded = jax.device_put(init_q, meshmod.walker_sharding(mesh, 2))
    kw = dict(beta0=0.1, max_stages=30, num_mutation_steps=3,
              num_leapfrog_steps=10)
    r_dense = smc.run_smc(jax.random.key(8), target, init_q, **kw)
    r_ring = smc.run_smc(jax.random.key(8), target, init_sharded,
                         mesh=mesh, **kw)
    np.testing.assert_allclose(float(jnp.var(r_ring.q)), 1.0, atol=0.1)
    np.testing.assert_allclose(float(r_dense.log_evidence),
                               float(r_ring.log_evidence), atol=0.3)
    # the ring path must reject non-systematic resamplers
    with pytest.raises(ValueError, match="systematic"):
        smc.run_smc(jax.random.key(9), target, init_sharded, mesh=mesh,
                    resampler="multinomial", **kw)


def test_smc_mutation_dual_averaging_tracks_target():
    """Late (cold) stages must keep mutation acceptance near the DA
    target on a hard curved target — the failure mode of the old one-way
    decay heuristic."""
    target = pot.make_funnel(6)
    init_q = jax.random.normal(jax.random.key(10), (1024, 6)) * 3.0
    res = smc.run_smc(jax.random.key(11), target, init_q,
                      beta0=0.05, max_stages=40, num_mutation_steps=5,
                      init_step_size=2.0,  # deliberately far too large
                      mutation_target_accept=0.75)
    n = int(res.num_stages)
    acc = np.asarray(res.accept_history)[:n]
    # final stages adapted to within a reasonable band of the target
    assert acc[-3:].mean() > 0.5, acc
    assert acc[-3:].mean() < 0.98, acc
    assert float(res.final_step_size) < 2.0


def test_smc_kernel_option_cpu_fallback():
    """run_smc(kernel=...) runs the XLA mutation engine for "auto" and
    rejects anything else, "fused" included."""
    target = pot.make_standard_normal(2)
    init_q = 2.0 * jax.random.normal(jax.random.key(0), (2048, 2))
    kw = dict(beta0=0.1, max_stages=30, num_mutation_steps=3,
              num_leapfrog_steps=10)
    r = smc.run_smc(jax.random.key(1), target, init_q, kernel="auto",
                    **kw)
    assert np.isfinite(float(r.log_evidence))
    np.testing.assert_allclose(np.asarray(jnp.var(r.q, axis=0)),
                               1.0, atol=0.15)
    for bad in ("nope", "fused"):
        with pytest.raises(ValueError, match="kernel"):
            smc.run_smc(jax.random.key(2), target, init_q, kernel=bad,
                        **kw)
