"""Parallel tempering: unbiasedness on unimodal targets, mode-mixing on
multimodal targets (the capability plain HMC lacks), ladder mechanics."""

import jax
import numpy as np
import jax.numpy as jnp
import pytest

from physicsbasedbayesianinference_tpu import run_hmc, run_parallel_tempering
from physicsbasedbayesianinference_tpu.ops import potentials as pot
from physicsbasedbayesianinference_tpu.tempering import (
    _partner_tables,
    geometric_ladder,
)


def test_geometric_ladder_shape_and_endpoints():
    b = geometric_ladder(6, beta_min=0.05)
    assert b.shape == (6,)
    assert jnp.isclose(b[0], 1.0) and jnp.isclose(b[-1], 0.05)
    assert bool(jnp.all(jnp.diff(b) < 0))  # strictly cooling -> hotter


def test_partner_tables_are_involutions():
    import numpy as np
    for r in (1, 2, 5, 8):
        for t in _partner_tables(r):
            assert np.array_equal(t[t], np.arange(r))  # pairing, not cycle


def test_pt_gaussian_moments():
    """Cold replica is unbiased: swaps must not corrupt the invariant
    distribution (detailed-balance check via posterior moments)."""
    target = pot.make_gaussian(
        jnp.asarray([1.0, -2.0]), cov=jnp.asarray([[1.0, 0.5], [0.5, 2.0]]))
    res = run_parallel_tempering(
        jax.random.key(0), target,
        jax.random.normal(jax.random.key(1), (1024, 2)),
        num_replicas=4, beta_min=0.1, num_warmup=150, num_samples=300,
        num_steps=8, collect="moments")
    assert jnp.allclose(res.mean, jnp.asarray([1.0, -2.0]), atol=0.1)
    assert jnp.allclose(res.var, jnp.asarray([1.0, 2.0]), atol=0.25)
    assert float(jnp.min(res.accept_rate)) > 0.5
    assert float(jnp.max(res.swap_rate)) > 0.05


def test_pt_mixes_bimodal_where_hmc_cannot():
    """Two well-separated modes: PT visits both in target proportion;
    plain HMC started in one mode stays there."""
    target = pot.make_gaussian_mixture(
        jnp.asarray([[-6.0, 0.0], [6.0, 0.0]]))
    # start every walker in the LEFT mode
    init = jnp.asarray([-6.0, 0.0]) + 0.3 * jax.random.normal(
        jax.random.key(2), (256, 2))

    res_pt = run_parallel_tempering(
        jax.random.key(3), target, init,
        num_replicas=6, beta_min=0.02, num_warmup=200, num_samples=400,
        num_steps=10, collect="samples")
    frac_right_pt = float(jnp.mean(res_pt.samples[:, :, 0] > 0.0))

    res_hmc = run_hmc(
        jax.random.key(3), target, init,
        num_warmup=200, num_samples=400, num_steps=10, adapt_mass=False)
    frac_right_hmc = float(jnp.mean(res_hmc.samples[:, :, 0] > 0.0))

    assert 0.25 < frac_right_pt < 0.75, frac_right_pt
    assert frac_right_hmc < 0.05, frac_right_hmc


def test_pt_hot_replicas_take_larger_steps():
    target = pot.make_standard_normal(4)
    res = run_parallel_tempering(
        jax.random.key(4), target,
        jax.random.normal(jax.random.key(5), (512, 4)),
        num_replicas=4, beta_min=0.05, num_warmup=150, num_samples=10,
        num_steps=8, collect="none")
    s = res.step_sizes
    assert float(s[-1]) > float(s[0])  # hottest step > coldest step


def test_pt_single_replica_degenerates_to_hmc():
    target = pot.make_standard_normal(2)
    res = run_parallel_tempering(
        jax.random.key(6), target,
        jax.random.normal(jax.random.key(7), (256, 2)),
        num_replicas=1, num_warmup=100, num_samples=200,
        num_steps=8, collect="moments")
    assert jnp.allclose(res.mean, 0.0, atol=0.15)
    assert float(jnp.max(res.swap_rate)) == 0.0


def test_pt_validates_inputs():
    target = pot.make_standard_normal(2)
    q = jax.random.normal(jax.random.key(0), (64, 2))
    with pytest.raises(ValueError, match="collect"):
        run_parallel_tempering(jax.random.key(0), target, q,
                               collect="bogus")
    with pytest.raises(ValueError, match="replica"):
        geometric_ladder(0)


def test_pt_replicas_sharded_over_mesh():
    """Replica ladder mapped onto its own mesh axis (4 replica shards x 2
    walker shards on the 8-device mesh): GSPMD partitions the [R, W, D]
    ensemble so each device holds R/4 ladder rungs instead of all R, and
    the cold-chain moments match the unsharded run within MC error."""
    import jax
    from physicsbasedbayesianinference_tpu.parallel.mesh import (
        make_replica_mesh, replica_sharding)

    target = pot.make_gaussian_mixture(jnp.asarray([[-3.0, 0.0], [3.0, 0.0]]))
    r, w = 4, 512
    init = jnp.broadcast_to(
        jax.random.normal(jax.random.key(0), (w, 2)) * 3.0, (r, w, 2))
    kw = dict(num_replicas=r, num_warmup=100, num_samples=200,
              num_steps=8, collect="moments")

    res_plain = run_parallel_tempering(
        jax.random.key(1), target, init, **kw)

    mesh = make_replica_mesh(4)
    init_sh = jax.device_put(init, replica_sharding(mesh))
    res_sh = run_parallel_tempering(
        jax.random.key(1), target, init_sh, **kw)

    np.testing.assert_allclose(np.asarray(res_sh.mean),
                               np.asarray(res_plain.mean), atol=0.5)
    np.testing.assert_allclose(np.asarray(res_sh.var),
                               np.asarray(res_plain.var), atol=1.0)
    # both modes of the bimodal target reached by the cold chain
    assert res_sh.var[0] > 4.0


def test_pt_kernel_option_cpu_fallback():
    """Parallel tempering runs the XLA engine: kernel='auto' reports it,
    and kernel='fused' raises naming the supported values."""
    import pytest
    import jax
    import jax.numpy as jnp
    from physicsbasedbayesianinference_tpu.ops.potentials import (
        make_standard_normal)
    from physicsbasedbayesianinference_tpu.tempering import (
        run_parallel_tempering)

    r = run_parallel_tempering(
        jax.random.key(0), make_standard_normal(4),
        jax.random.normal(jax.random.key(1), (128, 4)),
        num_replicas=3, num_warmup=10, num_samples=10, collect="none",
        kernel="auto")
    assert r.kernel_used == "xla"
    assert r.q.shape == (3, 128, 4)
    with pytest.raises(ValueError, match="'auto' or 'xla'"):
        run_parallel_tempering(
            jax.random.key(0), make_standard_normal(4),
            jnp.zeros((128, 4)), num_replicas=3, num_warmup=1,
            num_samples=1, kernel="fused")
