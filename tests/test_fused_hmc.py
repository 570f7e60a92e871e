"""The fused Pallas Triton HMC transition (ops/fused_hmc.py) against the
XLA step, walker by walker. Here under the Pallas interpreter
(``interpret=True`` passed explicitly); the tests marked ``gpu`` compile
it for the card and run in chip_smoke.py's test phase."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import physicsbasedbayesianinference_tpu as pbbi
from physicsbasedbayesianinference_tpu.models.examples import (
    logistic_regression, synthetic_logreg_data)
from physicsbasedbayesianinference_tpu.models.potential import (
    make_model_potential)
from physicsbasedbayesianinference_tpu.ops import fused_hmc
from physicsbasedbayesianinference_tpu.ops import potentials as pot


def _target(name):
    """(potential, D, step size)."""
    if name == "std_normal":
        return pot.make_standard_normal(32), 32, 0.5
    if name == "logreg":
        x, y = synthetic_logreg_data(num_rows=64, num_features=15)
        return pot.make_logistic_regression(x, y), 16, 0.1
    if name == "gaussian":
        a = jax.random.normal(jax.random.key(9), (16, 16))
        cov = a @ a.T / 16 + jnp.eye(16)
        return pot.make_gaussian(jnp.arange(16.0) / 8, cov=cov), 16, 0.3
    raise ValueError(name)


def _both_steps(name, num_walkers, num_steps, mass=1.0, interpret=True):
    fn, d, eps = _target(name)
    with jax.default_matmul_precision("highest"):
        xla = pbbi.build_hmc_kernel(fn, num_steps=num_steps)
        fused = pbbi.build_fused_hmc_kernel(fn, num_steps=num_steps,
                                            num_dims=d, interpret=interpret)
        q0 = 0.5 * jax.random.normal(jax.random.key(1), (num_walkers, d))
        state = xla.init(q0, mass=mass)
        key = jax.random.key(2)
        return (jax.jit(xla.step)(key, state, jnp.float32(eps)),
                jax.jit(fused.step)(key, state, jnp.float32(eps)))


def _assert_same(a, b, rtol=1e-4):
    """Equal up to float32 reduction order: the energy error is a
    difference of Hamiltonians ~1e2, so its rounding is ~1e-5 absolute."""
    leaves = jax.tree_util.tree_leaves
    for x, y in zip(leaves(a), leaves(b)):
        x, y = np.asarray(x), np.asarray(y)
        if x.dtype == bool:
            np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_allclose(x, y, rtol=rtol,
                                       atol=rtol * max(np.abs(y).max(), 1.0))


@pytest.mark.parametrize("num_steps", [1, 4])
@pytest.mark.parametrize("num_walkers", [100, 48])
@pytest.mark.parametrize("name", ["std_normal", "logreg", "gaussian"])
def test_fused_step_matches_xla_step(name, num_walkers, num_steps):
    """Same state and key: same momenta, trajectory, decisions and
    outputs (walker counts that are not a multiple of the block pad)."""
    (sx, ix), (sf, i_f) = _both_steps(name, num_walkers, num_steps)
    _assert_same(sf, sx)
    _assert_same(i_f, ix)
    assert sf.ensemble.q.shape == (num_walkers, sx.ensemble.num_dims)


def test_fused_step_with_diagonal_mass():
    mass = jnp.linspace(0.5, 2.0, 32)
    (sx, ix), (sf, i_f) = _both_steps("std_normal", 64, 3, mass=mass)
    _assert_same(sf, sx)
    _assert_same(i_f, ix)
    np.testing.assert_array_equal(np.asarray(sf.ensemble.mass),
                                  np.asarray(mass))


def test_fused_scan_of_transitions_matches_xla():
    fn, d, eps = _target("std_normal")
    xla = pbbi.build_hmc_kernel(fn, num_steps=4)
    fused = pbbi.build_fused_hmc_kernel(fn, num_steps=4, num_dims=d,
                                        interpret=True)
    state = xla.init(jax.random.normal(jax.random.key(3), (40, d)))
    keys = jax.random.split(jax.random.key(4), 6)

    def run(kernel):
        def body(st, k):
            st, info = kernel.step(k, st, jnp.float32(eps))
            return st, info.accepted
        return jax.jit(lambda s: jax.lax.scan(body, s, keys))(state)

    (sx, ax), (sf, af) = run(xla), run(fused)
    np.testing.assert_array_equal(np.asarray(af), np.asarray(ax))
    _assert_same(sf, sx)


def test_run_hmc_with_prebuilt_fused_kernel():
    fn = pot.make_standard_normal(16)
    kernel = pbbi.build_fused_hmc_kernel(fn, num_steps=6, num_dims=16,
                                         interpret=True)
    q0 = 2.0 + jax.random.normal(jax.random.key(5), (256, 16))
    res = pbbi.run_hmc(jax.random.key(6), fn, q0, kernel=kernel,
                       num_warmup=60, num_samples=60, num_steps=6,
                       collect="moments")
    assert res.kernel_used == "fused"
    np.testing.assert_allclose(np.asarray(res.mean), 0.0, atol=0.15)
    np.testing.assert_allclose(np.asarray(res.var), 1.0, atol=0.25)


def test_unlowerable_potential_raises_naming_primitive():
    """The DSL logreg flattens q with slices, which the Triton route has
    no rule for: kernel="fused" fails at build time, never silently."""
    mp = make_model_potential(logistic_regression,
                              synthetic_logreg_data(num_rows=32), {})
    with pytest.raises(ValueError, match="'slice'"):
        pbbi.build_fused_hmc_kernel(mp.potential, num_steps=2,
                                    num_dims=mp.num_dims, interpret=True)


def test_non_power_of_two_shapes_raise():
    with pytest.raises(ValueError, match="power-of-two number of dim"):
        pbbi.build_fused_hmc_kernel(pot.make_standard_normal(10),
                                    num_steps=2, num_dims=10,
                                    interpret=True)
    x, y = synthetic_logreg_data(num_rows=48, num_features=15)
    with pytest.raises(ValueError, match="power-of-two"):
        pbbi.build_fused_hmc_kernel(pot.make_logistic_regression(x, y),
                                    num_steps=2, num_dims=16,
                                    interpret=True)


def test_gradient_only_trajectory_jaxprs():
    """Inside the trajectory only the gradient is evaluated: the value
    and gradient jaxprs are the potential's cut down to one output."""
    from jax._src.interpreters import partial_eval as pe
    fn, d, _ = _target("logreg")
    closed = fused_hmc.trace_potential(
        pot.batched_value_and_grad(fn), fused_hmc.BLOCK_WALKERS, d)
    value, _ = pe.dce_jaxpr(closed.jaxpr, [True, False])
    grad, _ = pe.dce_jaxpr(closed.jaxpr, [False, True])
    assert len(value.outvars) == len(grad.outvars) == 1
    assert len(grad.eqns) < len(closed.jaxpr.eqns)
    prims = {e.primitive.name for e in grad.eqns}
    assert "log1p" not in prims  # softplus is the value's alone
    fused_hmc.check_lowerable(closed)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["std_normal", "logreg", "gaussian"])
def test_compiled_fused_step_matches_xla_on_gpu(name):
    (sx, ix), (sf, i_f) = _both_steps(name, 1000, 8, interpret=False)
    agree = np.asarray(i_f.accepted) == np.asarray(ix.accepted)
    assert np.mean(~agree) < 1e-2
    np.testing.assert_allclose(np.asarray(sf.ensemble.q)[agree],
                               np.asarray(sx.ensemble.q)[agree], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.gpu
def test_run_hmc_kernel_fused_on_gpu():
    fn = pot.make_standard_normal(32)
    q0 = 2.0 + jax.random.normal(jax.random.key(7), (4096, 32))
    res = pbbi.run_hmc(jax.random.key(8), fn, q0, kernel="fused",
                       num_warmup=100, num_samples=100, num_steps=16,
                       collect="moments")
    assert res.kernel_used == "fused"
    np.testing.assert_allclose(np.asarray(res.mean), 0.0, atol=0.05)
    np.testing.assert_allclose(np.asarray(res.var), 1.0, atol=0.08)
