"""NumPyro interop tests.

Two layers:

1. **Shim-backed adapter execution** (always runs): the adapter's
   ravel/unravel, potential wiring, vmapped postprocess, and init run
   against tests/_numpyro_shim.py, which reproduces NumPyro's
   ``initialize_model`` contract exactly, backed by the native DSL. The
   adapter potential must reproduce the native potential and HMC on it
   must recover the same posterior.

2. **Real-NumPyro 3-way parity** (gated on numpyro being installed — CI
   installs it; this sandbox cannot): (a) this engine on the adapter
   potential, (b) this engine on the native DSL, (c) NumPyro's own NUTS
   (the reference's oracle, CoinTossExample.py:35-65) must agree on
   posterior means within MC error.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from physicsbasedbayesianinference_tpu.models.examples import (
    EIGHT_SCHOOLS_DATA,
    coin_toss,
    eight_schools_noncentered,
)
from physicsbasedbayesianinference_tpu.models.potential import (
    make_model_potential,
)

import _numpyro_shim as shim


def _real_numpyro_available() -> bool:
    try:
        import numpyro  # noqa: F401
        return not getattr(numpyro, "__is_pbbi_shim__", False)
    except ImportError:
        return False


@pytest.fixture()
def adapter_with_shim():
    """models.numpyro_adapter reloaded with the shim installed (real
    numpyro, when present, is never shadowed)."""
    shim.install()
    from physicsbasedbayesianinference_tpu.models import numpyro_adapter
    importlib.reload(numpyro_adapter)
    assert numpyro_adapter.HAS_NUMPYRO
    yield numpyro_adapter
    shim.uninstall()
    importlib.reload(numpyro_adapter)


def _coin_data():
    c1 = (jax.random.uniform(jax.random.key(4), (60,)) < 0.7).astype(
        jnp.float32)
    c2 = (jax.random.uniform(jax.random.key(5), (60,)) < 0.3).astype(
        jnp.float32)
    return {"c1": c1, "c2": c2}


def test_adapter_potential_matches_native(adapter_with_shim):
    data = _coin_data()
    mp_a = adapter_with_shim.from_numpyro(coin_toss, (), data)
    mp_n = make_model_potential(coin_toss, (), data)
    assert mp_a.num_dims == mp_n.num_dims == 2

    # same NAMED unconstrained params evaluated through both flattenings
    for seed in range(3):
        flat_n = mp_n.init(jax.random.key(seed), 1)[0]
        named = mp_n.unflatten_unconstrained(flat_n)
        flat_a = jnp.concatenate([
            jnp.reshape(named[k], (-1,))
            for k in sorted(named)])  # ravel_pytree sorts dict keys
        u_a = float(mp_a.potential(flat_a))
        u_n = float(mp_n.potential(flat_n))
        np.testing.assert_allclose(u_a, u_n, rtol=1e-5)


def test_adapter_unflatten_constrains(adapter_with_shim):
    data = _coin_data()
    mp_a = adapter_with_shim.from_numpyro(coin_toss, (), data)
    q = jax.random.normal(jax.random.key(0), (32, mp_a.num_dims)) * 3.0
    cons = mp_a.unflatten(q)
    for name in ("p1", "p2"):
        v = np.asarray(cons[name])
        assert v.shape[0] == 32
        assert (v > 0).all() and (v < 1).all()  # Uniform(0,1) support


def test_adapter_hmc_recovers_posterior(adapter_with_shim):
    """HMC on the adapter potential: coin-bias posterior mean must match
    the Beta(1 + heads, 1 + tails) conjugate answer — the quantitative
    form of the reference's CoinTossExample error check (lines 59-65)."""
    from physicsbasedbayesianinference_tpu import run_hmc
    data = _coin_data()
    mp_a = adapter_with_shim.from_numpyro(coin_toss, (), data)
    init_q = mp_a.init(jax.random.key(1), 1024, jitter=0.5)
    res = run_hmc(jax.random.key(2), mp_a.potential, init_q,
                  num_warmup=300, num_samples=300, num_steps=10,
                  collect="samples")
    cons = mp_a.unflatten(res.samples.reshape(-1, mp_a.num_dims))
    for name, series in (("p1", data["c1"]), ("p2", data["c2"])):
        heads = float(jnp.sum(series))
        n = series.shape[0]
        expected = (1.0 + heads) / (2.0 + n)  # Beta posterior mean
        got = float(jnp.mean(cons[name]))
        np.testing.assert_allclose(got, expected, atol=0.03)


def test_adapter_init_shape(adapter_with_shim):
    mp_a = adapter_with_shim.from_numpyro(
        eight_schools_noncentered, (), EIGHT_SCHOOLS_DATA)
    assert mp_a.num_dims == 10
    q = mp_a.init(jax.random.key(0), 7)
    assert q.shape == (7, 10)
    assert bool(jnp.all(jnp.isfinite(mp_a.potential(q[0]))))


# ---------------------------------------------------------------------------
# Real NumPyro (gated): the reference's actual oracle
# ---------------------------------------------------------------------------


@pytest.mark.skipif(not _real_numpyro_available(),
                    reason="numpyro not installed (CI installs it)")
def test_three_way_parity_eight_schools_real_numpyro():
    import numpyro
    import numpyro.distributions as npdist
    from numpyro.infer import MCMC, NUTS
    from physicsbasedbayesianinference_tpu import run_hmc
    from physicsbasedbayesianinference_tpu.models.numpyro_adapter import (
        from_numpyro)

    J = EIGHT_SCHOOLS_DATA["J"]
    y = EIGHT_SCHOOLS_DATA["y"]
    sigma = EIGHT_SCHOOLS_DATA["sigma"]

    def np_model(J, sigma, y=None):
        mu = numpyro.sample("mu", npdist.Normal(0.0, 5.0))
        tau = numpyro.sample("tau", npdist.HalfCauchy(5.0))
        with numpyro.plate("J", J):
            theta_raw = numpyro.sample("theta_raw", npdist.Normal(0.0, 1.0))
            theta = mu + tau * theta_raw
            numpyro.sample("obs", npdist.Normal(theta, sigma), obs=y)

    # (c) NumPyro's own NUTS — the reference's oracle
    mcmc = MCMC(NUTS(np_model), num_warmup=500, num_samples=1000,
                progress_bar=False)
    mcmc.run(jax.random.PRNGKey(0), J, sigma, y=y)
    mu_np = float(jnp.mean(mcmc.get_samples()["mu"]))

    # (a) this engine on the adapter potential
    mp_a = from_numpyro(np_model, (J, sigma), {"y": y})
    res_a = run_hmc(jax.random.key(1), mp_a.potential,
                    mp_a.init(jax.random.key(2), 2048, jitter=0.5),
                    num_warmup=400, num_samples=400, num_steps=12,
                    collect="samples")
    cons_a = mp_a.unflatten(res_a.samples.reshape(-1, mp_a.num_dims))
    mu_a = float(jnp.mean(cons_a["mu"]))

    # (b) this engine on the native DSL
    mp_n = make_model_potential(eight_schools_noncentered, (),
                                EIGHT_SCHOOLS_DATA)
    res_n = run_hmc(jax.random.key(3), mp_n.potential,
                    mp_n.init(jax.random.key(4), 2048),
                    num_warmup=400, num_samples=400, num_steps=12,
                    collect="samples")
    cons_n = mp_n.unflatten(res_n.samples.reshape(-1, mp_n.num_dims))
    mu_n = float(jnp.mean(cons_n["mu"]))

    np.testing.assert_allclose(mu_a, mu_np, atol=0.5)
    np.testing.assert_allclose(mu_n, mu_np, atol=0.5)
