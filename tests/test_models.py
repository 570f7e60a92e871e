"""Model-DSL tests: distributions, transforms, tracing, potentials, and
end-to-end posterior parity on the reference's example models
(reference samples/NumpyroExamples/: CoinToss.py, eight_schools.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as sps

import physicsbasedbayesianinference_tpu as pbbi
from physicsbasedbayesianinference_tpu import models
from physicsbasedbayesianinference_tpu.models import (
    distributions as dist,
    examples,
    transforms as tfm,
)


# ---------------------------------------------------------------------------
# distributions vs scipy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,ref,xs", [
    (dist.Normal(1.0, 2.0), sps.norm(1.0, 2.0), [-3.0, 0.0, 2.5]),
    (dist.HalfNormal(2.0), sps.halfnorm(0, 2.0), [0.1, 1.0, 5.0]),
    (dist.Cauchy(0.5, 2.0), sps.cauchy(0.5, 2.0), [-2.0, 0.5, 9.0]),
    (dist.HalfCauchy(5.0), sps.halfcauchy(0, 5.0), [0.2, 2.0, 30.0]),
    (dist.Uniform(-1.0, 3.0), sps.uniform(-1.0, 4.0), [-0.5, 0.0, 2.9]),
    (dist.Exponential(1.7), sps.expon(0, 1 / 1.7), [0.1, 1.0, 4.0]),
    (dist.Gamma(2.5, 1.3), sps.gamma(2.5, scale=1 / 1.3), [0.3, 2.0, 7.0]),
    (dist.Beta(2.0, 3.0), sps.beta(2.0, 3.0), [0.1, 0.5, 0.9]),
    (dist.LogNormal(0.3, 0.8), sps.lognorm(0.8, scale=np.exp(0.3)),
     [0.2, 1.0, 4.0]),
    (dist.StudentT(4.0, 0.5, 1.5), sps.t(4.0, 0.5, 1.5), [-2.0, 0.5, 3.0]),
    (dist.Laplace(0.2, 1.1), sps.laplace(0.2, 1.1), [-2.0, 0.2, 3.0]),
    (dist.InverseGamma(3.0, 2.0), sps.invgamma(3.0, scale=2.0),
     [0.2, 0.7, 3.0]),
    (dist.Weibull(1.7, 2.2), sps.weibull_min(1.7, scale=2.2),
     [0.3, 1.5, 5.0]),
])
def test_continuous_logpdf_matches_scipy(d, ref, xs):
    for x in xs:
        np.testing.assert_allclose(
            float(d.log_prob(jnp.asarray(x))), ref.logpdf(x),
            rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d,ref,xs", [
    (dist.Bernoulli(0.3), sps.bernoulli(0.3), [0, 1]),
    (dist.Binomial(10, 0.4), sps.binom(10, 0.4), [0, 4, 10]),
    (dist.Poisson(3.5), sps.poisson(3.5), [0, 3, 8]),
    (dist.NegativeBinomial(4.0, 0.35), sps.nbinom(4.0, 1.0 - 0.35),
     [0, 3, 11]),
])
def test_discrete_logpmf_matches_scipy(d, ref, xs):
    for x in xs:
        np.testing.assert_allclose(
            float(d.log_prob(jnp.asarray(float(x)))), ref.logpmf(x),
            rtol=1e-5, atol=1e-6)


def test_bernoulli_logits_matches_probs():
    logits = jnp.array([-2.0, 0.0, 1.5])
    p = jax.nn.sigmoid(logits)
    for v in (0.0, 1.0):
        np.testing.assert_allclose(
            dist.BernoulliLogits(logits).log_prob(v),
            dist.Bernoulli(p).log_prob(v), rtol=1e-5)


def test_categorical_matches_scipy():
    logits = jnp.array([0.3, -1.0, 2.0, 0.0])
    probs = np.exp(np.asarray(logits))
    probs /= probs.sum()
    d = dist.Categorical(logits)
    for k in range(4):
        np.testing.assert_allclose(float(d.log_prob(k)),
                                   np.log(probs[k]), rtol=1e-5)
    draws = np.asarray(d.sample(jax.random.key(0), (4000,)))
    freq = np.bincount(draws, minlength=4) / 4000.0
    np.testing.assert_allclose(freq, probs, atol=0.03)


def test_inverse_gamma_weibull_latent_sampling():
    """The new positive-support priors work as HMC latents end-to-end
    (exp-transform + Jacobian): posterior of a conjugate InvGamma
    variance model matches the analytic posterior mean."""
    from physicsbasedbayesianinference_tpu.hmc import run_hmc
    from physicsbasedbayesianinference_tpu.models.core import plate, sample
    from physicsbasedbayesianinference_tpu.models.potential import (
        make_model_potential)

    y = np.asarray([1.2, -0.4, 2.1, 0.3, -1.0, 0.8, 1.5, -0.2],
                   dtype=np.float32)

    def model(y):
        var = sample("var", dist.InverseGamma(3.0, 2.0))
        with plate("N", len(y)):
            sample("obs", dist.Normal(0.0, jnp.sqrt(var)), obs=jnp.asarray(y))

    mp = make_model_potential(model, (y,), {})
    res = run_hmc(jax.random.key(0), mp.potential,
                  mp.init(jax.random.key(1), 512), num_warmup=200,
                  num_samples=300, num_steps=10, collect="samples")
    var_samps = np.asarray(mp.unflatten(
        jnp.asarray(np.asarray(res.samples)[100:].reshape(-1, 1)))["var"])
    # conjugate posterior: InvGamma(a + n/2, b + sum(y^2)/2)
    a_post, b_post = 3.0 + len(y) / 2, 2.0 + float((y**2).sum()) / 2
    np.testing.assert_allclose(var_samps.mean(), b_post / (a_post - 1),
                               rtol=0.15)


def test_mvn_matches_scipy():
    mean = np.array([1.0, -2.0])
    cov = np.array([[2.0, 0.6], [0.6, 1.0]])
    d = dist.MultivariateNormal(mean, cov=cov)
    for x in ([0.0, 0.0], [1.0, -2.0], [3.0, 1.0]):
        np.testing.assert_allclose(
            float(d.log_prob(jnp.asarray(x))),
            sps.multivariate_normal(mean, cov).logpdf(x), rtol=1e-5)


def test_sampling_moments():
    key = jax.random.key(0)
    x = dist.Gamma(3.0, 2.0).sample(key, (200_000,))
    np.testing.assert_allclose(float(jnp.mean(x)), 1.5, rtol=0.02)
    x = dist.Beta(2.0, 5.0).sample(key, (200_000,))
    np.testing.assert_allclose(float(jnp.mean(x)), 2.0 / 7.0, rtol=0.02)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [
    tfm.IDENTITY, tfm.POSITIVE, tfm.UNIT_INTERVAL,
    tfm.IntervalTransform(-2.0, 5.0),
])
def test_transform_roundtrip_and_jacobian(t):
    x = jnp.linspace(-3.0, 3.0, 7)
    y = t.forward(x)
    np.testing.assert_allclose(t.inverse(y), x, rtol=1e-5, atol=1e-5)
    # log|J| vs autodiff
    jac = jax.vmap(jax.grad(lambda v: t.forward(v)))(x)
    np.testing.assert_allclose(
        t.log_det_jacobian(x), jnp.log(jnp.abs(jac)), rtol=1e-5, atol=1e-5)


def test_ordered_transform():
    t = tfm.ORDERED
    x = jnp.array([0.5, -1.0, 0.3, 2.0])
    y = t.forward(x)
    assert bool(jnp.all(jnp.diff(y) > 0))
    np.testing.assert_allclose(t.inverse(y), x, rtol=1e-5, atol=1e-6)
    # full Jacobian determinant vs autodiff
    J = jax.jacfwd(t.forward)(x)
    np.testing.assert_allclose(
        float(jnp.sum(t.log_det_jacobian(x))),
        float(jnp.linalg.slogdet(J)[1]), rtol=1e-5)


# ---------------------------------------------------------------------------
# DSL tracing / log_density
# ---------------------------------------------------------------------------

def _coin_data():
    # the reference's CoinToss.data.json observations
    c1 = jnp.array([1, 0] * 10, dtype=jnp.float32)
    c2 = jnp.array([1] * 15 + [0] * 5, dtype=jnp.float32)
    return c1, c2


def test_log_density_coin_toss_closed_form():
    """log_density must equal the analytic Bernoulli+Uniform joint, and its
    dict gradient must vanish at the MLE (the property the reference checks,
    CoinTossExample.py:96-109)."""
    c1, c2 = _coin_data()
    params = {"p1": 0.5, "p2": 0.75}
    logp, sites = models.log_density(
        examples.coin_toss, (), {"c1": c1, "c2": c2}, params)
    expected = (np.sum(sps.bernoulli(0.5).logpmf(np.asarray(c1)))
                + np.sum(sps.bernoulli(0.75).logpmf(np.asarray(c2))))
    np.testing.assert_allclose(float(logp), expected, rtol=1e-5)
    assert set(sites) == {"p1", "p2", "obs1", "obs2"}

    g = jax.grad(lambda p: models.log_density(
        examples.coin_toss, (), {"c1": c1, "c2": c2}, p)[0])(
        {"p1": 0.5, "p2": 0.75})
    np.testing.assert_allclose(g["p1"], 0.0, atol=1e-4)
    np.testing.assert_allclose(g["p2"], 0.0, atol=1e-4)


def test_seed_handler_draws_priors():
    sites = models.trace_model(
        examples.eight_schools, (),
        dict(examples.EIGHT_SCHOOLS_DATA), key=jax.random.key(3))
    assert sites["theta"].value.shape == (8,)
    assert float(sites["tau"].value) > 0.0
    assert sites["obs"].is_observed


def test_duplicate_site_raises():
    def bad():
        models.sample("a", dist.Normal())
        models.sample("a", dist.Normal())
    with pytest.raises(ValueError, match="duplicate"):
        models.trace_model(bad, key=jax.random.key(0))


def test_latent_without_handler_raises():
    def m():
        models.sample("a", dist.Normal())
    with pytest.raises(RuntimeError, match="handler"):
        m()


# ---------------------------------------------------------------------------
# ModelPotential: flatten/unflatten, jacobians, HMC end-to-end
# ---------------------------------------------------------------------------

def test_model_potential_roundtrip():
    mp = models.make_model_potential(
        examples.eight_schools, (), dict(examples.EIGHT_SCHOOLS_DATA))
    assert mp.num_dims == 10  # mu, tau, theta[8]
    params = {"mu": 1.0, "tau": 2.0,
              "theta": jnp.arange(8, dtype=jnp.float32)}
    q = mp.flatten(params)
    back = mp.unflatten(q)
    np.testing.assert_allclose(float(back["mu"]), 1.0, rtol=1e-5)
    np.testing.assert_allclose(float(back["tau"]), 2.0, rtol=1e-5)
    np.testing.assert_allclose(back["theta"], params["theta"],
                               rtol=1e-4, atol=1e-4)


def test_model_potential_jacobian_correction():
    """For a pure-prior model U(q) must be the pushforward density: with
    x ~ HalfCauchy and x = e^q, -U(q) = log hc(e^q) + q."""
    def m():
        models.sample("x", dist.HalfCauchy(2.0))

    mp = models.make_model_potential(m)
    q = jnp.asarray([0.7])
    expected = sps.halfcauchy(0, 2.0).logpdf(np.exp(0.7)) + 0.7
    np.testing.assert_allclose(-float(mp.potential(q)), expected, rtol=1e-5)


def test_discrete_latent_rejected():
    def m():
        models.sample("k", dist.Poisson(3.0))
    with pytest.raises(ValueError, match="discrete"):
        models.make_model_potential(m)


def test_coin_toss_posterior_end_to_end():
    """Full-stack parity run: ensemble HMC on the native coin_toss model
    recovers the conjugate Beta posterior means (the reference's oracle:
    CoinTossExample.py:59-65 checks the posterior mean against the true
    bias)."""
    c1, c2 = _coin_data()
    mp = models.make_model_potential(
        examples.coin_toss, (), {"c1": c1, "c2": c2})
    key = jax.random.key(7)
    res = pbbi.run_hmc(
        key, mp.potential, mp.init(key, 512),
        num_warmup=300, num_samples=300, num_steps=8, collect="samples")
    cons = mp.constrain_samples(res.samples)
    # conjugate posterior: Beta(1 + heads, 1 + tails)
    p1 = float(jnp.mean(cons["p1"]))
    p2 = float(jnp.mean(cons["p2"]))
    exp1 = (1 + float(jnp.sum(c1))) / (2 + c1.shape[0])
    exp2 = (1 + float(jnp.sum(c2))) / (2 + c2.shape[0])
    assert abs(p1 - exp1) < 0.02, (p1, exp1)
    assert abs(p2 - exp2) < 0.02, (p2, exp2)
    assert float(res.accept_rate) > 0.5


def test_eight_schools_noncentered_end_to_end():
    """Posterior parity on the reference's hierarchical example: mu and tau
    moments within MC error of long-NUTS published values (mu ~ 4.4,
    tau ~ 3.6 for this dataset)."""
    mp = models.make_model_potential(
        examples.eight_schools_noncentered, (),
        dict(examples.EIGHT_SCHOOLS_DATA))
    assert mp.num_dims == 10
    key = jax.random.key(11)
    res = pbbi.run_hmc(
        key, mp.potential, mp.init(key, 1024),
        num_warmup=500, num_samples=500, num_steps=12, collect="samples")
    cons = mp.constrain_samples(res.samples)
    mu = float(jnp.mean(cons["mu"]))
    tau = float(jnp.mean(cons["tau"]))
    assert abs(mu - 4.4) < 1.0, mu
    assert 2.5 < tau < 5.0, tau
    assert float(res.accept_rate) > 0.6


def test_logistic_regression_recovers_weights():
    key = jax.random.key(0)
    n, p = 400, 3
    true_w = jnp.array([1.5, -2.0, 0.5])
    x = jax.random.normal(key, (n, p))
    logits = x @ true_w + 0.3
    labels = jax.random.bernoulli(
        jax.random.key(1), jax.nn.sigmoid(logits)).astype(jnp.float32)
    mp = models.make_model_potential(
        examples.logistic_regression, (), {"x": x, "labels": labels})
    assert mp.num_dims == p + 1
    res = pbbi.run_hmc(
        jax.random.key(2), mp.potential, mp.init(jax.random.key(3), 512),
        num_warmup=300, num_samples=200, num_steps=16, collect="samples")
    cons = mp.constrain_samples(res.samples)
    w_mean = jnp.mean(cons["w"], axis=(0, 1))
    np.testing.assert_allclose(np.asarray(w_mean), np.asarray(true_w),
                               atol=0.5)


def test_uniform_array_bounds():
    """Array-valued Uniform bounds per plate site: each site gets its own
    interval bijection elementwise."""
    lo = jnp.asarray([0.0, 1.0, -2.0])
    hi = jnp.asarray([1.0, 3.0, 2.0])
    d = dist.Uniform(lo, hi)
    assert d.batch_shape == (3,)
    x = jnp.asarray([0.5, 2.0, 0.0])
    lp = d.log_prob(x)
    np.testing.assert_allclose(
        np.asarray(lp), -np.log(np.asarray(hi - lo)), rtol=1e-6)
    assert bool(jnp.isneginf(d.log_prob(jnp.asarray([2.0, 2.0, 0.0]))[0]))
    # bijection round-trip elementwise
    y = d.support.forward(jnp.zeros(3))
    np.testing.assert_allclose(np.asarray(y),
                               np.asarray(lo + 0.5 * (hi - lo)), rtol=1e-6)
    s = d.sample(jax.random.key(0), (100, 3))
    assert bool(jnp.all((s >= lo) & (s <= hi)))


def test_uniform_array_bounds_in_model():
    """A plated model with per-site Uniform bounds must produce a finite
    potential and correctly constrained samples."""
    from physicsbasedbayesianinference_tpu.models.potential import (
        make_model_potential)

    lo = jnp.asarray([0.0, 10.0])
    hi = jnp.asarray([1.0, 20.0])

    from physicsbasedbayesianinference_tpu.models.core import (
        plate, sample)

    def model():
        with plate("sites", 2):
            r = sample("rate", dist.Uniform(lo, hi))
            sample("obs", dist.Normal(r, 1.0),
                   obs=jnp.asarray([0.5, 15.0]))

    mp = make_model_potential(model, (), {})
    assert mp.num_dims == 2
    q = jax.random.normal(jax.random.key(0), (16, mp.num_dims))
    u = jax.vmap(mp.potential)(q)
    assert bool(jnp.all(jnp.isfinite(u)))
    cons = mp.unflatten(q)["rate"]
    assert bool(jnp.all((cons >= lo) & (cons <= hi)))


def test_nested_plate_dims_numpyro_semantics():
    """Nested plates allocate distinct batch dims NumPyro-style: the
    outermost plate takes the rightmost free dim (-1), inner plates move
    left, so samples under plate(a=3) > plate(b=5) have shape (5, 3)."""
    from physicsbasedbayesianinference_tpu.models.core import (
        plate, sample, seed, trace)

    with trace() as tr, seed(jax.random.key(0)):
        with plate("a", 3):
            sample("x", dist.Normal(0.0, 1.0))
            with plate("b", 5):
                sample("y", dist.Normal(0.0, 1.0))
    assert tr.sites["x"].value.shape == (3,)
    assert tr.sites["y"].value.shape == (5, 3)

    # explicit dim
    with trace() as tr2, seed(jax.random.key(1)):
        with plate("a", 3, dim=-2):
            sample("x", dist.Normal(0.0, 1.0))
    assert tr2.sites["x"].value.shape == (3, 1)

    # dim collision with an enclosing plate is an error
    import pytest
    with pytest.raises(ValueError, match="already taken"):
        with plate("a", 3, dim=-1), plate("b", 5, dim=-1):
            pass


def test_plate_subsample_scaling():
    """Minibatch subsampling: the block yields indices, sites inside draw
    subsample_size copies, and log_density rescales their log-prob by
    size/subsample_size (unbiased full-data estimate)."""
    from physicsbasedbayesianinference_tpu.models.core import (
        log_density, plate, sample)

    data = jnp.arange(10.0)
    k_sub = jax.random.key(42)

    seen = {}

    def model(data):
        mu = sample("mu", dist.Normal(0.0, 1.0))
        with plate("N", 10, subsample_size=4, key=k_sub) as idx:
            seen["idx"] = idx
            sample("obs", dist.Normal(mu, 1.0), obs=data[idx])

    mu0 = 0.7
    logp, sites = log_density(model, (data,), {}, {"mu": mu0})
    idx = np.asarray(seen["idx"])
    assert idx.shape == (4,)
    assert len(np.unique(idx)) == 4 and idx.min() >= 0 and idx.max() < 10
    assert sites["obs"].scale == pytest.approx(2.5)
    expected = (scipy_norm_logpdf(mu0, 0.0, 1.0)
                + 2.5 * sum(scipy_norm_logpdf(float(data[i]), mu0, 1.0)
                            for i in idx))
    np.testing.assert_allclose(float(logp), expected, rtol=1e-5)


def scipy_norm_logpdf(x, loc, scale):
    return float(-0.5 * ((x - loc) / scale) ** 2
                 - np.log(scale) - 0.5 * np.log(2.0 * np.pi))


def test_plate_subsample_needs_key():
    """Subsampling without a key and without a seed handler must raise,
    not silently bias the density."""
    from physicsbasedbayesianinference_tpu.models.core import (
        log_density, plate, sample)

    def model():
        with plate("N", 10, subsample_size=2) as idx:
            sample("obs", dist.Normal(0.0, 1.0),
                   obs=jnp.zeros(2) + 0.0 * idx[0])

    with pytest.raises(ValueError, match="needs randomness"):
        log_density(model, (), {}, {})


def test_plate_subsample_seed_handler_supplies_key():
    """Under seed(key) the plate draws its subsample indices from the
    handler's key — prior simulation of subsampled models just works."""
    from physicsbasedbayesianinference_tpu.models.core import (
        plate, sample, seed, trace)

    with trace() as tr, seed(jax.random.key(3)):
        with plate("N", 100, subsample_size=8):
            sample("x", dist.Normal(0.0, 1.0))
    assert tr.sites["x"].value.shape == (8,)
    assert tr.sites["x"].scale == pytest.approx(100.0 / 8.0)


# -- automatic non-centering (reparam) ---------------------------------------


def test_reparam_auto_matches_hand_noncentered_potential():
    """The reference's CENTERED eight-schools
    (reference samples/NumpyroExamples/eight_schools.py:5-10) under
    reparam="auto" must define EXACTLY the hand-non-centered model's
    unconstrained density (same latent dimension, same value at matched
    coordinates)."""
    from physicsbasedbayesianinference_tpu.models.examples import (
        EIGHT_SCHOOLS_DATA, eight_schools, eight_schools_noncentered)
    from physicsbasedbayesianinference_tpu.models.potential import (
        make_model_potential)

    mp_a = make_model_potential(eight_schools, (), EIGHT_SCHOOLS_DATA,
                                reparam="auto")
    mp_n = make_model_potential(eight_schools_noncentered, (),
                                EIGHT_SCHOOLS_DATA)
    assert mp_a.num_dims == mp_n.num_dims == 10
    assert [s.name for s in mp_a.specs] == ["mu", "tau", "theta_decentered"]
    q = jax.random.normal(jax.random.key(0), (64, mp_a.num_dims))
    ua = jax.vmap(mp_a.potential)(q)
    un = jax.vmap(mp_n.potential)(q)
    np.testing.assert_allclose(np.asarray(ua), np.asarray(un), rtol=1e-6)
    ga = jax.vmap(jax.grad(mp_a.potential))(q)
    gn = jax.vmap(jax.grad(mp_n.potential))(q)
    np.testing.assert_allclose(np.asarray(ga), np.asarray(gn), rtol=1e-5,
                               atol=1e-5)


def test_reparam_auto_leaves_constant_sites_alone():
    """auto only rewrites sites whose loc/scale depend on other latents:
    mu ~ Normal(0, 5) stays; theta ~ Normal(mu, tau) is decentered."""
    from physicsbasedbayesianinference_tpu.models.core import (
        reparametrized, seed, trace)
    from physicsbasedbayesianinference_tpu.models.examples import (
        EIGHT_SCHOOLS_DATA, eight_schools)

    model = reparametrized(eight_schools, "auto")
    with trace() as tr, seed(jax.random.key(0)):
        model(**EIGHT_SCHOOLS_DATA)
    assert not tr.sites["mu"].is_deterministic
    assert not tr.sites["tau"].is_deterministic
    assert tr.sites["theta"].is_deterministic
    assert "theta_decentered" in tr.sites
    assert float(np.abs(np.asarray(tr.sites["theta"].log_prob)).max()) == 0.0


def test_reparam_explicit_site_selection():
    from physicsbasedbayesianinference_tpu.models.examples import (
        EIGHT_SCHOOLS_DATA, eight_schools)
    from physicsbasedbayesianinference_tpu.models.potential import (
        make_model_potential)

    mp = make_model_potential(eight_schools, (), EIGHT_SCHOOLS_DATA,
                              reparam=["theta"])
    assert [s.name for s in mp.specs] == ["mu", "tau", "theta_decentered"]
    mp_none = make_model_potential(eight_schools, (), EIGHT_SCHOOLS_DATA,
                                   reparam={"theta": False})
    assert [s.name for s in mp_none.specs] == ["mu", "tau", "theta"]


def test_reparam_trace_values_recovers_deterministic_sites():
    from physicsbasedbayesianinference_tpu.models.examples import (
        EIGHT_SCHOOLS_DATA, eight_schools)
    from physicsbasedbayesianinference_tpu.models.potential import (
        make_model_potential)

    mp = make_model_potential(eight_schools, (), EIGHT_SCHOOLS_DATA,
                              reparam="auto")
    q = jax.random.normal(jax.random.key(1), (5, 10))
    vals = mp.trace_values(q)
    assert set(vals) >= {"mu", "tau", "theta", "theta_decentered"}
    theta = (vals["mu"][:, None]
             + vals["tau"][:, None] * vals["theta_decentered"])
    np.testing.assert_allclose(np.asarray(vals["theta"]),
                               np.asarray(theta), rtol=1e-6)


def test_reparam_centered_posterior_parity():
    """Sampling the auto-reparameterised centered model reproduces the
    hand-non-centered posterior (mu ~ 4.4, tau ~ 3.6 on the Rubin data —
    the reference's published check, CoinTossExample-style oracle)."""
    from physicsbasedbayesianinference_tpu.hmc import run_hmc
    from physicsbasedbayesianinference_tpu.models.examples import (
        EIGHT_SCHOOLS_DATA, eight_schools)
    from physicsbasedbayesianinference_tpu.models.potential import (
        make_model_potential)

    mp = make_model_potential(eight_schools, (), EIGHT_SCHOOLS_DATA,
                              reparam="auto")
    q0 = mp.init(jax.random.key(2), 256)
    res = run_hmc(jax.random.key(3), mp.potential, q0, num_warmup=300,
                  num_samples=300, num_steps=16, collect="samples")
    flat = np.asarray(res.samples).reshape(-1, mp.num_dims)
    cons = mp.unflatten(jnp.asarray(flat[::7]))
    mu = float(np.mean(np.asarray(cons["mu"])))
    tau = float(np.mean(np.asarray(cons["tau"])))
    assert abs(mu - 4.4) < 1.0, mu
    assert abs(tau - 3.6) < 1.2, tau


def test_reparam_funnel_model_decenters():
    """The funnel MODEL under reparam="auto" becomes a standard normal in
    the latent space (the x sites decenter against exp(v/2)): the
    potential at any q equals the iid-normal potential up to the
    constant, and sampling is trivial at a large fixed step — the
    documented fix for funnel-type geometry."""
    from physicsbasedbayesianinference_tpu.hmc import run_hmc
    from physicsbasedbayesianinference_tpu.models.examples import funnel
    from physicsbasedbayesianinference_tpu.models.potential import (
        make_model_potential)

    mp = make_model_potential(funnel, (7,), {}, reparam="auto")
    assert [s.name for s in mp.specs] == ["v", "x_decentered"]
    # gradient of the decentered potential is exactly q / diag(scale^2)
    # with v ~ N(0, 3) and x_dec ~ N(0, 1): a product of independent
    # normals — no funnel left
    q = jax.random.normal(jax.random.key(0), (16, 8))
    g = jax.vmap(jax.grad(mp.potential))(q)
    expected = q / jnp.concatenate(
        [jnp.full((16, 1), 9.0), jnp.ones((16, 7))], axis=1)
    np.testing.assert_allclose(np.asarray(g), np.asarray(expected),
                               rtol=1e-5, atol=1e-6)

    res = run_hmc(jax.random.key(1), mp.potential,
                  mp.init(jax.random.key(2), 512), num_warmup=150,
                  num_samples=150, num_steps=8, collect="samples")
    v = np.asarray(res.samples)[50:, :, 0].reshape(-1)
    assert abs(v.mean()) < 0.3
    assert abs(v.std() - 3.0) < 0.45


def test_reparam_bare_string_site_name():
    """reparam='theta' must mean the SITE 'theta', never the character
    sites 't','h','e','a' (strings are iterables — the silent-noop
    foot-gun found in the r5 review)."""
    from physicsbasedbayesianinference_tpu.models.examples import (
        EIGHT_SCHOOLS_DATA, eight_schools)
    from physicsbasedbayesianinference_tpu.models.potential import (
        make_model_potential)

    mp = make_model_potential(eight_schools, (), EIGHT_SCHOOLS_DATA,
                              reparam="theta")
    assert [s.name for s in mp.specs] == ["mu", "tau", "theta_decentered"]
