"""The reference's example models, written in the native DSL.

Behavioural parity targets (not code ports):
  * coin_toss — reference samples/NumpyroExamples/CoinToss/CoinToss.py:5-22
    (two independent coin biases, Uniform priors, Bernoulli observations;
    data JSON schema {"c1", "c2", "p1", "p2"}, CoinToss.data.json).
  * eight_schools — reference samples/NumpyroExamples/eight_schools.py:5-10
    (Normal mu, HalfCauchy tau, plate over J schools; data JSON schema
    {"J", "y", "sigma"}, eight_schools.data.json). Provided in the
    reference's centered form and the non-centered form (the
    funnel-free parameterisation HMC actually needs).
  * logistic_regression — BASELINE.json config 3.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import distributions as dist
from .core import plate, sample


def coin_toss(c1, c2):
    """Two independent coin biases with flat priors (see module doc)."""
    theta1 = sample("p1", dist.Uniform(0, 1))
    theta2 = sample("p2", dist.Uniform(0, 1))
    sample("obs1", dist.Bernoulli(theta1), obs=c1)
    sample("obs2", dist.Bernoulli(theta2), obs=c2)


def eight_schools(J, sigma, y):
    """Centered hierarchical model (the reference's exact parameterisation,
    eight_schools.py:5-10) — pathological funnel geometry, kept for parity
    studies."""
    mu = sample("mu", dist.Normal(0.0, 5.0))
    tau = sample("tau", dist.HalfCauchy(5.0))
    with plate("J", J):
        theta = sample("theta", dist.Normal(mu, tau))
        sample("obs", dist.Normal(theta, sigma), obs=y)


def eight_schools_noncentered(J, sigma, y):
    """Non-centered reparameterisation: theta = mu + tau * theta_raw with
    theta_raw ~ N(0, 1). Same posterior, geometry HMC samples well."""
    mu = sample("mu", dist.Normal(0.0, 5.0))
    tau = sample("tau", dist.HalfCauchy(5.0))
    with plate("J", J):
        theta_raw = sample("theta_raw", dist.Normal(0.0, 1.0))
        theta = mu + tau * theta_raw
        sample("obs", dist.Normal(theta, sigma), obs=y)


def logistic_regression(x, labels):
    """Bayesian logistic regression: w ~ N(0, 1)^P, b ~ N(0, 1),
    labels ~ Bernoulli(logits = x @ w + b). The per-walker logit matvec
    batches into a [W, P] x [P, N] matmul over the ensemble."""
    num_features = x.shape[-1]
    with plate("features", num_features):
        w = sample("w", dist.Normal(0.0, 1.0))
    b = sample("b", dist.Normal(0.0, 1.0))
    logits = x @ w + b
    sample("obs", dist.BernoulliLogits(logits), obs=labels)


def linear_regression(x, y, prior_scale=10.0):
    """Linear model with Normal noise — the second canonical test model in
    the reference's algorithm notes (references/NotesOnParticleBasedHMC.pdf:
    linear-model-with-normal-noise)."""
    num_features = x.shape[-1]
    with plate("features", num_features):
        w = sample("w", dist.Normal(0.0, prior_scale))
    b = sample("b", dist.Normal(0.0, prior_scale))
    noise = sample("noise", dist.HalfNormal(1.0))
    mean = x @ w + b
    sample("obs", dist.Normal(mean, noise), obs=y)


def funnel(dim=15, scale=3.0):
    """Neal's funnel as a hierarchical MODEL (the pathological geometry
    behind ops.potentials.make_funnel): x's prior scale depends on the
    latent v, so ``make_model_potential(funnel, reparam="auto")``
    decenters it automatically — the same mechanism that fixes the
    centered eight-schools. The decentered coordinates are
    literally a standard normal; the funnel geometry moves into the
    deterministic readout."""
    v = sample("v", dist.Normal(0.0, scale))
    with plate("dim", dim):
        sample("x", dist.Normal(0.0, jnp.exp(0.5 * v)))


EXAMPLE_MODELS = {
    "coin_toss": coin_toss,
    "eight_schools": eight_schools,
    "eight_schools_noncentered": eight_schools_noncentered,
    "logistic_regression": logistic_regression,
    "linear_regression": linear_regression,
    "funnel": funnel,
}


EIGHT_SCHOOLS_DATA = {
    # Rubin (1981) eight-schools data, as shipped by the reference
    # (samples/NumpyroExamples/eight_schools.data.json).
    "J": 8,
    "y": jnp.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0]),
    "sigma": jnp.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0]),
}


def synthetic_logreg_data(num_rows: int = 256, num_features: int = 31):
    """Seeded logistic-regression data set ``(x [N, P], labels [N])``:
    standard-normal features, true weights ~ N(0, 1), labels drawn from
    Bernoulli(sigmoid(x @ w_true)). The ``logreg_32_n256`` benchmark cell
    (P = 31 features + intercept = 32 latent dims, N = 256 rows)."""
    x = jax.random.normal(jax.random.key(7), (num_rows, num_features))
    w_true = jax.random.normal(jax.random.key(8), (num_features,))
    labels = (jax.random.uniform(jax.random.key(9), (num_rows,))
              < jax.nn.sigmoid(x @ w_true)).astype(jnp.float32)
    return x, labels
