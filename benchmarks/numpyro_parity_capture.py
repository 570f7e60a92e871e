"""Capture the NumPyro-interop parity numbers as a JSON artifact.

The reference's interop contract is NumPyro NUTS actually executing and
agreeing with the engine (reference
samples/NumpyroExamples/CoinToss/CoinTossExample.py:35-65). The CI gate
(.github/workflows/ci.yml) already fails if the real-NumPyro 3-way test
skips; this script additionally RECORDS the numbers:

    python benchmarks/numpyro_parity_capture.py [out.json]

- With real numpyro installed (CI): runs NumPyro's own NUTS on the
  non-centered eight-schools model, plus this engine through BOTH the
  numpyro adapter and the native DSL, and writes all three posterior
  means -> committed/uploaded as ``numpyro_parity.json``.
- Without numpyro (this sandbox has no network/pip): records the two
  engine paths against the PUBLISHED eight-schools posterior
  (mu ~ 4.4, tau ~ 3.6 — Gelman et al., the values the NumPyro example
  gallery reproduces), with ``"numpyro": null`` and the reason.
"""

from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax
import jax.numpy as jnp

from physicsbasedbayesianinference_tpu import run_hmc
from physicsbasedbayesianinference_tpu.models.examples import (
    EIGHT_SCHOOLS_DATA, eight_schools_noncentered)
from physicsbasedbayesianinference_tpu.models.potential import (
    make_model_potential)

PUBLISHED = {"mu": 4.4, "tau": 3.6}  # Gelman et al. / NumPyro gallery


def engine_moments(mp, key_init, key_run):
    res = run_hmc(jax.random.key(key_run), mp.potential,
                  mp.init(jax.random.key(key_init), 2048),
                  num_warmup=400, num_samples=400, num_steps=12,
                  collect="samples")
    cons = mp.unflatten(res.samples.reshape(-1, mp.num_dims))
    return {"mu": round(float(jnp.mean(cons["mu"])), 3),
            "tau": round(float(jnp.mean(cons["tau"])), 3)}


def main():
    out = {"model": "eight_schools_noncentered",
           "published_oracle": PUBLISHED}

    mp_n = make_model_potential(eight_schools_noncentered, (),
                                EIGHT_SCHOOLS_DATA)
    out["engine_native_dsl"] = engine_moments(mp_n, 4, 3)

    try:
        import numpyro
        import numpyro.distributions as npdist
        from numpyro.infer import MCMC, NUTS
        from physicsbasedbayesianinference_tpu.models.numpyro_adapter \
            import from_numpyro

        J = EIGHT_SCHOOLS_DATA["J"]
        y = EIGHT_SCHOOLS_DATA["y"]
        sigma = EIGHT_SCHOOLS_DATA["sigma"]

        def np_model(J, sigma, y=None):
            mu = numpyro.sample("mu", npdist.Normal(0.0, 5.0))
            tau = numpyro.sample("tau", npdist.HalfCauchy(5.0))
            with numpyro.plate("J", J):
                theta_raw = numpyro.sample(
                    "theta_raw", npdist.Normal(0.0, 1.0))
                numpyro.sample(
                    "obs", npdist.Normal(mu + tau * theta_raw, sigma),
                    obs=y)

        mcmc = MCMC(NUTS(np_model), num_warmup=500, num_samples=1000,
                    progress_bar=False)
        mcmc.run(jax.random.PRNGKey(0), J, sigma, y=y)
        s = mcmc.get_samples()
        out["numpyro_nuts"] = {
            "mu": round(float(jnp.mean(s["mu"])), 3),
            "tau": round(float(jnp.mean(s["tau"])), 3)}

        mp_a = from_numpyro(np_model, (J, sigma), {"y": y})
        out["engine_numpyro_adapter"] = engine_moments(mp_a, 2, 1)
        oracle = out["numpyro_nuts"]
    except ImportError as e:
        out["numpyro_nuts"] = None
        out["note"] = (f"real numpyro unavailable ({e}); engine compared "
                       f"against the published posterior only")
        oracle = PUBLISHED

    for k in ("engine_native_dsl", "engine_numpyro_adapter"):
        if k in out:
            out[f"{k}_abs_err_mu"] = round(
                abs(out[k]["mu"] - oracle["mu"]), 3)
    out["pass"] = all(
        out[f"{k}_abs_err_mu"] < 0.5
        for k in ("engine_native_dsl", "engine_numpyro_adapter")
        if f"{k}_abs_err_mu" in out)

    dest = sys.argv[1] if len(sys.argv) > 1 else None
    line = json.dumps(out, indent=1)
    print(line)
    if dest:
        with open(dest, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
