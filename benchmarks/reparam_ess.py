"""ChEES min-ESS/s: centered vs reparam="auto" eight-schools.

The criterion it checks: the reference's CENTERED
eight-schools (reference samples/NumpyroExamples/eight_schools.py:5-10)
run through automatic non-centering must match the hand-non-centered
posterior AND reach >= 10x the centered model's min-ESS/s.

Prints one JSON line per variant.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax
import jax.numpy as jnp

NUM_WALKERS = int(os.environ.get("REPARAM_WALKERS", 65536))
TIMED = 256


def main():
    from physicsbasedbayesianinference_tpu.chees import (
        build_jittered_hmc_kernel, halton_sequence, run_chees_hmc)
    from physicsbasedbayesianinference_tpu.diagnostics import (
        effective_sample_size)
    from physicsbasedbayesianinference_tpu.models.examples import (
        EIGHT_SCHOOLS_DATA, eight_schools)
    from physicsbasedbayesianinference_tpu.models.potential import (
        make_model_potential)
    from physicsbasedbayesianinference_tpu.ops.potentials import (
        pad_potential)

    results = {}
    for variant, reparam in (("centered", None), ("reparam_auto", "auto")):
        mp = make_model_potential(eight_schools, (), EIGHT_SCHOOLS_DATA,
                                  reparam=reparam)
        pot = pad_potential(mp.potential, mp.num_dims)
        d = getattr(pot, "padded_dims", mp.num_dims)
        max_steps = 256
        q0 = mp.init(jax.random.key(0), NUM_WALKERS)
        q0 = jnp.concatenate(
            [q0, jax.random.normal(jax.random.key(99),
                                   (NUM_WALKERS, d - mp.num_dims))], -1)
        warm = run_chees_hmc(
            jax.random.key(1), pot, q0, num_warmup=300, num_samples=0,
            init_step_size=0.1, max_steps=max_steps, collect="none",
            kernel="auto")
        state, eps, tau = warm.state, warm.step_size, warm.trajectory_time
        _, step_fn = build_jittered_hmc_kernel(pot, max_steps=max_steps)
        ess_walkers = 512

        def body(st, xs):
            k, h = xs
            n = jnp.clip(jnp.round(2.0 * h * tau / eps).astype(jnp.int32),
                         1, max_steps)
            st, info, _ = step_fn(k, st, eps, n)
            return st, (st.ensemble.q[:ess_walkers, :mp.num_dims],
                        jnp.mean(info.accept_prob), n.astype(jnp.float32))

        @jax.jit
        def runner(st, keys, hs):
            st, (hist, acc, ns) = jax.lax.scan(body, st, (keys, hs))
            return st, hist, jnp.mean(acc), jnp.mean(ns)

        keys = jax.random.split(jax.random.key(2), TIMED)
        hs = jnp.asarray(halton_sequence(300 + TIMED)[300:], jnp.float32)
        st, hist, acc, ns = runner(state, keys, hs)
        float(acc)
        t0 = time.time()
        st, hist, acc, ns = runner(state, keys, hs)
        a = float(acc)
        wall = time.time() - t0
        ess = jax.jit(effective_sample_size)(hist)
        min_ess = float(jnp.min(ess)) * (NUM_WALKERS / ess_walkers)

        # posterior check in constrained space (mu ~ 4.4, tau ~ 3.6)
        cons = mp.unflatten(st.ensemble.q[:, :mp.num_dims])
        row = {
            "variant": variant,
            "min_ess_per_sec": round(min_ess / wall),
            "transitions_per_sec": round(TIMED * NUM_WALKERS / wall),
            "accept": round(a, 3), "mean_steps": round(float(ns), 1),
            "adapted_eps": round(float(eps), 4),
            "mu": round(float(jnp.mean(cons["mu"])), 3),
            "tau": round(float(jnp.mean(cons["tau"])), 3),
        }
        results[variant] = row
        print(json.dumps(row), flush=True)
    if "centered" in results and "reparam_auto" in results:
        print(json.dumps({"speedup_min_ess": round(
            results["reparam_auto"]["min_ess_per_sec"]
            / max(results["centered"]["min_ess_per_sec"], 1), 1)}),
            flush=True)


if __name__ == "__main__":
    main()
