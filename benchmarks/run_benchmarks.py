"""Benchmark suite: the five BASELINE.json reference configs on this engine.

Each config prints one JSON line {name, wall_s, metrics...}. The headline
device metric lives in bench.py; this suite records the broader
capability matrix (accuracy + throughput per config) for BASELINE.md.

Run: python benchmarks/run_benchmarks.py [--cpu] [--only NAME]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench(name):
    def deco(fn):
        BENCHES[name] = fn
        return fn
    return deco


BENCHES = {}


@bench("single_chain_gaussian")
def single_chain_gaussian(jax, jnp, np):
    """BASELINE config 1: single-chain HMC, 2D correlated Gaussian."""
    import physicsbasedbayesianinference_tpu as pbbi
    from physicsbasedbayesianinference_tpu.ops import potentials as pot
    mean = jnp.array([2.0, -1.0])
    cov = jnp.array([[1.0, 0.8], [0.8, 2.0]])
    res = pbbi.run_hmc(
        jax.random.key(0), pot.make_gaussian(mean, cov=cov),
        jnp.zeros((1, 2)), num_warmup=300, num_samples=1000, num_steps=16,
        collect="samples")
    flat = np.asarray(res.samples)[:, 0, :]
    return {
        "mean_abs_err": float(np.abs(flat.mean(0) - np.asarray(mean)).max()),
        "accept_rate": float(res.accept_rate),
        "transitions": 1300,
    }


@bench("ensemble_1k")
def ensemble_1k(jax, jnp, np):
    """BASELINE config 2: 1e3 walkers, std-normal + banana, diag mass."""
    import physicsbasedbayesianinference_tpu as pbbi
    from physicsbasedbayesianinference_tpu.ops import potentials as pot
    out = {}
    for name, target, tol in (
            ("std_normal", pot.make_standard_normal(32), 0.05),
            ("banana", pot.make_banana(), 0.3)):
        d = 32 if name == "std_normal" else 2
        res = pbbi.run_hmc(
            jax.random.key(1), target,
            jax.random.normal(jax.random.key(2), (1024, d)),
            num_warmup=300, num_samples=300, num_steps=16,
            collect="moments")
        out[f"{name}_accept"] = float(res.accept_rate)
        out[f"{name}_grad_evals"] = res.num_grad_evals
        if name == "std_normal":
            out["std_normal_var_err"] = float(
                jnp.max(jnp.abs(res.var - 1.0)))
    return out


@bench("model_interop")
def model_interop(jax, jnp, np):
    """BASELINE config 3: eight-schools + logistic regression via the
    model DSL (the NumPyro-contract layer)."""
    import physicsbasedbayesianinference_tpu as pbbi
    from physicsbasedbayesianinference_tpu import models
    from physicsbasedbayesianinference_tpu.models import examples
    mp = models.make_model_potential(
        examples.eight_schools_noncentered, (),
        dict(examples.EIGHT_SCHOOLS_DATA))
    res = pbbi.run_nuts(
        jax.random.key(3), mp.potential, mp.init(jax.random.key(4), 1024),
        num_warmup=400, num_samples=400, max_depth=8)
    cons = mp.constrain_samples(res.samples)
    mu = float(jnp.mean(cons["mu"]))
    tau = float(jnp.mean(cons["tau"]))

    n, p = 1024, 8
    x = jax.random.normal(jax.random.key(5), (n, p))
    w_true = jax.random.normal(jax.random.key(6), (p,))
    labels = jax.random.bernoulli(
        jax.random.key(7), jax.nn.sigmoid(x @ w_true)).astype(jnp.float32)
    mp2 = models.make_model_potential(
        examples.logistic_regression, (), {"x": x, "labels": labels})
    res2 = pbbi.run_hmc(
        jax.random.key(8), mp2.potential,
        mp2.init(jax.random.key(9), 1024),
        num_warmup=300, num_samples=200, num_steps=16)
    w_post = jnp.mean(mp2.constrain_samples(res2.samples)["w"], axis=(0, 1))
    return {
        "eight_schools_mu": mu, "eight_schools_tau": tau,
        "mu_err_vs_published": abs(mu - 4.4),
        "logreg_w_rmse": float(
            jnp.sqrt(jnp.mean((w_post - w_true) ** 2))),
        "logreg_accept": float(res2.accept_rate),
    }


@bench("nbody_tempering")
def nbody_tempering(jax, jnp, np):
    """BASELINE config 4: N-body potential ensemble with SMC tempering."""
    from physicsbasedbayesianinference_tpu import smc
    from physicsbasedbayesianinference_tpu.ops import potentials as pot
    n_bodies = 8
    mass = jnp.ones((n_bodies,))
    target = pot.make_nbody_potential(mass, n_bodies, 3, softening=0.3)
    init_q = 2.0 * jax.random.normal(
        jax.random.key(10), (2048, n_bodies * 3))
    res = smc.run_smc(
        jax.random.key(11), target, init_q,
        num_mutation_steps=3, num_leapfrog_steps=8, init_step_size=0.3,
        beta0=0.05, max_stages=30)
    return {
        "num_stages": int(res.num_stages),
        "log_evidence": float(res.log_evidence),
        "mean_stage_accept": float(jnp.mean(
            res.accept_history[:res.num_stages])),
    }


@bench("sharded_100k")
def sharded_100k(jax, jnp, np):
    """BASELINE config 5: 1e5-walker sharded ensemble through the
    multi-device surface — parallel.sharded_run_hmc (GSPMD over the XLA
    engine). On one device this is the single-shard datapoint of the
    scaling curve."""
    from physicsbasedbayesianinference_tpu.ops import potentials as pot
    from physicsbasedbayesianinference_tpu.parallel import (
        make_walker_mesh, sharded_run_hmc)
    w, d, steps, iters = 102_400, 32, 16, 256
    target = pot.make_standard_normal(d)
    mesh = make_walker_mesh()
    q0 = jax.random.normal(jax.random.key(12), (w, d), dtype=jnp.float32)
    kw = dict(num_warmup=0, num_samples=iters, num_steps=steps,
              init_step_size=0.63, collect="none")
    sharded_run_hmc(jax.random.key(13), target, q0, mesh=mesh, **kw)
    res = sharded_run_hmc(jax.random.key(14), target, q0, mesh=mesh, **kw)
    tps = iters * w / res.sampling_seconds
    return {
        "devices": len(jax.devices()),
        "kernel_used": res.kernel_used,
        "accept_rate": float(res.accept_rate),
        "walker_transitions_per_sec": round(tps),
        "per_device_transitions_per_sec": round(tps / len(jax.devices())),
    }


@bench("sampler_matrix")
def sampler_matrix(jax, jnp, np):
    """ESS per gradient evaluation across samplers on an ill-conditioned
    Gaussian (condition number 100): fixed-length HMC vs ChEES-adapted
    trajectories vs NUTS. The efficiency ladder that motivates adaptive
    trajectory lengths."""
    import physicsbasedbayesianinference_tpu as pbbi
    from physicsbasedbayesianinference_tpu import diagnostics as diag
    from physicsbasedbayesianinference_tpu.chees import run_chees_hmc
    from physicsbasedbayesianinference_tpu.ops import potentials as pot

    d, w, s = 16, 512, 400
    sds = jnp.logspace(0.0, 1.0, d)  # sd 1..10
    target = pot.make_gaussian(jnp.zeros((d,)), cov=jnp.diag(sds**2))
    init = jax.random.normal(jax.random.key(20), (w, d)) * sds
    out = {}

    res_h = pbbi.run_hmc(jax.random.key(21), target, init,
                         num_warmup=300, num_samples=s, num_steps=16)
    grads_h = 16 + 1
    out["hmc16_ess_per_grad"] = float(
        jnp.min(diag.effective_sample_size(res_h.samples)) / (s * w * grads_h))

    res_c = run_chees_hmc(jax.random.key(22), target, init,
                          num_warmup=300, num_samples=s, init_tau=1.0,
                          init_step_size=0.2)
    out["chees_mean_steps"] = float(res_c.mean_num_steps)
    out["chees_ess_per_grad"] = float(
        jnp.min(diag.effective_sample_size(res_c.samples))
        / (s * w * (res_c.mean_num_steps + 1)))

    res_n = pbbi.run_nuts(jax.random.key(23), target, init,
                          num_warmup=300, num_samples=s, max_depth=7)
    # NUTS grad count ~ mean 2^depth per transition
    n_grads = float(2.0 ** res_n.mean_depth)
    out["nuts_mean_depth"] = float(res_n.mean_depth)
    out["nuts_ess_per_grad"] = float(
        jnp.min(diag.effective_sample_size(res_n.samples))
        / (s * w * (n_grads + 1)))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--only", default=None)
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    for name, fn in BENCHES.items():
        if args.only and name != args.only:
            continue
        t0 = time.time()
        try:
            metrics = fn(jax, jnp, np)
            metrics["wall_s"] = round(time.time() - t0, 2)
            print(json.dumps({"bench": name, **metrics}))
        except Exception as e:  # keep the suite going
            print(json.dumps({"bench": name, "error": repr(e)}))


if __name__ == "__main__":
    main()
