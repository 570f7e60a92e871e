"""Per-model throughput cells: the models people actually fit —
eight-schools (the reference's flagship example), Neal's funnel, Bayesian
logistic regression — through the XLA engine:

  * ``xla``:   fixed-L (16-step) HMC transitions/s through
    ``hmc.build_hmc_kernel``, one jitted ``lax.scan`` of transitions;
  * ``chees``: the practitioner's number — ChEES-adapted trajectory
    lengths (``run_chees_hmc`` warmup, then a timed scan of
    Halton-jittered transitions) in Geyer **min-ESS/s** on the real model.

``bench.py`` calls :func:`run_case` in its own process; standalone:

    python benchmarks/model_bench.py <target> <kind>

targets: std_normal_32 | funnel_16 | eight_schools_nc_p16 | logreg_32_n256
kinds:   xla | chees

Prints one JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax
import jax.numpy as jnp

NUM_WALKERS = int(os.environ.get("MODEL_BENCH_WALKERS", 102_400))
NUM_STEPS = 16
TIMED_TRANSITIONS = int(os.environ.get("MODEL_BENCH_TRANSITIONS", 256))
TARGETS = ("std_normal_32", "funnel_16", "eight_schools_nc_p16",
           "logreg_32_n256")


def get_target(name: str):
    """-> (potential_fn, num_dims, tuned step size)."""
    from physicsbasedbayesianinference_tpu.models.examples import (
        EIGHT_SCHOOLS_DATA, eight_schools_noncentered, logistic_regression,
        synthetic_logreg_data)
    from physicsbasedbayesianinference_tpu.models.potential import (
        make_model_potential)
    from physicsbasedbayesianinference_tpu.ops.potentials import (
        make_funnel, make_standard_normal, pad_potential)

    if name == "std_normal_32":
        return make_standard_normal(32), 32, 0.6
    if name == "funnel_16":
        return make_funnel(16), 16, 0.2
    if name == "eight_schools_nc_p16":
        mp = make_model_potential(eight_schools_noncentered, (),
                                  EIGHT_SCHOOLS_DATA)
        return pad_potential(mp.potential, mp.num_dims, 16), 16, 0.22
    if name == "logreg_32_n256":
        mp = make_model_potential(logistic_regression,
                                  synthetic_logreg_data(), {})
        return mp.potential, 32, 0.05
    raise ValueError(f"unknown target {name!r} (want one of {TARGETS})")


def _device() -> dict:
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def run_xla_case(name: str) -> dict:
    """Fixed-L HMC transitions/s through the XLA engine."""
    from physicsbasedbayesianinference_tpu.hmc import build_hmc_kernel

    pot, d, dt0 = get_target(name)
    kernel = build_hmc_kernel(pot, num_steps=NUM_STEPS)
    q = 0.3 * jax.random.normal(jax.random.key(0), (NUM_WALKERS, d),
                                jnp.float32)
    state = kernel.init(q)

    @jax.jit
    def runner(st, keys):
        def body(st, k):
            st, info = kernel.step(k, st, jnp.float32(dt0))
            return st, jnp.mean(info.accept_prob)
        st, accs = jax.lax.scan(body, st, keys)
        return st, jnp.mean(accs)

    keys = jax.random.split(jax.random.key(1), TIMED_TRANSITIONS)
    _, acc = runner(state, keys)        # compile + warm, identical shapes
    jax.block_until_ready(acc)
    t0 = time.perf_counter()
    _, acc = runner(state, keys)
    acc = jax.block_until_ready(acc)
    wall = time.perf_counter() - t0
    return {
        "target": name, "kind": "xla", "kernel_used": kernel.kind,
        "transitions_per_sec": NUM_WALKERS * TIMED_TRANSITIONS / wall,
        "grad_evals_per_sec": (NUM_WALKERS * TIMED_TRANSITIONS
                               * NUM_STEPS / wall),
        "accept": float(acc), "wall_seconds": wall, "device": _device(),
    }


def run_chees_case(name: str) -> dict:
    """ChEES-adapted min-ESS/s on a real model: warmup (XLA jittered
    kernel + ChEES/dual-averaging adaptation), then a one-dispatch timed
    scan of Halton-jittered transitions."""
    from physicsbasedbayesianinference_tpu.chees import (
        build_jittered_hmc_kernel, halton_sequence, run_chees_hmc)
    from physicsbasedbayesianinference_tpu.diagnostics import (
        effective_sample_size)

    pot, d, dt0 = get_target(name)
    ess_walkers = 512
    max_steps = 256
    q0 = 0.3 * jax.random.normal(jax.random.key(0), (NUM_WALKERS, d),
                                 jnp.float32)
    warm = run_chees_hmc(
        jax.random.key(1), pot, q0, num_warmup=300, num_samples=0,
        init_step_size=dt0, max_steps=max_steps, collect="none")
    state, eps, tau = warm.state, warm.step_size, warm.trajectory_time
    _, step_fn = build_jittered_hmc_kernel(pot, max_steps=max_steps)

    def body(st, xs):
        k, h = xs
        n = jnp.clip(jnp.round(2.0 * h * tau / eps).astype(jnp.int32),
                     1, max_steps)
        st, info, _ = step_fn(k, st, eps, n)
        return st, (st.ensemble.q[:ess_walkers, :min(d, 8)],
                    jnp.mean(info.accept_prob), n.astype(jnp.float32))

    @jax.jit
    def runner(st, keys, hs):
        st, (hist, acc, ns) = jax.lax.scan(body, st, (keys, hs))
        return st, hist, jnp.mean(acc), jnp.mean(ns)

    keys = jax.random.split(jax.random.key(2), TIMED_TRANSITIONS)
    hs = jnp.asarray(
        halton_sequence(300 + TIMED_TRANSITIONS)[300:], jnp.float32)
    _, hist, acc, ns = runner(state, keys, hs)
    jax.block_until_ready(acc)          # compile + warm
    t0 = time.perf_counter()
    _, hist, acc, ns = runner(state, keys, hs)
    acc = jax.block_until_ready(acc)
    wall = time.perf_counter() - t0

    ess = jax.jit(effective_sample_size)(hist)
    min_ess = float(jnp.min(ess)) * (NUM_WALKERS / ess_walkers)
    mean_steps = float(ns)
    return {
        "target": name, "kind": "chees", "kernel_used": warm.kernel_used,
        "min_ess_per_sec": min_ess / wall,
        "transitions_per_sec": NUM_WALKERS * TIMED_TRANSITIONS / wall,
        "grad_evals_per_sec": (NUM_WALKERS * TIMED_TRANSITIONS
                               * mean_steps / wall),
        "mean_steps": mean_steps, "trajectory_time": float(tau),
        "step_size": float(eps), "accept": float(acc),
        "wall_seconds": wall, "device": _device(),
    }


def run_case(name: str, kind: str) -> dict:
    if kind == "xla":
        return run_xla_case(name)
    if kind == "chees":
        return run_chees_case(name)
    raise ValueError(f"unknown kind {kind!r} (want xla|chees)")


if __name__ == "__main__":
    print(json.dumps(run_case(sys.argv[1], sys.argv[2])))
