"""Adaptive-sampler cost study: NUTS vs ChEES vs fixed-step HMC.

NUTS here is per-walker ``lax.while_loop`` under ``vmap`` (nuts.py) — on
an accelerator all walkers execute masked lockstep iterations bounded by
the slowest walker, so its *transitions/s* cannot
be inferred from the fused-HMC numbers. This harness measures, on the
same ill-conditioned 16-dim Gaussian (the round-1 sampler-matrix target,
benchmarks/run_benchmarks.py sampler_matrix), the quantities that decide
which adaptive sampler to recommend:

  * walker transitions/s (wall-clock, one-dispatch timed scan),
  * gradient evaluations/s (NUTS: measured leapfrog counts per walker;
    ChEES: the jittered per-transition step counts; HMC: fixed 16),
  * min-ESS/s (Geyer ESS over a walker subset, scaled to the ensemble —
    walkers are iid chains so ESS is linear in walker count),
  * gradient evaluations per unit of min-ESS (hardware-independent
    sampler efficiency; matches the round-1 matrix).

All samplers run unit mass (``adapt_mass=False``) so trajectory-length
adaptation — the thing NUTS and ChEES actually differ on — is the only
variable. One sampler per invocation:

    python benchmarks/sampler_cost.py <hmc16|chees|nuts>

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

NUM_WALKERS = int(os.environ.get("SAMPLER_COST_WALKERS", 4096))
NUM_DIMS = 16
NUM_WARMUP = int(os.environ.get("SAMPLER_COST_WARMUP", 500))
ESS_WALKERS = min(512, NUM_WALKERS)


def make_target():
    """16-dim diagonal Gaussian, stds logspace(0, 1): condition number 100
    in variance — long trajectories pay off, short ones random-walk.
    SAMPLER_COST_TARGET=eight_schools swaps in the non-centered
    eight-schools posterior (autodiff gradient through the model DSL —
    the expensive-potential regime where in-kernel gradient evaluation
    matters, vs the analytic diag-quadratic fast path)."""
    if os.environ.get("SAMPLER_COST_TARGET") == "eight_schools":
        from physicsbasedbayesianinference_tpu.models.examples import (
            EIGHT_SCHOOLS_DATA, eight_schools_noncentered)
        from physicsbasedbayesianinference_tpu.models.potential import (
            make_model_potential)
        global NUM_DIMS
        mp = make_model_potential(eight_schools_noncentered, (),
                                  EIGHT_SCHOOLS_DATA)
        NUM_DIMS = mp.num_dims
        return mp.potential, jnp.ones((mp.num_dims,))
    from physicsbasedbayesianinference_tpu.ops.potentials import make_gaussian
    stds = jnp.logspace(0.0, 1.0, NUM_DIMS)
    return make_gaussian(jnp.zeros(NUM_DIMS), cov=jnp.diag(stds**2)), stds


def timed_scan(step_collect, state, keys):
    """jit a scan of ``step_collect``; run twice (compile+warm, then timed);
    sync via scalar readback."""
    @jax.jit
    def run(state, keys):
        state, (hist, acc, nsteps) = jax.lax.scan(step_collect, state, keys)
        return state, hist, jnp.mean(acc), jnp.mean(nsteps)

    state, hist, acc, ns = run(state, keys)
    float(acc)
    print(f"# warm ns={float(ns):.3f} acc={float(acc):.3f}", file=sys.stderr)
    t0 = time.time()
    state, hist, acc, ns = run(state, keys)
    a = float(acc)
    wall = time.time() - t0
    return hist, a, float(ns), wall


def min_ess_per_sec(hist, wall):
    """hist: [T, ESS_WALKERS, D] -> min-over-dims ESS/s for the FULL
    ensemble (iid walkers: scale by NUM_WALKERS/ESS_WALKERS). ESS is
    scale-invariant per dimension, so no standardization is needed."""
    from physicsbasedbayesianinference_tpu.diagnostics import (
        effective_sample_size)
    ess = jax.jit(effective_sample_size)(hist)
    min_ess = float(jnp.min(ess)) * (NUM_WALKERS / ESS_WALKERS)
    return min_ess / wall, min_ess


def bench_hmc16(key, pot, q0):
    from physicsbasedbayesianinference_tpu.adaptation import (
        da_init, da_update)
    from physicsbasedbayesianinference_tpu.hmc import build_hmc_kernel
    num_steps = 16
    kernel = build_hmc_kernel(pot, num_steps=num_steps,
                              use_analytic_grad=True)
    state = kernel.init(q0)

    @jax.jit
    def warm(state, da, keys):
        def body(carry, k):
            st, da = carry
            st, info = kernel.step(k, st, jnp.exp(da.log_step))
            return (st, da_update(da, jnp.mean(info.accept_prob),
                                  target=0.8)), None
        (state, da), _ = jax.lax.scan(body, (state, da), keys)
        return state, jnp.exp(da.log_avg_step)

    key, kw = jax.random.split(key)
    state, step_size = warm(state, da_init(0.2),
                            jax.random.split(kw, NUM_WARMUP))
    float(step_size)

    def step_collect(st, k):
        st, info = kernel.step(k, st, step_size)
        return st, (st.ensemble.q[:ESS_WALKERS],
                    jnp.mean(info.accept_prob),
                    jnp.asarray(num_steps, jnp.float32))

    t = 512
    key, kt = jax.random.split(key)
    hist, acc, ns, wall = timed_scan(step_collect, state,
                                     jax.random.split(kt, t))
    return hist, acc, ns, wall, t, float(step_size)


def bench_chees(key, pot, q0):
    from physicsbasedbayesianinference_tpu.chees import (
        build_jittered_hmc_kernel, halton_sequence, run_chees_hmc)
    key, kw = jax.random.split(key)
    res = run_chees_hmc(kw, pot, q0, num_warmup=NUM_WARMUP, num_samples=1,
                        init_step_size=0.2, init_tau=2.0, max_steps=256,
                        collect="none")
    step_size = res.step_size
    tau = res.trajectory_time
    float(step_size)

    init_fn, step_fn = build_jittered_hmc_kernel(pot, max_steps=256)
    t = 512
    # halton jitter rides the scan xs, NOT a carried index: timed_scan
    # re-runs the scan from the warm pass's final carry, and a carried
    # index would walk off the end of the table (clamped OOB gather ->
    # h stuck at the last, tiny halton value -> 1-step trajectories).
    haltons = jnp.asarray(halton_sequence(t), jnp.float32)

    def step_collect(st, xs):
        k, h = xs
        n = jnp.clip(jnp.round(2.0 * h * tau / step_size).astype(jnp.int32),
                     1, 256)
        st, info, _ = step_fn(k, st, step_size, n)
        return st, (st.ensemble.q[:ESS_WALKERS],
                    jnp.mean(info.accept_prob),
                    n.astype(jnp.float32))

    key, kt = jax.random.split(key)
    print(f"# chees adapted tau={float(tau):.3f} eps={float(step_size):.3f}",
          file=sys.stderr)
    hist, acc, ns, wall = timed_scan(
        step_collect, res.state, (jax.random.split(kt, t), haltons))
    return hist, acc, ns, wall, t, float(step_size)


def bench_chees_warmup(key, pot, q0):
    """Warmup-PHASE throughput: the complete ChEES warmup body —
    jittered transition + criterion gradient (needs the pre-accept
    proposal endpoint) + Adam on log-tau + dual averaging. Prints its own
    JSON line and exits."""
    from physicsbasedbayesianinference_tpu.adaptation import (
        da_init, da_update)
    from physicsbasedbayesianinference_tpu.chees import (
        build_jittered_hmc_kernel, chees_gradient, chees_init,
        chees_update, halton_sequence)

    init_fn, step_fn = build_jittered_hmc_kernel(pot, max_steps=256)
    t = 256
    haltons = jnp.asarray(halton_sequence(t), jnp.float32)
    state = init_fn(q0)
    out = {"sampler": "chees_warmup", "num_walkers": NUM_WALKERS,
           "timed_transitions": t, "device": str(jax.devices()[0])}
    for tag, sfn in (("xla", step_fn),):
        @jax.jit
        def warm(state, keys, haltons, sfn=sfn):
            da = da_init(jnp.float32(0.2))
            ch = chees_init(2.0)

            def body(carry, xs):
                st, da, ch = carry
                k, h = xs
                eps = jnp.exp(da.log_step)
                n = jnp.clip(
                    jnp.round(2.0 * h * jnp.exp(ch.log_tau) / eps
                              ).astype(jnp.int32), 1, 256)
                q_before = st.ensemble.q
                st, info, (q1, p1) = sfn(k, st, eps, n)
                da = da_update(da, jnp.mean(info.accept_prob), target=0.8)
                g = chees_gradient(q_before, q1, p1, info.accept_prob,
                                   h, 1.0)
                ch = chees_update(ch, g)
                return (st, da, ch), jnp.mean(info.accept_prob)

            (st, da, ch), accs = jax.lax.scan(
                body, (state, da, ch), (keys, haltons))
            return st, jnp.exp(da.log_avg_step), jnp.exp(ch.log_tau), \
                jnp.mean(accs)

        keys = jax.random.split(jax.random.key(7), t)
        _, eps, tau, acc = warm(state, keys, haltons)
        float(acc)  # compile + sync
        t0 = time.time()
        _, eps, tau, acc = warm(state, keys, haltons)
        float(acc)
        wall = time.time() - t0
        out[tag] = {
            "warmup_transitions_per_sec": round(NUM_WALKERS * t / wall),
            "adapted_tau": round(float(tau), 3),
            "adapted_eps": round(float(eps), 4),
            "accept": round(float(acc), 3),
            "wall_seconds": round(wall, 3)}
    print(json.dumps(out))


def bench_nuts(key, pot, q0):
    from physicsbasedbayesianinference_tpu.nuts import (
        build_nuts_kernel, run_nuts)
    key, kw = jax.random.split(key)
    res = run_nuts(kw, pot, q0, num_warmup=NUM_WARMUP, num_samples=1,
                   max_depth=8, init_step_size=0.2, adapt_mass=False,
                   collect="none")
    step_size = res.step_size
    float(step_size)
    kernel = build_nuts_kernel(pot, max_depth=8)

    def step_collect(st, k):
        st, info = kernel.step(k, st, step_size)
        return st, (st.ensemble.q[:ESS_WALKERS],
                    jnp.mean(info.accept_prob),
                    jnp.mean(info.num_leapfrogs.astype(jnp.float32)))

    t = 128
    key, kt = jax.random.split(key)
    hist, acc, ns, wall = timed_scan(step_collect, res.state,
                                     jax.random.split(kt, t))
    return hist, acc, ns, wall, t, float(step_size)


def main():
    name = sys.argv[1]
    pot, stds = make_target()
    q0 = stds * jax.random.normal(jax.random.key(0),
                                  (NUM_WALKERS, NUM_DIMS), jnp.float32)
    if name == "chees_warmup":
        bench_chees_warmup(jax.random.key(1), pot, q0)
        return
    fn = {"hmc16": bench_hmc16, "chees": bench_chees, "nuts": bench_nuts}[name]
    hist, acc, mean_steps, wall, t, step_size = fn(jax.random.key(1), pot, q0)

    transitions_per_sec = t * NUM_WALKERS / wall
    grad_evals_per_sec = transitions_per_sec * mean_steps
    ess_rate, min_ess = min_ess_per_sec(hist, wall)
    print(json.dumps({
        "sampler": name,
        "target": f"ill_gauss_{NUM_DIMS} (cond 100)",
        "num_walkers": NUM_WALKERS,
        "timed_transitions": t,
        "transitions_per_sec": round(transitions_per_sec),
        "grad_evals_per_sec": round(grad_evals_per_sec),
        "min_ess_per_sec": round(ess_rate),
        "grads_per_min_ess": round(grad_evals_per_sec / max(ess_rate, 1e-9),
                                   1),
        "mean_steps_per_transition": round(mean_steps, 2),
        "accept": round(acc, 4),
        "step_size": round(step_size, 4),
        "wall_seconds": round(wall, 3),
        "device": str(jax.devices()[0]),
    }))


if __name__ == "__main__":
    main()
