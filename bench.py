"""Headline benchmark: effective samples/sec/device at ~10^5 walkers.

Prints JSON lines; the last one is the complete record:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "detail": ...}

Config (BASELINE.json north star): ensemble HMC, 102400 walkers, 32-dim
standard-normal target, 16 leapfrog steps/transition, diagonal unit metric,
initialised in the stationary distribution so ESS is well-defined. The
engine is whatever ``run_hmc(kernel="auto")`` resolves to
(``hmc.resolve_kernel_choice``); ``detail.integrator`` records it.

Baseline: the reference implementation (pure-Python per-walker loops with a
jax.grad dispatch per walker per step, reference src/HMC.py:123-183 +
integrator.py:94-123) measures ~220 gradient evaluations/second on a
CPU, dimension-independent because it is dispatch-bound
(benchmarks/measure_reference.py, BASELINE.md). Both samplers spend the same
gradient budget per transition at equal config, so
vs_baseline = (our grad evals/sec) / 220.

The timed region is ONE device-side lax.scan over all transitions, ended by
``block_until_ready``; the ESS autocorrelation is computed on device. All
cells run in this one process (a second JAX process could not get the
card's memory). The script exits non-zero when JAX finds no GPU.
"""

import json
import os
import sys
import time

_SCRIPT_T0 = time.time()
# One global wall budget for the WHOLE script (headline + extras): the
# headline prints the moment it exists and every extra derives its
# remaining time from this budget.
TOTAL_BUDGET_S = float(os.environ.get("BENCH_TOTAL_BUDGET_S", "1300"))


def _remaining() -> float:
    return TOTAL_BUDGET_S - (time.time() - _SCRIPT_T0)


import jax
import jax.numpy as jnp

from physicsbasedbayesianinference_tpu.adaptation import da_init, da_update
from physicsbasedbayesianinference_tpu.ops import potentials as pot

REF_GRAD_EVALS_PER_SEC = 220.0  # measured: benchmarks/measure_reference.py

NUM_WALKERS = int(os.environ.get("BENCH_WALKERS", 102_400))
NUM_DIMS = 32
NUM_STEPS = 16
ADAPT_ITERS = 40
TIMED_TRANSITIONS = int(os.environ.get("BENCH_TRANSITIONS", 256))
ESS_WALKERS = 512
ESS_DIMS = 4
MAX_LAG = 64


def device_ess_fraction(hist):
    """Mean ESS fraction via initial-positive-sequence autocorrelations,

    computed entirely on device. hist: [T, W, D] -> scalar in (0, 1]."""
    t = hist.shape[0]
    x = hist - jnp.mean(hist, axis=0, keepdims=True)
    var = jnp.mean(x * x, axis=0) + 1e-12

    def rho(lag):
        prod = x[:t - lag] * x[lag:]
        return jnp.mean(jnp.mean(prod, axis=0) / var)

    rhos = jnp.stack([rho(lag) for lag in range(1, min(MAX_LAG, t))])
    # truncate at first negative autocorrelation
    positive = jnp.cumprod(rhos > 0.0) > 0
    tau = 1.0 + 2.0 * jnp.sum(jnp.where(positive, rhos, 0.0))
    return jnp.clip(1.0 / tau, 1e-4, 1.0)


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py measures the GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        sys.exit(2)
    from physicsbasedbayesianinference_tpu.hmc import build_hmc_kernel
    from physicsbasedbayesianinference_tpu.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()

    target = pot.make_standard_normal(NUM_DIMS)
    # the engine kernel="auto" resolves to (hmc.resolve_kernel_choice)
    kernel = build_hmc_kernel(target, num_steps=NUM_STEPS)

    key = jax.random.key(0)
    key, k_init = jax.random.split(key)
    q0 = jax.random.normal(k_init, (NUM_WALKERS, NUM_DIMS), dtype=jnp.float32)
    state = kernel.init(q0)

    # --- step-size adaptation (not timed) -----------------------------------
    @jax.jit
    def adapt_block(state, da, keys):
        def body(carry, k):
            st, da = carry
            st, info = kernel.step(k, st, jnp.exp(da.log_step))
            da = da_update(da, jnp.mean(info.accept_prob), target=0.8)
            return (st, da), None
        (state, da), _ = jax.lax.scan(body, (state, da), keys)
        return state, da

    key, k_adapt = jax.random.split(key)
    state, da = adapt_block(state, da_init(0.2),
                            jax.random.split(k_adapt, ADAPT_ITERS))
    step_size = jax.block_until_ready(jnp.exp(da.log_avg_step))

    @jax.jit
    def run_block(state, keys, step_size):
        def body(st, k):
            st, info = kernel.step(k, st, step_size)
            return st, (st.ensemble.q[:ESS_WALKERS, :ESS_DIMS],
                        jnp.mean(info.accept_prob))
        state, (hist, acc) = jax.lax.scan(body, state, keys)
        return state, hist, jnp.mean(acc)

    key, k_warm, k_sel, k_timed = jax.random.split(key, 4)
    # compile + warm with identical shapes
    state, _, acc = run_block(
        state, jax.random.split(k_warm, TIMED_TRANSITIONS), step_size)
    jax.block_until_ready(acc)

    # --- step-size selection (not timed) ------------------------------------
    # Fixed-length HMC on this target is resonance-sensitive: the ESS
    # fraction swings ~2x within +-8% of step size (measured r4: frac
    # 1.0 at eps 0.63 vs 0.56 at 0.68, equal throughput). Dual averaging
    # targets ACCEPTANCE, not ESS, so its endpoint wanders across that
    # swing run-to-run. Evaluate the ESS fraction at a few candidates
    # around the adapted step — step_size is a traced argument, so every
    # candidate reuses the one compiled run_block — and keep the argmax
    # (throughput is step-size independent at fixed L). Selection keys
    # are fixed across candidates; the timed run uses fresh keys.
    sel_keys = jax.random.split(k_sel, TIMED_TRANSITIONS)
    ess_jit = jax.jit(device_ess_fraction)
    selection = {}
    best_eps, best_frac = float(step_size), -1.0
    for factor in (0.85, 0.93, 1.0, 1.08):
        eps = float(step_size) * factor
        _, hist_c, _ = run_block(state, sel_keys, jnp.float32(eps))
        frac_c = float(ess_jit(hist_c))
        selection[round(eps, 4)] = round(frac_c, 4)
        # ties (both clipped at frac 1.0) prefer the larger step: more
        # exploration per gradient at equal measured decorrelation
        if frac_c > best_frac or (frac_c == best_frac and eps > best_eps):
            best_eps, best_frac = eps, frac_c
    step_size = jnp.float32(best_eps)

    t0 = time.perf_counter()
    state, hist, acc = run_block(
        state, jax.random.split(k_timed, TIMED_TRANSITIONS), step_size)
    jax.block_until_ready((state, hist, acc))
    elapsed = time.perf_counter() - t0
    accept_rate = float(acc)

    frac = float(jax.jit(device_ess_fraction)(hist))

    walker_transitions_per_sec = TIMED_TRANSITIONS * NUM_WALKERS / elapsed
    ess_per_sec = walker_transitions_per_sec * frac
    grad_evals_per_sec = walker_transitions_per_sec * (NUM_STEPS + 1)

    n_dev = max(len(jax.devices()), 1)
    result = {
        "metric": "effective_samples_per_sec_per_device",
        "value": round(ess_per_sec / n_dev, 1),
        "unit": (f"ESS/s/device (32-dim std normal, {NUM_WALKERS} walkers, "
                 "16-step HMC)"),
        "vs_baseline": round(grad_evals_per_sec / REF_GRAD_EVALS_PER_SEC, 1),
        "detail": {
            "walker_transitions_per_sec": round(walker_transitions_per_sec),
            "grad_evals_per_sec": round(grad_evals_per_sec),
            "accept_rate": round(accept_rate, 4),
            "ess_fraction_per_transition": round(frac, 4),
            "step_size": round(float(step_size), 4),
            "step_size_selection": selection,
            "wall_seconds_timed": round(elapsed, 3),
            "timed_transitions": TIMED_TRANSITIONS,
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": n_dev},
            "integrator": kernel.kind,
            "baseline_grad_evals_per_sec": REF_GRAD_EVALS_PER_SEC,
        },
    }
    # FAIL-SAFE: the headline is a complete record on its own — print and
    # flush it NOW, before any extra measurement can hang or overrun.
    # The driver parses the LAST stdout line, so the enriched second line
    # below supersedes this one when (and only when) the extras finish.
    print(json.dumps(result), flush=True)

    if _remaining() > 120.0:
        try:
            result["detail"]["run_hmc_surface"] = run_hmc_surface_bench(
                target, step_size)
        except Exception as e:  # headline must survive any extra's failure
            result["detail"]["run_hmc_surface"] = {"error": repr(e)[:300]}
    else:
        result["detail"]["run_hmc_surface"] = {"skipped": "budget"}

    def emit(models):
        """Re-print the full enriched record after every model cell: the
        LAST stdout line is the record, so a cut at any point still
        keeps every cell completed so far."""
        result["detail"]["models"] = models
        best = None
        for tgt, kinds in models.items():
            row = kinds.get("chees")
            if isinstance(row, dict) and "min_ess_per_sec" in row:
                if best is None or row["min_ess_per_sec"] > best["value"]:
                    best = {"target": tgt,
                            "value": round(row["min_ess_per_sec"]),
                            "mean_steps": row.get("mean_steps")}
        if best is not None:
            # what a practitioner buys: adaptive-sampler min-ESS/s on a
            # real model, beside the synthetic metric
            result["real_model_min_ess_per_sec"] = best
            result["detail"]["real_model_chees_min_ess_per_sec"] = best
        print(json.dumps(result), flush=True)

    model_benches(emit)


def run_hmc_surface_bench(target, step_size):
    """Measure THROUGH the product surface (hmc.run_hmc with
    kernel='auto') at the headline config. Two calls: the first compiles
    the sampling scan, the second reuses it; sampling_seconds is synced
    inside run_hmc."""
    from physicsbasedbayesianinference_tpu.hmc import run_hmc
    q0 = jax.random.normal(jax.random.key(11),
                           (NUM_WALKERS, NUM_DIMS), dtype=jnp.float32)
    # 4x the headline transition count, so run_hmc's fixed per-call cost
    # does not read as a surface penalty
    n_surface = 4 * TIMED_TRANSITIONS
    kw = dict(num_warmup=0, num_samples=n_surface,
              num_steps=NUM_STEPS, init_step_size=float(step_size),
              collect="none", kernel="auto")
    run_hmc(jax.random.key(12), target, q0, **kw)  # compile
    res = run_hmc(jax.random.key(13), target, q0, **kw)
    tps = n_surface * NUM_WALKERS / res.sampling_seconds
    return {
        "transitions_per_sec": round(tps),
        "kernel_used": res.kernel_used,
        "accept_rate": round(float(res.accept_rate), 4),
        "sampling_seconds": round(res.sampling_seconds, 3),
    }


def model_benches(emit=None):
    """Real-model cells (benchmarks/model_bench.py), run in this process
    one after another: the three targets' ChEES min-ESS/s first (they
    feed the real-model headline), then fixed-L HMC transitions/s through
    the XLA engine. The sweep spends whatever is left of
    BENCH_TOTAL_BUDGET_S (overridable with BENCH_MODEL_BUDGET_S); every
    cell carries a number or a reason: {"skipped": "budget"} or
    {"error": ...}. ``emit`` is called after every cell.
    Returns {target: {kind: result}}."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "benchmarks"))
    from model_bench import run_case

    budget = float(os.environ.get("BENCH_MODEL_BUDGET_S",
                                  str(max(_remaining(), 0.0))))
    deadline = time.time() + budget
    targets = ("funnel_16", "eight_schools_nc_p16", "logreg_32_n256")
    cells = [("chees", t) for t in targets] + [("xla", t) for t in targets]
    out: dict = {t: {k: {"skipped": "budget"} for k in ("chees", "xla")}
                 for t in targets}
    for kind, target in cells:
        if deadline - time.time() < 120.0:
            continue
        try:
            row = run_case(target, kind)
            if kind == "chees":
                out[target][kind] = {
                    "min_ess_per_sec": round(row["min_ess_per_sec"]),
                    "transitions_per_sec": round(
                        row["transitions_per_sec"]),
                    "mean_steps": round(row["mean_steps"], 1),
                    "engine": row["kernel_used"],
                }
            else:
                out[target][kind] = {
                    "transitions_per_sec": round(
                        row["transitions_per_sec"]),
                    "engine": row["kernel_used"],
                }
        except Exception as e:  # one cell's failure must not end the sweep
            out[target][kind] = {"error": repr(e)[-300:]}
        if emit is not None:
            emit(out)
    return out


if __name__ == "__main__":
    main()
