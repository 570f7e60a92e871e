"""CLI driver: config -> model -> sampler -> metrics + saved samples.

The entry point the reference never wrote (reference src/main.py is an
empty file, SURVEY.md §2 #7). Usage:

    python -m physicsbasedbayesianinference_tpu.main --config run.json
    python -m physicsbasedbayesianinference_tpu.main \
        --model example:eight_schools_noncentered --data schools.json \
        --sampler nuts --num-walkers 4096

Model references:
  builtin:<name>      analytic target from ops.potentials.builtin_potentials
  example:<name>      native-DSL model from models.examples (+ --data JSON,
                      the reference's data-file convention,
                      samples/NumpyroExamples/*/*.data.json)
  numpyro:<mod>:<fn>  a NumPyro model (requires numpyro installed)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import diagnostics
from .config import RunConfig
from .constants import NATURAL, SI


def _load_data(path: Optional[str]) -> dict:
    if path is None:
        return {}
    with open(path) as f:
        raw = json.load(f)
    out = {}
    for k, v in raw.items():
        if isinstance(v, list):
            out[k] = jnp.asarray(np.asarray(v, dtype=np.float32))
        else:
            out[k] = v
    return out


def _reparam_config(cfg: RunConfig):
    """RunConfig.reparam string -> make_model_potential's reparam arg:
    "" -> None (off), "auto" -> automatic non-centering, else a
    comma-separated site-name list."""
    if not cfg.reparam:
        return None
    if cfg.reparam == "auto":
        return "auto"
    return [s.strip() for s in cfg.reparam.split(",") if s.strip()]


def build_potential(cfg: RunConfig):
    """Resolve the config's model reference to (potential_fn, init_fn,
    constrain_fn or None)."""
    kind, _, name = cfg.model.partition(":")
    if kind == "builtin":
        from .ops.potentials import builtin_potentials
        registry = builtin_potentials()
        if name not in registry:
            raise ValueError(
                f"unknown builtin {name!r}; have {sorted(registry)}")
        fn = registry[name]()
        num_dims = {"std_normal_2d": 2, "std_normal_32d": 32, "banana": 2,
                    "funnel_10d": 10}.get(name, 2)

        def init(key, w):
            return jax.random.normal(key, (w, num_dims))
        return fn, init, None
    if kind == "example":
        from .models import make_model_potential
        from .models.examples import EXAMPLE_MODELS
        if name not in EXAMPLE_MODELS:
            raise ValueError(
                f"unknown example {name!r}; have {sorted(EXAMPLE_MODELS)}")
        data = _load_data(cfg.data_path)
        # integer-valued metadata (e.g. eight_schools J) stays python.
        # Data files may carry extra keys the model does not take (the
        # reference's CoinToss.data.json records the true biases p1/p2 for
        # error reporting) — pass only what the model signature accepts.
        import inspect
        params = inspect.signature(EXAMPLE_MODELS[name]).parameters
        data = {k: v for k, v in data.items() if k in params}
        mp = make_model_potential(EXAMPLE_MODELS[name], (), data,
                                  reparam=_reparam_config(cfg))
        return mp.potential, mp.init, mp.constrain_samples
    if kind == "numpyro":
        if cfg.reparam:
            # the native reparam handler rewrites THIS DSL's sample
            # sites; it cannot see inside a numpyro model's trace.
            # Fail fast rather than silently sampling the centered
            # geometry the flag exists to fix — numpyro users apply
            # numpyro.handlers.reparam/LocScaleReparam to the model
            # before referencing it here.
            raise ValueError(
                "reparam= applies to example:/native-DSL models only; "
                "for numpyro: models wrap the model with numpyro's own "
                "reparam handlers before passing it")
        from .models.numpyro_adapter import from_numpyro
        mod_name, _, fn_name = name.partition(":")
        import importlib
        model = getattr(importlib.import_module(mod_name), fn_name)
        data = _load_data(cfg.data_path)
        mp = from_numpyro(model, (), data)
        return mp.potential, mp.init, mp.unflatten
    raise ValueError(f"bad model reference {cfg.model!r} "
                     f"(want builtin:/example:/numpyro:)")


def run(cfg: RunConfig) -> dict:
    """Execute the configured run; returns the result summary dict."""
    constants = {"natural": NATURAL, "si": SI}[cfg.constants]
    potential_fn, init_fn, constrain = build_potential(cfg)
    key = jax.random.key(cfg.seed)
    key, k_init, k_run = jax.random.split(key, 3)
    init_q = init_fn(k_init, cfg.num_walkers)

    if cfg.sharded:
        # every sampler shards the walker axis the same way: place the
        # positions with a walker sharding and let XLA partition the
        # scans (GSPMD), which cannot partition the fused pallas_call
        from .hmc import require_xla_kernel
        from .parallel.mesh import make_walker_mesh, walker_sharding
        require_xla_kernel(cfg.kernel, "sharded runs")
        init_q = jax.device_put(
            init_q, walker_sharding(make_walker_mesh(), init_q.ndim))

    print(f"# model={cfg.model} sampler={cfg.sampler} "
          f"walkers={cfg.num_walkers} dims={init_q.shape[-1]} "
          f"devices={len(jax.devices())}", file=sys.stderr)

    t0 = time.perf_counter()
    summary: dict = {"config": dataclasses.asdict(cfg)}
    samples = None

    if cfg.collect == "stream":
        # Stream thinned sample chunks to the native binary sink
        # (native.SampleSink) instead of holding [S, W, D] in RAM — the
        # mode that makes 1e5-walker histories possible (the reference's
        # all-in-RAM buffer, HMC.py:136-145, cannot).
        if not cfg.output_path:
            raise ValueError("collect='stream' requires output_path")
        summary.update(_stream_run(
            cfg, potential_fn, init_q, k_run, constants))
        summary["wall_seconds"] = round(time.perf_counter() - t0, 3)
        return summary

    if cfg.sampler == "smc" and cfg.checkpoint_dir:
        summary.update(_checkpointed_smc_run(
            cfg, potential_fn, init_q, k_run, constants))
        summary["wall_seconds"] = round(time.perf_counter() - t0, 3)
        return summary

    if cfg.sampler in ("hmc", "nuts", "chees", "pt") and cfg.checkpoint_dir:
        summary.update(_checkpointed_run(
            cfg, potential_fn, init_q, k_run, constants))
        summary["wall_seconds"] = round(time.perf_counter() - t0, 3)
        return summary

    if cfg.sampler == "hmc":
        kw = dict(
            num_warmup=cfg.num_warmup, num_samples=cfg.num_samples,
            num_steps=cfg.num_steps, init_step_size=cfg.init_step_size,
            target_accept=cfg.target_accept, adapt_mass=cfg.adapt_mass,
            temperature=cfg.temperature, constants=constants,
            collect=cfg.collect, thin=cfg.thin)
        from .hmc import run_hmc
        res = run_hmc(k_run, potential_fn, init_q, kernel=cfg.kernel,
                      metric=cfg.metric, **kw)
        samples = res.samples
        summary.update(
            accept_rate=float(res.accept_rate),
            divergence_rate=float(res.divergence_rate),
            step_size=float(res.step_size),
            num_grad_evals=res.num_grad_evals,
            kernel_used=res.kernel_used,
            sampling_seconds=round(res.sampling_seconds, 3))
        if res.mean is not None:
            summary["posterior_mean"] = np.asarray(res.mean).tolist()
            summary["posterior_var"] = np.asarray(res.var).tolist()
    elif cfg.sampler == "nuts":
        from .hmc import require_xla_kernel
        from .nuts import run_nuts
        require_xla_kernel(cfg.kernel, "nuts")
        res = run_nuts(
            k_run, potential_fn, init_q,
            num_warmup=cfg.num_warmup, num_samples=cfg.num_samples,
            max_depth=cfg.max_depth, init_step_size=cfg.init_step_size,
            target_accept=cfg.target_accept, adapt_mass=cfg.adapt_mass,
            temperature=cfg.temperature, constants=constants,
            collect=cfg.collect)
        samples = res.samples
        summary.update(
            accept_rate=float(res.accept_rate),
            divergence_rate=float(res.divergence_rate),
            mean_tree_depth=float(res.mean_depth),
            step_size=float(res.step_size),
            kernel_used="xla")
    elif cfg.sampler == "chees":
        from .chees import run_chees_hmc
        res = run_chees_hmc(
            k_run, potential_fn, init_q,
            num_warmup=cfg.num_warmup, num_samples=cfg.num_samples,
            init_step_size=cfg.init_step_size,
            target_accept=cfg.target_accept, temperature=cfg.temperature,
            constants=constants, kernel=cfg.kernel,
            collect="samples" if cfg.collect == "samples" else cfg.collect)
        samples = res.samples
        summary.update(
            accept_rate=float(res.accept_rate),
            divergence_rate=float(res.divergence_rate),
            step_size=float(res.step_size),
            trajectory_time=float(res.trajectory_time),
            mean_num_steps=float(res.mean_num_steps),
            kernel_used=res.kernel_used)
        if res.mean is not None:
            summary["posterior_mean"] = np.asarray(res.mean).tolist()
            summary["posterior_var"] = np.asarray(res.var).tolist()
    elif cfg.sampler == "pt":
        from .tempering import run_parallel_tempering
        res = run_parallel_tempering(
            k_run, potential_fn, init_q,
            num_replicas=cfg.pt_replicas, beta_min=cfg.pt_beta_min,
            num_warmup=cfg.num_warmup, num_samples=cfg.num_samples,
            num_steps=cfg.num_steps, init_step_size=cfg.init_step_size,
            target_accept=cfg.target_accept, temperature=cfg.temperature,
            constants=constants, kernel=cfg.kernel,
            collect="samples" if cfg.collect == "samples" else cfg.collect)
        samples = res.samples
        summary.update(
            accept_rates=np.asarray(res.accept_rate).tolist(),
            swap_rates=np.asarray(res.swap_rate).tolist(),
            step_sizes=np.asarray(res.step_sizes).tolist(),
            betas=np.asarray(res.betas).tolist(),
            kernel_used=res.kernel_used)
        if res.mean is not None:
            summary["posterior_mean"] = np.asarray(res.mean).tolist()
            summary["posterior_var"] = np.asarray(res.var).tolist()
    elif cfg.sampler == "smc":
        from .smc import run_smc
        res = run_smc(
            k_run, potential_fn, init_q,
            num_mutation_steps=3, num_leapfrog_steps=cfg.num_steps,
            init_step_size=cfg.init_step_size, beta0=cfg.smc_beta0,
            max_stages=cfg.smc_max_stages, temperature=cfg.temperature,
            constants=constants, kernel=cfg.kernel)
        samples = res.q[None]
        summary.update(
            log_evidence=float(res.log_evidence),
            num_stages=int(res.num_stages),
            final_step_size=float(res.final_step_size))
    else:
        raise ValueError(f"unknown sampler {cfg.sampler!r}")

    summary["wall_seconds"] = round(time.perf_counter() - t0, 3)

    if samples is not None:
        s = jnp.asarray(samples)
        diag = diagnostics.summary(s)
        summary["posterior_mean"] = np.asarray(diag["mean"]).tolist()
        summary["posterior_sd"] = np.asarray(diag["sd"]).tolist()
        summary["min_ess"] = float(jnp.min(diag["ess"]))
        summary["max_rhat"] = float(jnp.max(diag["rhat"]))
        if constrain is not None:
            cons = constrain(s)
            summary["constrained_means"] = {
                k: np.asarray(jnp.mean(v, axis=(0, 1))).tolist()
                for k, v in cons.items()}

    if cfg.output_path:
        arrays = {"summary": json.dumps(summary)}
        if samples is not None:
            arrays["samples"] = np.asarray(samples)
        np.savez_compressed(cfg.output_path, **arrays)
        print(f"# wrote {cfg.output_path}", file=sys.stderr)
    return summary


# Version of the _checkpointed_run payload structure. v2 = the round-3
# layout (added "tau") + the "schema" key itself.
CHECKPOINT_SCHEMA = 2


def _checkpointed_run(cfg: RunConfig, potential_fn, init_q, key,
                      constants) -> dict:
    """Fault-tolerant sampling for every scan-shaped sampler (hmc, nuts,
    chees, pt — they share a ``warmup once, then step(key, state, ...)``
    chunk interface): warmup once, then sample in chunks of
    ``checkpoint_every`` transitions, checkpointing {sampler state, adapted
    step size (+ ChEES trajectory time), streaming moments, RNG chunk
    index} after each chunk. Re-running the same config
    against the same ``checkpoint_dir`` resumes from the latest checkpoint
    — the recovery story SURVEY.md §5 specifies (restart with the same
    topology and continue); the reference persists nothing (HMC.py:136-145
    keeps everything in RAM). Collection is streaming moments (O(D) state
    — checkpoints stay small at any walker count). The HMC path honours
    ``cfg.kernel``."""
    from .checkpoint import CheckpointManager
    from .hmc import resolve_kernel_choice

    num_dims = init_q.shape[-1]
    dtype = init_q.dtype
    every = cfg.checkpoint_every if cfg.checkpoint_every > 0 \
        else cfg.num_samples
    mgr = CheckpointManager(cfg.checkpoint_dir)

    # ---- sampler-specific warmup + chunk transition --------------------
    # warm(key) -> (state, step_size, tau); tstep(k, st, eps, tau, x) ->
    # (st', mean accept) with x the per-transition scan input (the Halton
    # draw for chees, a dummy zero otherwise).
    if cfg.sampler == "hmc":
        from .hmc import (build_fused_hmc_kernel, build_hmc_kernel,
                          run_hmc)
        if resolve_kernel_choice(cfg.kernel) == "fused":
            kern = build_fused_hmc_kernel(
                potential_fn, num_steps=cfg.num_steps, num_dims=num_dims,
                temperature=cfg.temperature, constants=constants)
        else:
            kern = build_hmc_kernel(
                potential_fn, num_steps=cfg.num_steps,
                temperature=cfg.temperature, constants=constants)

        def warm(k):
            w = run_hmc(
                k, potential_fn, init_q,
                num_warmup=cfg.num_warmup, num_samples=0,
                num_steps=cfg.num_steps,
                init_step_size=cfg.init_step_size,
                target_accept=cfg.target_accept,
                adapt_mass=cfg.adapt_mass, temperature=cfg.temperature,
                constants=constants, collect="none", kernel=cfg.kernel)
            return w.state, w.step_size, jnp.zeros((), dtype)

        def tstep(k, st, eps, tau, x):
            st, info = kern.step(k, st, eps)
            return st, jnp.mean(info.accept_prob)

        init_state = kern.init
        xs_all = np.zeros((cfg.num_samples,), np.float32)
    elif cfg.sampler == "nuts":
        from .hmc import require_xla_kernel
        from .nuts import build_nuts_kernel, run_nuts
        require_xla_kernel(cfg.kernel, "nuts")
        kern = build_nuts_kernel(
            potential_fn, max_depth=cfg.max_depth,
            temperature=cfg.temperature, constants=constants)

        def warm(k):
            w = run_nuts(
                k, potential_fn, init_q,
                num_warmup=cfg.num_warmup, num_samples=0,
                max_depth=cfg.max_depth,
                init_step_size=cfg.init_step_size,
                target_accept=cfg.target_accept,
                adapt_mass=cfg.adapt_mass, temperature=cfg.temperature,
                constants=constants, collect="none")
            return w.state, w.step_size, jnp.zeros((), dtype)

        def tstep(k, st, eps, tau, x):
            st, info = kern.step(k, st, eps)
            return st, jnp.mean(info.accept_prob)

        init_state = kern.init
        xs_all = np.zeros((cfg.num_samples,), np.float32)
    elif cfg.sampler == "chees":
        from .chees import (build_jittered_hmc_kernel, halton_sequence,
                            run_chees_hmc)
        max_steps = 1024
        init_fn, step_fn = build_jittered_hmc_kernel(
            potential_fn, max_steps=max_steps,
            temperature=cfg.temperature, constants=constants)

        def warm(k):
            w = run_chees_hmc(
                k, potential_fn, init_q,
                num_warmup=cfg.num_warmup, num_samples=0,
                init_step_size=cfg.init_step_size,
                target_accept=cfg.target_accept,
                temperature=cfg.temperature, constants=constants,
                collect="none", kernel=cfg.kernel)
            return w.state, w.step_size, w.trajectory_time

        def tstep(k, st, eps, tau, h):
            n = jnp.clip(jnp.round(2.0 * h * tau / eps).astype(jnp.int32),
                         1, max_steps)
            st, info, _ = step_fn(k, st, eps, n)
            return st, jnp.mean(info.accept_prob)

        init_state = init_fn
        # the SAME Halton tail an uninterrupted run would consume, so
        # resumed trajectories reproduce the planned jitter schedule
        xs_all = np.asarray(
            halton_sequence(cfg.num_warmup + cfg.num_samples)
        )[cfg.num_warmup:]
    else:  # pt — replica state is a plain pytree dict, per-replica eps
        from .tempering import (build_pt_transition, geometric_ladder,
                                run_parallel_tempering)
        betas = geometric_ladder(cfg.pt_replicas, cfg.pt_beta_min, dtype)
        num_rep = int(betas.shape[0])
        pt_trans, pt_vg = build_pt_transition(
            potential_fn, betas=betas,
            num_steps=cfg.num_steps, temperature=cfg.temperature,
            constants=constants, kernel=cfg.kernel, dtype=dtype)

        def warm(k):
            w = run_parallel_tempering(
                k, potential_fn, init_q, betas=betas,
                num_warmup=cfg.num_warmup, num_samples=0,
                num_steps=cfg.num_steps,
                init_step_size=cfg.init_step_size,
                target_accept=cfg.target_accept,
                temperature=cfg.temperature, constants=constants,
                collect="none", kernel=cfg.kernel)
            u, g = jax.vmap(pt_vg)(w.q)
            state = {"q": w.q, "u": u, "g": g,
                     "i": jnp.zeros((), jnp.int32)}
            return state, w.step_sizes, jnp.zeros((), dtype)

        def tstep(k, st, eps, tau, x):
            q, u, g, acc, _ = pt_trans(
                k, st["q"], st["u"], st["g"], eps, st["i"])
            return ({"q": q, "u": u, "g": g, "i": st["i"] + 1},
                    jnp.mean(acc))

        def init_state(q2d):
            qr = jnp.broadcast_to(q2d, (num_rep,) + q2d.shape)
            u, g = jax.vmap(pt_vg)(qr)
            return {"q": qr, "u": u, "g": g,
                    "i": jnp.zeros((), jnp.int32)}

        xs_all = np.zeros((cfg.num_samples,), np.float32)
        canonical = lambda state: state           # no mass in the pytree
        get_q = lambda st: st["q"][0]             # cold-replica moments
        ss_template = jnp.zeros((cfg.pt_replicas,), dtype)

    if cfg.sampler != "pt":
        def canonical(state):
            # restore templates need a fixed mass shape: always per-dim [D]
            mass = jnp.broadcast_to(
                jnp.asarray(state.ensemble.mass, dtype), (1, num_dims))[0]
            return state.replace(
                ensemble=state.ensemble.replace(mass=mass))

        get_q = lambda st: st.ensemble.q
        ss_template = jnp.zeros((), dtype)

    def empty_payload(state):
        return {
            # bump on any payload-structure change; restore rejects
            # mismatched checkpoints with a clear message instead of an
            # opaque structure error (the round-3 "tau" key broke
            # round-2 checkpoints silently)
            "schema": jnp.asarray(CHECKPOINT_SCHEMA, jnp.int32),
            "state": canonical(state),
            "step_size": ss_template,
            "tau": jnp.zeros((), dtype),
            "mean": jnp.zeros((num_dims,), dtype),
            "m2": jnp.zeros((num_dims,), dtype),
            "n": jnp.zeros((), dtype),
        }

    latest = mgr.latest_step()
    if latest is None:
        state, step_size, tau = warm(key)
        payload = dict(empty_payload(state),
                       step_size=step_size, tau=tau)
        done = 0
        resumed_from = None
    else:
        try:
            payload = mgr.restore(empty_payload(init_state(init_q)), latest)
        except Exception as e:
            raise RuntimeError(
                f"checkpoint at step {latest} in {cfg.checkpoint_dir} does "
                f"not match the current payload schema "
                f"(v{CHECKPOINT_SCHEMA}) — it was written by an older "
                f"revision or a different run config. Delete the directory "
                f"or point checkpoint_dir elsewhere to start fresh."
            ) from e
        if int(payload.get("schema", -1)) != CHECKPOINT_SCHEMA:
            raise RuntimeError(
                f"checkpoint schema v{int(payload.get('schema', -1))} in "
                f"{cfg.checkpoint_dir} != current v{CHECKPOINT_SCHEMA}; "
                f"delete the directory to start fresh")
        done = int(latest)
        resumed_from = done
        print(f"# resumed from checkpoint step {done} in "
              f"{cfg.checkpoint_dir}", file=sys.stderr)

    @jax.jit
    def chunk(state, chunk_key, step_size, tau, mean, m2, n, xs):
        def body(carry, kx):
            st, mean, m2, n = carry
            k, x = kx
            st, acc = tstep(k, st, step_size, tau, x)
            q = get_q(st)
            w = q.shape[0]
            n_new = n + w
            bm = jnp.mean(q, axis=0)
            delta = bm - mean
            mean = mean + delta * (w / n_new)
            m2 = m2 + jnp.sum((q - bm) ** 2, axis=0) \
                + delta**2 * (n * w / n_new)
            return (st, mean, m2, n_new), acc

        keys = jax.random.split(chunk_key, every)
        (state, mean, m2, n), acc = jax.lax.scan(
            body, (state, mean, m2, n), (keys, xs))
        return state, mean, m2, n, jnp.mean(acc)

    accs = []
    saves = 0
    while done < cfg.num_samples:
        # chunk keys derive from the chunk index, so a resumed run draws
        # exactly the chunks the interrupted run would have drawn
        ck = jax.random.fold_in(jax.random.fold_in(key, 7), done)
        xs = jnp.asarray(np.resize(xs_all[done:done + every], every),
                         dtype)
        state, mean, m2, n, acc = chunk(
            payload["state"], ck, payload["step_size"], payload["tau"],
            payload["mean"], payload["m2"], payload["n"], xs)
        done += every
        payload = {"schema": payload["schema"],
                   "state": canonical(state),
                   "step_size": payload["step_size"],
                   "tau": payload["tau"],
                   "mean": mean, "m2": m2, "n": n}
        mgr.save(done, payload)
        saves += 1
        accs.append(float(acc))

    var = payload["m2"] / jnp.maximum(payload["n"] - 1.0, 1.0)
    ss = np.asarray(payload["step_size"])
    return {
        "accept_rate": float(np.mean(accs)) if accs else None,
        "step_size": float(ss) if ss.ndim == 0 else ss.tolist(),
        "posterior_mean": np.asarray(payload["mean"]).tolist(),
        "posterior_var": np.asarray(var).tolist(),
        "samples_done": int(done),
        "resumed_from": resumed_from,
        "checkpoints_written": saves,
    }


def _checkpointed_smc_run(cfg: RunConfig, potential_fn, init_q, key,
                          constants) -> dict:
    """Fault-tolerant SMC: the annealing ladder is sequential and
    data-dependent (ESS-adaptive temperatures), so the natural recovery
    grain is the STAGE, not a fixed transition count. The stage body from
    smc.build_smc_machinery is jitted alone and driven host-side; the
    full stage carry (ensemble, weights, beta, evidence accumulator, RNG
    key, dual-averaging state) is checkpointed after every stage.
    Re-running the same config against the same ``checkpoint_dir``
    resumes at the last completed stage and — because the RNG key rides
    in the carry — reproduces the uninterrupted run's remaining stages
    exactly."""
    from .checkpoint import CheckpointManager
    from .smc import build_smc_machinery

    init_q = jnp.asarray(init_q)
    dtype = init_q.dtype
    m = build_smc_machinery(
        potential_fn, init_q.shape[0], dtype,
        num_mutation_steps=3, num_leapfrog_steps=cfg.num_steps,
        init_step_size=cfg.init_step_size, beta0=cfg.smc_beta0,
        max_stages=cfg.smc_max_stages, temperature=cfg.temperature,
        constants=constants, kernel=cfg.kernel)
    mgr = CheckpointManager(cfg.checkpoint_dir)
    stage_fn = jax.jit(m["body"])

    def payload_of(carry):
        return {"schema": jnp.asarray(CHECKPOINT_SCHEMA, jnp.int32),
                "carry": carry}

    carry0 = m["init_carry"](key, init_q)
    latest = mgr.latest_step()
    if latest is None:
        carry = carry0
        resumed_from = None
    else:
        try:
            payload = mgr.restore(payload_of(carry0), latest)
        except Exception as e:
            raise RuntimeError(
                f"SMC checkpoint at stage {latest} in "
                f"{cfg.checkpoint_dir} does not match the current payload "
                f"schema (v{CHECKPOINT_SCHEMA}) or run config; delete the "
                f"directory to start fresh.") from e
        if int(payload["schema"]) != CHECKPOINT_SCHEMA:
            raise RuntimeError(
                f"checkpoint schema v{int(payload['schema'])} != current "
                f"v{CHECKPOINT_SCHEMA}; delete {cfg.checkpoint_dir}")
        carry = payload["carry"]
        resumed_from = int(latest)
        print(f"# resumed SMC from stage {resumed_from} in "
              f"{cfg.checkpoint_dir}", file=sys.stderr)

    saves = 0
    # host-side stage loop (carry[2] = beta, carry[5] = stage index);
    # beta_max is run()'s fixed 1.0 target
    while float(carry[2]) < 1.0 and int(carry[5]) < cfg.smc_max_stages:
        carry = stage_fn(carry)
        mgr.save(int(carry[5]), payload_of(carry))
        saves += 1
    res = jax.jit(m["finalize"])(carry)
    q = np.asarray(res.q)
    return {
        "log_evidence": float(res.log_evidence),
        "num_stages": int(res.num_stages),
        "final_step_size": float(res.final_step_size),
        "posterior_mean": q.mean(0).tolist(),
        "posterior_var": q.var(0, ddof=1).tolist(),
        "resumed_from": resumed_from,
        "checkpoints_written": saves,
    }


def _stream_run(cfg: RunConfig, potential_fn, init_q, key, constants) -> dict:
    """Warmup-adapt, then sample in thinned chunks appended to a
    native SampleSink (one device->host transfer per recorded draw)."""
    from .hmc import build_hmc_kernel, run_hmc
    from .native import SampleSink, read_samples

    key, k_warm = jax.random.split(key)
    warm = run_hmc(
        k_warm, potential_fn, init_q,
        num_warmup=cfg.num_warmup, num_samples=0, num_steps=cfg.num_steps,
        init_step_size=cfg.init_step_size, target_accept=cfg.target_accept,
        adapt_mass=cfg.adapt_mass, temperature=cfg.temperature,
        constants=constants, collect="none")
    kernel = build_hmc_kernel(
        potential_fn, num_steps=cfg.num_steps,
        temperature=cfg.temperature, constants=constants)
    state, step_size = warm.state, warm.step_size
    thin = max(cfg.thin, 1)

    @jax.jit
    def chunk(state, keys):
        def body(st, k):
            st, info = kernel.step(k, st, step_size)
            return st, jnp.mean(info.accept_prob)
        state, acc = jax.lax.scan(body, state, keys)
        return state, state.ensemble.q, jnp.mean(acc)

    w, d = init_q.shape
    accs = []
    with SampleSink(cfg.output_path, w, d) as sink:
        for i in range(cfg.num_samples):
            key, k_chunk = jax.random.split(key)
            state, q, acc = chunk(state, jax.random.split(k_chunk, thin))
            sink.append(np.asarray(q))
            accs.append(float(acc))
    data = read_samples(cfg.output_path)
    return {
        "accept_rate": float(np.mean(accs)),
        "step_size": float(step_size),
        "streamed_rows": int(data.shape[0]),
        "posterior_mean": np.asarray(data).mean(0).tolist(),
        "posterior_sd": np.asarray(data).std(0).tolist(),
    }


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="physicsbasedbayesianinference_tpu",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", help="JSON RunConfig file")
    for f in dataclasses.fields(RunConfig):
        flag = "--" + f.name.replace("_", "-")
        if f.type == "bool" or isinstance(f.default, bool):
            p.add_argument(flag, type=lambda s: s.lower() in ("1", "true"),
                           default=None)
        elif f.name in ("data_path", "checkpoint_dir", "output_path"):
            p.add_argument(flag, type=str, default=None)
        elif isinstance(f.default, int):
            p.add_argument(flag, type=int, default=None)
        elif isinstance(f.default, float):
            p.add_argument(flag, type=float, default=None)
        else:
            p.add_argument(flag, type=str, default=None)
    return p


def main(argv=None) -> int:
    from .utils.compile_cache import enable_compile_cache
    args = _build_parser().parse_args(argv)
    enable_compile_cache()
    cfg = RunConfig.from_file(args.config) if args.config else RunConfig()
    for f in dataclasses.fields(RunConfig):
        v = getattr(args, f.name, None)
        if v is not None:
            setattr(cfg, f.name, v)
    summary = run(cfg)
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
