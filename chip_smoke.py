"""Bring-up check on one GPU: drive the engine's main path at full width.

    python chip_smoke.py            # phases 1-5 on one card
    python chip_smoke.py --four     # only the four-card walker-mesh path
    python chip_smoke.py --sweep    # only the fused kernel's block sweep

Phases (each a function the CPU tests call at tiny sizes):

1. device: JAX must report a GPU; the card's name and power limit come
   from ``nvidia-smi`` in a child process that stays off JAX.
2. headline ``run_hmc``: 102,400 walkers x 32 dims, 16 leapfrog steps,
   200 warmup + 200 sampling transitions, streaming moments checked
   against the analytic N(0, I).
3. the CLI in-process (``main.main``): NUTS on non-centred eight-schools.
4. ChEES on ``logreg_32_n256`` at 102,400 walkers, default matmul
   precision against ``"highest"``.
5. the fused Triton transition against the XLA step: agreement at
   ``"highest"`` precision and the time of each engine; then the tests
   marked ``gpu`` (``pytest -m gpu``), in this process.

Any failed phase makes the exit code non-zero. The last stdout line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``
and is printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

NUM_WALKERS = 102_400
NUM_DIMS = 32
NUM_STEPS = 16
# Phase 2: |mean| and |var - 1| bounds. With 102,400 walkers x 200
# transitions the Monte Carlo standard error of each moment is ~3e-4, so
# these are ~60-100 standard errors: a pass means the sampler is right,
# not lucky, and a biased integrator or a stuck chain fails.
MEAN_TOL = 0.02
VAR_TOL = 0.03
# Phase 4: default-precision posterior vs the "highest" one, in posterior
# standard deviations (mean) and relative terms (variance). Both runs are
# ~1e6 effective draws, so their Monte Carlo gap is ~2e-3 sd.
PREC_MEAN_TOL_SD = 0.05
PREC_VAR_TOL = 0.05
# Phase 5: fused vs XLA at "highest". Float32 reduction order differs, so
# positions and energies agree to rtol 1e-4, and an accept decision whose
# log-uniform sits within rounding of the energy error may flip.
FUSED_RTOL = 1e-4
FUSED_MAX_FLIPS = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_name_and_power() -> str:
    """``nvidia-smi``'s name and power limit, read by a child process."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def device_record() -> dict:
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def phase_device(require_gpu: bool = True) -> dict:
    dev = device_record()
    if require_gpu and dev["platform"] != "gpu":
        raise RuntimeError(f"no GPU: JAX reports {dev['platform']!r}")
    return dev


def phase_headline(num_walkers: int = NUM_WALKERS, num_dims: int = NUM_DIMS,
                   num_warmup: int = 200, num_samples: int = 200) -> dict:
    """``run_hmc`` on N(0, I) from a displaced start; moments checked."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from physicsbasedbayesianinference_tpu import hmc
    from physicsbasedbayesianinference_tpu.ops.potentials import (
        make_standard_normal)

    target = make_standard_normal(num_dims)
    q0 = 2.0 + 0.1 * jax.random.normal(jax.random.key(0),
                                       (num_walkers, num_dims), jnp.float32)
    # the first call compiles (its sampling_seconds include compiling the
    # sampling scan); the second reuses every compiled program
    first, res = _twice(lambda: hmc.run_hmc(
        jax.random.key(1), target, q0, num_warmup=num_warmup,
        num_samples=num_samples, num_steps=NUM_STEPS, collect="moments"))
    mean, var = np.asarray(res.mean), np.asarray(res.var)

    # the sampling scan's memory, as compiled for this device
    kernel = hmc.build_hmc_kernel(target, num_steps=NUM_STEPS)
    zeros = jnp.zeros((num_dims,), jnp.float32)
    compiled = hmc._sample_scan_for(kernel, "moments").lower(
        res.state, jax.random.split(jax.random.key(2), num_samples),
        res.step_size, zeros, zeros, jnp.zeros((), jnp.float32)).compile()
    mem = compiled.memory_analysis()
    mem_fields = {k: getattr(mem, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if mem is not None and hasattr(mem, k)}
    out = {
        "kernel_used": res.kernel_used,
        "sampling_seconds": res.sampling_seconds,
        "walker_transitions_per_sec":
            num_samples * num_walkers / res.sampling_seconds,
        "first_call": first,
        "accept_rate": float(res.accept_rate),
        "step_size": float(res.step_size),
        "max_abs_mean": float(np.max(np.abs(mean))),
        "max_abs_var_minus_1": float(np.max(np.abs(var - 1.0))),
        "tolerance": {"mean": MEAN_TOL, "var": VAR_TOL},
        "sampling_scan_memory": mem_fields,
    }
    out["ok"] = bool(out["max_abs_mean"] < MEAN_TOL
                     and out["max_abs_var_minus_1"] < VAR_TOL
                     and np.all(np.isfinite(mean))
                     and out["kernel_used"] == "xla")
    return out


def _twice(run):
    """Run ``run()`` twice; -> (first call's seconds, second result)."""
    t0 = time.perf_counter()
    res = run()
    first = {"wall_seconds": time.perf_counter() - t0,
             "sampling_seconds": res.sampling_seconds}
    return first, run()


def phase_cli(num_walkers: int = 4096, extra_args=()) -> dict:
    """The README's CLI run, in-process: NUTS on eight-schools."""
    from physicsbasedbayesianinference_tpu.main import main

    argv = ["--model", "example:eight_schools_noncentered",
            "--data-path",
            os.path.join(REPO, "examples", "eight_schools.data.json"),
            "--sampler", "nuts", "--num-walkers", str(num_walkers),
            "--kernel", "auto", *extra_args]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    summary = json.loads(buf.getvalue())
    out = {
        "rc": rc,
        "max_rhat": summary["max_rhat"],
        "min_ess": summary["min_ess"],
        "accept_rate": summary["accept_rate"],
        "kernel_used": summary["kernel_used"],
        "constrained_means": {k: summary["constrained_means"][k]
                              for k in ("mu", "tau")},
        "wall_seconds": summary["wall_seconds"],
    }
    out["ok"] = bool(rc == 0 and summary["max_rhat"] < 1.05
                     and summary["kernel_used"] == "xla")
    return out


def phase_chees_logreg(num_walkers: int = NUM_WALKERS, num_warmup: int = 300,
                       num_samples: int = 200) -> dict:
    """ChEES on logreg_32_n256 at default and at "highest" precision."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from physicsbasedbayesianinference_tpu.chees import run_chees_hmc
    from physicsbasedbayesianinference_tpu.models.examples import (
        logistic_regression, synthetic_logreg_data)
    from physicsbasedbayesianinference_tpu.models.potential import (
        make_model_potential)

    mp = make_model_potential(logistic_regression, synthetic_logreg_data(),
                              {})
    q0 = 0.1 * jax.random.normal(jax.random.key(3),
                                 (num_walkers, mp.num_dims), jnp.float32)
    runs = {}
    for prec in ("highest", "default"):
        with jax.default_matmul_precision(prec):
            t0 = time.perf_counter()
            res = run_chees_hmc(
                jax.random.key(4), mp.potential, q0, num_warmup=num_warmup,
                num_samples=num_samples, init_step_size=0.05,
                max_steps=256, collect="moments")
            mean = np.asarray(res.mean)
            runs[prec] = {
                "mean": mean, "var": np.asarray(res.var),
                "accept_rate": float(res.accept_rate),
                "mean_num_steps": float(res.mean_num_steps),
                "step_size": float(res.step_size),
                "wall_seconds": time.perf_counter() - t0,
                "kernel_used": res.kernel_used,
            }
    hi, lo = runs["highest"], runs["default"]
    sd = np.sqrt(hi["var"])
    mean_gap_sd = float(np.max(np.abs(lo["mean"] - hi["mean"]) / sd))
    var_gap = float(np.max(np.abs(lo["var"] / hi["var"] - 1.0)))
    out = {
        "default_vs_highest_max_mean_gap_sd": mean_gap_sd,
        "default_vs_highest_max_rel_var_gap": var_gap,
        "tolerance": {"mean_sd": PREC_MEAN_TOL_SD, "rel_var": PREC_VAR_TOL},
        "posterior_sd_range": [float(sd.min()), float(sd.max())],
    }
    for prec, r in runs.items():
        out[prec] = {k: v for k, v in r.items() if k not in ("mean", "var")}
    finite = all(np.all(np.isfinite(r["mean"])) for r in runs.values())
    out["ok"] = bool(finite and mean_gap_sd < PREC_MEAN_TOL_SD
                     and var_gap < PREC_VAR_TOL
                     and 0.5 < hi["accept_rate"] <= 1.0)
    return out


def _kernel_targets(num_walkers: int, num_dims: int):
    """(name, potential, step size, init) for the engine comparison."""
    import jax
    import jax.numpy as jnp

    from physicsbasedbayesianinference_tpu.models.examples import (
        synthetic_logreg_data)
    from physicsbasedbayesianinference_tpu.ops.potentials import (
        make_logistic_regression, make_standard_normal)

    q_std = jax.random.normal(jax.random.key(5), (num_walkers, num_dims),
                              jnp.float32)
    x, labels = synthetic_logreg_data(num_features=num_dims - 1)
    return [
        ("std_normal", make_standard_normal(num_dims), 0.6, q_std),
        ("logreg", make_logistic_regression(x, labels), 0.05, 0.1 * q_std),
    ]


def _engines(pot, num_dims, interpret, block=None):
    """(XLA kernel, fused kernel); ``block = (walkers, warps)`` builds the
    fused one with another block than the module's measured choice."""
    from physicsbasedbayesianinference_tpu import hmc
    from physicsbasedbayesianinference_tpu.ops import fused_hmc

    xla = hmc.build_hmc_kernel(pot, num_steps=NUM_STEPS)
    saved = fused_hmc.BLOCK_WALKERS, fused_hmc.NUM_WARPS
    if block is not None:
        fused_hmc.BLOCK_WALKERS, fused_hmc.NUM_WARPS = block
    try:
        fused = hmc.build_fused_hmc_kernel(
            pot, num_steps=NUM_STEPS, num_dims=num_dims, interpret=interpret)
    finally:
        fused_hmc.BLOCK_WALKERS, fused_hmc.NUM_WARPS = saved
    return xla, fused


def _scan(kernel, step_size):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(state, keys):
        def body(st, k):
            st, info = kernel.step(k, st, jnp.float32(step_size))
            return st, (info.accepted, jnp.mean(info.accept_prob))
        return jax.lax.scan(body, state, keys)
    return run


def compare_engines(num_walkers: int = NUM_WALKERS, num_dims: int = NUM_DIMS,
                    num_transitions: int = 16,
                    interpret: bool = False) -> dict:
    """Fused vs XLA from identical states and keys at "highest"."""
    import jax
    import numpy as np

    out = {}
    for name, pot, eps, q0 in _kernel_targets(num_walkers, num_dims):
        with jax.default_matmul_precision("highest"):
            xla, fused = _engines(pot, num_dims, interpret)
            state = xla.init(q0)
            keys = jax.random.split(jax.random.key(6), num_transitions)
            row = {}
            for n in (1, num_transitions):
                (sx, (ax, _)), (sf, (af, _)) = (
                    _scan(k, eps)(state, keys[:n]) for k in (xla, fused))
                ax, af = np.asarray(ax), np.asarray(af)
                agree = np.all(ax == af, axis=0)          # [W]
                qx, qf = np.asarray(sx.ensemble.q), np.asarray(sf.ensemble.q)
                ux = np.asarray(sx.potential_energy)
                uf = np.asarray(sf.potential_energy)
                q_rel = float(np.max(np.abs(qf - qx)[agree])
                              / np.max(np.abs(qx[agree])))
                u_rel = float(np.max(np.abs(uf - ux)[agree]
                                     / np.abs(ux[agree])))
                row[f"after_{n}"] = {
                    "max_rel_q": q_rel, "max_rel_u": u_rel,
                    "walkers_with_a_flipped_decision":
                        float(1.0 - np.mean(agree)),
                    "accept_rate_xla": float(np.mean(ax)),
                    "accept_rate_fused": float(np.mean(af)),
                }
            last = row[f"after_{num_transitions}"]
            row["ok"] = bool(
                all(r["max_rel_q"] < FUSED_RTOL and r["max_rel_u"] < FUSED_RTOL
                    and r["walkers_with_a_flipped_decision"] < FUSED_MAX_FLIPS
                    for k, r in row.items() if k.startswith("after_"))
                and np.isfinite(last["max_rel_q"]))
            out[name] = row
    out["tolerance"] = {"rtol": FUSED_RTOL, "max_flips": FUSED_MAX_FLIPS}
    out["ok"] = all(v["ok"] for k, v in out.items() if k != "tolerance")
    return out


def time_engines(num_walkers: int = NUM_WALKERS, num_dims: int = NUM_DIMS,
                 num_transitions: int = 256, interpret: bool = False,
                 block=None) -> dict:
    """Seconds per 256-transition scan of each engine at default
    precision, in the order xla, fused, fused, xla."""
    import jax

    out = {}
    for name, pot, eps, q0 in _kernel_targets(num_walkers, num_dims):
        xla, fused = _engines(pot, num_dims, interpret, block)
        state = xla.init(q0)
        keys = jax.random.split(jax.random.key(7), num_transitions)
        runs = {"xla": _scan(xla, eps), "fused": _scan(fused, eps)}
        compile_s = {}
        for tag, run in runs.items():            # compile + warm
            t0 = time.perf_counter()
            jax.block_until_ready(run(state, keys))
            compile_s[tag] = time.perf_counter() - t0
        times = {"xla": [], "fused": []}
        for tag in ("xla", "fused", "fused", "xla"):
            t0 = time.perf_counter()
            jax.block_until_ready(runs[tag](state, keys))
            times[tag].append(time.perf_counter() - t0)
        best = {k: min(v) for k, v in times.items()}
        out[name] = {
            "seconds_per_scan": times,
            "first_call_seconds": compile_s,
            "ms_per_transition": {k: 1e3 * v / num_transitions
                                  for k, v in best.items()},
            "walker_transitions_per_sec": {
                k: num_walkers * num_transitions / v for k, v in best.items()},
            "fused_speedup": best["xla"] / best["fused"],
        }
    return out


def phase_kernel(num_walkers: int = NUM_WALKERS, num_dims: int = NUM_DIMS,
                 interpret: bool = False, num_transitions: int = 256) -> dict:
    check = compare_engines(num_walkers, num_dims, interpret=interpret)
    timing = time_engines(num_walkers, num_dims, interpret=interpret,
                          num_transitions=num_transitions)
    faster = all(t["fused_speedup"] > 1.0 for t in timing.values())
    return {"agreement": check, "timing": timing,
            "fused_faster_at_every_shape": faster, "ok": check["ok"]}


SWEEP_BLOCKS = ((16, 1), (16, 2), (32, 1), (32, 2), (32, 4), (64, 2),
                (64, 4), (128, 4), (128, 8), (256, 8))


def phase_gpu_tests() -> dict:
    """The repository's tests marked ``gpu``, in this process (a second
    JAX process could not get the card's memory)."""
    import pytest

    os.environ["PBBI_TEST_BACKEND"] = "gpu"
    rc = int(pytest.main(["-q", "-rs", "-m", "gpu", "-p", "no:cacheprovider",
                          os.path.join(REPO, "tests")]))
    return {"pytest_exit_code": rc, "ok": rc == 0}


def phase_sweep(num_walkers: int = NUM_WALKERS, num_dims: int = NUM_DIMS,
                interpret: bool = False, num_transitions: int = 64,
                blocks=SWEEP_BLOCKS) -> dict:
    """The fused kernel's walkers-per-program and warps, by measurement."""
    rows = []
    for bw, warps in blocks:
        try:
            t = time_engines(num_walkers, num_dims, interpret=interpret,
                             num_transitions=num_transitions,
                             block=(bw, warps))
            rows.append({"block_walkers": bw, "num_warps": warps,
                         **{k: v["ms_per_transition"]
                            for k, v in t.items()}})
        except Exception as e:  # a block the card refuses is a finding
            rows.append({"block_walkers": bw, "num_warps": warps,
                         "error": repr(e)[-400:]})
    return {"rows": rows, "ok": True}


def phase_four(walkers_per_device: int = NUM_WALKERS,
               num_dims: int = NUM_DIMS, num_warmup: int = 200,
               num_samples: int = 200, num_devices: int = 4) -> dict:
    """Walker-sharded HMC on a 4-device mesh: GSPMD (``sharded_run_hmc``)
    and shard_map (``build_sharded_hmc_step``), each against the analytic
    moments and a one-device run of the same ensemble."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from physicsbasedbayesianinference_tpu import hmc
    from physicsbasedbayesianinference_tpu.ops.potentials import (
        make_standard_normal)
    from physicsbasedbayesianinference_tpu.parallel import (
        build_sharded_hmc_step, make_walker_mesh, sharded_run_hmc)

    devices = jax.devices()
    if len(devices) < num_devices:
        raise RuntimeError(f"need {num_devices} devices, have {len(devices)}")
    mesh = make_walker_mesh(devices[:num_devices])
    w = walkers_per_device * num_devices
    target = make_standard_normal(num_dims)
    q0 = 2.0 + 0.1 * jax.random.normal(jax.random.key(0), (w, num_dims),
                                       jnp.float32)
    kw = dict(num_warmup=num_warmup, num_samples=num_samples,
              num_steps=NUM_STEPS, collect="moments")

    def moments(mean, var, seconds, accept):
        mean, var = np.asarray(mean), np.asarray(var)
        return {"max_abs_mean": float(np.max(np.abs(mean))),
                "max_abs_var_minus_1": float(np.max(np.abs(var - 1.0))),
                "sampling_seconds": seconds,
                "walker_transitions_per_sec": num_samples * w / seconds,
                "accept_rate": float(accept), "_mean": mean, "_var": var}

    _, one = _twice(lambda: hmc.run_hmc(
        jax.random.key(1), target, jax.device_put(q0, devices[0]), **kw))
    rows = {"one_device": moments(one.mean, one.var, one.sampling_seconds,
                                  one.accept_rate)}
    _, gspmd = _twice(lambda: sharded_run_hmc(
        jax.random.key(1), target, q0, mesh=mesh, **kw))
    rows["gspmd"] = moments(gspmd.mean, gspmd.var, gspmd.sampling_seconds,
                            gspmd.accept_rate)

    # shard_map: continue from the GSPMD-warmed state with its adapted
    # step size and metric, one jitted scan of shard_map'd transitions
    kernel = hmc.build_hmc_kernel(target, num_steps=NUM_STEPS)
    state = gspmd.state
    step = build_sharded_hmc_step(kernel, mesh, state)
    eps = gspmd.step_size

    @jax.jit
    def run(state, keys):
        def body(carry, k):
            st, s1, s2 = carry
            st, _, stats = step.inner(k, st, eps)
            q = st.ensemble.q
            return (st, s1 + jnp.mean(q, 0), s2 + jnp.mean(q * q, 0)), \
                stats["accept_rate"]
        z = jnp.zeros((num_dims,), jnp.float32)
        (st, s1, s2), acc = jax.lax.scan(body, (state, z, z), keys)
        n = keys.shape[0]
        return st, s1 / n, s2 / n - (s1 / n) ** 2, jnp.mean(acc)

    keys = jax.random.split(jax.random.key(2), num_samples)
    jax.block_until_ready(run(state, keys))
    t0 = time.perf_counter()
    _, m, v, acc = jax.block_until_ready(run(state, keys))
    rows["shard_map"] = moments(m, v, time.perf_counter() - t0, acc)

    ok = True
    for name, r in rows.items():
        ok &= (r["max_abs_mean"] < MEAN_TOL
               and r["max_abs_var_minus_1"] < VAR_TOL)
        if name != "one_device":
            r["max_gap_to_one_device_mean"] = float(np.max(np.abs(
                r["_mean"] - rows["one_device"]["_mean"])))
            r["max_gap_to_one_device_var"] = float(np.max(np.abs(
                r["_var"] - rows["one_device"]["_var"])))
            # per-device rate on the mesh over one device's rate
            r["per_device_efficiency"] = (
                r["walker_transitions_per_sec"] / num_devices
                / rows["one_device"]["walker_transitions_per_sec"])
            ok &= (r["max_gap_to_one_device_mean"] < MEAN_TOL
                   and r["max_gap_to_one_device_var"] < VAR_TOL)
    for r in rows.values():
        del r["_mean"], r["_var"]
    rows["walkers"] = w
    rows["mesh_devices"] = num_devices
    rows["ok"] = bool(ok)
    return rows


def _run(name, fn, results) -> bool:
    t0 = time.perf_counter()
    try:
        res = fn()
    except Exception as e:  # report and go on; the exit code carries it
        import traceback
        traceback.print_exc()
        res = {"ok": False, "error": repr(e)[-2000:]}
    res["phase_seconds"] = time.perf_counter() - t0
    results[name] = res
    log(f"phase {name}: {json.dumps(res, default=float)}")
    return bool(res.get("ok"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card walker-mesh path")
    ap.add_argument("--sweep", action="store_true",
                    help="run only the fused kernel's block sweep")
    args = ap.parse_args(argv)

    import jax
    try:
        dev = phase_device()
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    from physicsbasedbayesianinference_tpu.utils.compile_cache import (
        enable_compile_cache)
    log(f"compile cache: {enable_compile_cache()}")
    log(f"jax {jax.__version__}; device {dev}")
    log(f"nvidia-smi: {card_name_and_power()}")

    results: dict = {}
    if args.four:
        phases = [("four", phase_four)]
    elif args.sweep:
        phases = [("sweep", phase_sweep)]
    else:
        phases = [("headline", phase_headline), ("cli", phase_cli),
                  ("chees_logreg", phase_chees_logreg),
                  ("kernel", phase_kernel), ("gpu_tests", phase_gpu_tests)]
    ok = all([_run(name, fn, results) for name, fn in phases])
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"device": dev, "card": card_name_and_power(),
                   "phases": results}, f, indent=1, default=float)
    log(f"nvidia-smi: {card_name_and_power()}")
    if not ok:
        failed = [k for k, v in results.items() if not v.get("ok")]
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device_record()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
