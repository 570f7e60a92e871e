"""Integrator-zoo runtime comparison on the shipped N-body ICs.

The reference's actual benchmark ritual: ``NBody.py`` times each
integrator with ``time.time()`` and prints runtimes next to energy-drift
plots (reference samples/NBody/NBody.py:60-64,106-108,118-120 — SV vs
adaptive-SV vs Hermite), but records nothing (SURVEY.md §6). This harness
runs the zoo on the committed ``examples/nbody/pl100.txt`` /
``pl1k.txt`` Plummer spheres and WRITES the numbers:

  * fixed-dt schemes (the file's own dt over its tmax): wall seconds for
    the whole jitted trajectory scan, steps/s, |relative energy drift|;
  * adaptive-dt drivers (simple + advanced criteria; Störmer-Verlet and
    Hermite — reference IntegrateSVA/IntegrateHIA): wall seconds, steps
    actually taken, drift.

Where the reference integrates one Python step per loop iteration, here
the WHOLE trajectory is one ``lax.scan`` (physics/simulate.py) — the
wall-clock includes one compile-excluded timed run, synced by scalar
readback.

Usage:  python benchmarks/nbody_zoo.py [pl100 pl1k ...]
Output: one JSON line per (file, scheme); summary JSON last line.
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

FIXED_SCHEMES = ("stormer_verlet", "velocity_verlet", "hermite", "rk4",
                 "symplectic_euler")
ADAPTIVE = (("stormer_verlet", "simple"), ("stormer_verlet", "advanced"),
            ("hermite", "advanced"))


def drift(traj) -> float:
    e0 = float(traj.initial_energy)
    n = int(traj.num_valid)
    e = jnp.asarray(traj.energy)[:n]
    return float(jnp.max(jnp.abs((e - e0) / e0)))


def bench_file(name: str, softening: float) -> list:
    from physicsbasedbayesianinference_tpu.physics import (
        center_of_mass_frame, load_nbody_text, simulate,
        simulate_adaptive)

    path = os.path.join(REPO, "examples", "nbody", f"{name}.txt")
    system, tmax, dt = load_nbody_text(path)
    system = center_of_mass_frame(system)
    # every scheme integrates the SAME physical window (default one time
    # unit ~ a crossing time — the file's full tmax needs ~5e5 adaptive
    # steps on the Plummer spheres; BENCH_NBODY_T overrides)
    t_target = min(tmax, float(os.environ.get("BENCH_NBODY_T", "1.0")))
    num_steps = max(1, int(round(t_target / dt)))
    save_every = max(1, num_steps // 100)
    num_steps = (num_steps // save_every) * save_every
    adaptive_cap = int(os.environ.get("BENCH_NBODY_CAP",
                                      str(100 * num_steps + 16)))
    rows = []

    for method in FIXED_SCHEMES:
        def run():
            return simulate(system, dt, num_steps, method=method,
                            save_every=save_every, softening=softening)
        traj = run()
        float(traj.final.x[0, 0])          # compile + sync
        t0 = time.time()
        traj = run()
        float(traj.final.x[0, 0])
        wall = time.time() - t0
        rows.append({
            "file": name, "scheme": method, "kind": "fixed",
            "num_steps": num_steps, "dt": dt,
            "wall_seconds": round(wall, 4),
            "steps_per_sec": round(num_steps / wall),
            "max_rel_energy_drift": drift(traj),
        })
        print(json.dumps(rows[-1]), flush=True)

    for method, criterion in ADAPTIVE:
        def run():
            return simulate_adaptive(
                system, dt, t_target, method=method, criterion=criterion,
                max_steps=adaptive_cap, softening=softening)
        traj = run()
        float(traj.final.x[0, 0])
        t0 = time.time()
        traj = run()
        float(traj.final.x[0, 0])
        wall = time.time() - t0
        taken = int(traj.num_valid)
        t_final = float(traj.final.time)
        rows.append({
            "file": name, "scheme": f"{method}+adaptive_{criterion}",
            "kind": "adaptive", "num_steps": taken, "dt0": dt,
            "wall_seconds": round(wall, 4),
            "steps_per_sec": round(taken / wall) if wall > 0 else None,
            "max_rel_energy_drift": drift(traj),
            "t_final": t_final, "t_target": t_target,
            # close encounters can drive dt -> 0; a capped run reports
            # how far it got instead of pretending it finished
            "hit_step_cap": taken >= adaptive_cap,
        })
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main() -> None:
    files = sys.argv[1:] or ["pl100", "pl1k"]
    all_rows = []
    for name in files:
        # Plummer spheres have close encounters; the reference legacy
        # code NaN-masks zero distances (MiscFunctions.py:65-67); a Plummer-scale
        # softening (5% of unit radius) is the standard honest equivalent.
        all_rows += bench_file(name, softening=0.05)
    print(json.dumps({
        "summary": {
            "device": str(jax.devices()[0]),
            "x64": True,
            "rows": len(all_rows),
        }
    }))


if __name__ == "__main__":
    main()
