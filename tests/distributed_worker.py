"""Worker for the 2-process ``jax.distributed`` integration test.

Launched twice (process_id 0 and 1) by
``tests/test_parallel.py::test_two_process_distributed_hmc``. Each process
owns 4 virtual CPU devices; after ``initialize_distributed`` the global
device count is 8 and the SAME mesh/GSPMD sampler code the single-process
tests exercise runs across the process boundary — the runtime the
reference only planned as an MPI stack (reference manuals/SetUp.md:82-200:
MVAPICH2 + mpi4py + mpi4jax + hostfile) collapses to one initialize call.

Prints one JSON line with cross-process-reduced scalars; the parent
asserts both workers agree and match a single-process reference.
"""

import json
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main() -> None:
    port, pid = sys.argv[1], int(sys.argv[2])
    mode = sys.argv[3] if len(sys.argv) > 3 else "basic"
    ckpt_dir = sys.argv[4] if len(sys.argv) > 4 else None

    # jax.distributed.initialize must run before anything touches the XLA
    # backend, and importing the package initialises it — so load
    # parallel/distributed.py standalone (it imports only jax).
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_dist", os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "physicsbasedbayesianinference_tpu", "parallel",
            "distributed.py"))
    dist = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(dist)

    info = dist.initialize_distributed(
        coordinator_address=f"localhost:{port}",
        num_processes=2, process_id=pid)

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import physicsbasedbayesianinference_tpu as pbbi
    from physicsbasedbayesianinference_tpu.ops import potentials as pot

    mesh = Mesh(np.array(jax.devices()), ("walkers",))
    w, d = 64, 4
    sharding = NamedSharding(mesh, P("walkers", None))

    if mode in ("fused_ckpt_run", "fused_ckpt_resume"):
        _fused_ckpt(info, mesh, sharding, mode, ckpt_dir)
        return

    # deterministic global data; each process materialises only its
    # addressable shards
    base = np.arange(w * d, dtype=np.float32).reshape(w, d) / (w * d)
    x = jax.make_array_from_callback((w, d), sharding,
                                     lambda idx: base[idx])
    # cross-process all-reduce through GSPMD (the psum the collective
    # census counts rides the process boundary here)
    total = float(jax.jit(jnp.sum)(x))

    # one sharded HMC transition across both processes
    qnp = np.asarray(
        jax.random.normal(jax.random.key(3), (w, d), jnp.float32))
    q0 = jax.make_array_from_callback((w, d), sharding,
                                      lambda idx: qnp[idx])
    kernel = pbbi.build_hmc_kernel(pot.make_standard_normal(d),
                                   num_steps=4)
    state = kernel.init(q0)
    st, step_info = jax.jit(
        lambda k, s: kernel.step(k, s, jnp.float32(0.5)))(
        jax.random.key(0), state)
    print(json.dumps({
        "process_index": info["process_index"],
        "process_count": info["process_count"],
        "global_devices": info["global_devices"],
        "local_devices": info["local_devices"],
        "sum": total,
        "accept": float(jnp.mean(step_info.accept_prob)),
        "mean_q": float(jnp.mean(st.ensemble.q)),
        "mean_u": float(jnp.mean(st.potential_energy)),
    }))


def _fused_ckpt(info, mesh, sharding, mode, ckpt_dir):
    """Full multi-host recovery story in one flow: the shard_map
    composition of the XLA kernel runs 10 transitions across 2
    processes, checkpointing the sharded sampler state at transition 5
    (each process writes its own shards); the ``resume`` phase is a FRESH
    2-process cluster that restores the checkpoint and replays
    transitions 5..9. The parent asserts the resumed moments equal the
    uninterrupted run's bit-for-bit."""
    import json

    import numpy as np
    import jax
    import jax.numpy as jnp

    import physicsbasedbayesianinference_tpu as pbbi
    from physicsbasedbayesianinference_tpu.checkpoint import (
        CheckpointManager)
    from physicsbasedbayesianinference_tpu.ops import potentials as pot
    from physicsbasedbayesianinference_tpu.parallel.sharded import (
        shard_map_kernel)

    d = 4
    w = 64
    kernel = shard_map_kernel(
        pbbi.build_hmc_kernel(pot.make_standard_normal(d), num_steps=4),
        mesh)
    qnp = np.asarray(
        jax.random.normal(jax.random.key(11), (w, d), jnp.float32))
    q0 = jax.make_array_from_callback((w, d), sharding,
                                      lambda idx: qnp[idx])
    state = kernel.init(q0)
    eps = jnp.float32(0.45)
    mgr = CheckpointManager(ckpt_dir, max_to_keep=1)

    start = 0
    if mode == "fused_ckpt_resume":
        state = mgr.restore(state)
        start = 5
    for i in range(start, 10):
        state, _ = kernel.step(jax.random.key(100 + i), state, eps)
        if i == 4 and mode == "fused_ckpt_run":
            mgr.save(5, state)

    q = state.ensemble.q
    print(json.dumps({
        "process_index": info["process_index"],
        "process_count": info["process_count"],
        "global_devices": info["global_devices"],
        "local_devices": info["local_devices"],
        "kernel_kind": kernel.kind,
        "mean_q": float(jnp.mean(q)),
        "mean_q2": float(jnp.mean(q * q)),
        "mean_u": float(jnp.mean(state.potential_energy)),
    }))


if __name__ == "__main__":
    main()
