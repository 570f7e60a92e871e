"""Multi-host runtime initialisation.

The reference's multi-node story was a hand-built MPI stack (MVAPICH2 from
source + mpi4py + mpi4jax, reference manuals/SetUp.md:82-200, never wired
into the sampler). Here the runtime is one call:
``jax.distributed.initialize()`` on every process, after which
``jax.devices()`` spans the whole cluster and the same mesh/shard_map code
runs unchanged — XLA hands the collectives to NCCL.
"""

from __future__ import annotations

from typing import Optional

import jax


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> dict:
    """Initialise the multi-host JAX runtime (idempotent, no-op on 1 host).

    Under a cluster launcher that JAX recognises (e.g. SLURM) all
    arguments are auto-detected from the environment; otherwise pass the
    coordinator address (``host:port``), process count and id. Returns a
    summary dict for logging.
    """
    explicit = coordinator_address is not None or (
        num_processes is not None and num_processes > 1)
    if explicit:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    else:
        # Auto-detect a cluster from the environment; a single host with
        # no cluster environment falls through to a no-op.
        try:
            jax.distributed.initialize()
        except (ValueError, RuntimeError):
            pass
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
