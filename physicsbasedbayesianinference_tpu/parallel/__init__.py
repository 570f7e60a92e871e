"""Walker-axis parallelism over device meshes.

The reference planned multi-node parallelism via MPI (MVAPICH2 + mpi4py +
mpi4jax, reference manuals/SetUp.md:82-200) but never implemented it
(SURVEY.md §2 parallelism audit). The replacement is: one ``walkers`` mesh
axis spanning all devices (NVLink between the cards of a host, the
network across hosts), ensemble state sharded ``P('walkers', None)``, and
ensemble statistics reduced with XLA collectives (``psum``/``pmean``) — no
user-visible communication backend at all.
"""

from .mesh import (
    make_walker_mesh,
    walker_sharding,
    replicated_sharding,
    shard_ensemble,
)
from .sharded import build_sharded_hmc_step, shard_map_kernel, sharded_run_hmc
from .distributed import initialize_distributed
from .ring import (
    BODY_AXIS,
    make_body_mesh,
    pad_bodies,
    ring_nbody_accelerations,
    ring_nbody_potential_energy,
    ring_simulate,
)
from .resample import ring_systematic_resample

__all__ = [
    "make_walker_mesh",
    "walker_sharding",
    "replicated_sharding",
    "shard_ensemble",
    "build_sharded_hmc_step",
    "shard_map_kernel",
    "sharded_run_hmc",
    "initialize_distributed",
    "BODY_AXIS",
    "make_body_mesh",
    "pad_bodies",
    "ring_nbody_accelerations",
    "ring_nbody_potential_energy",
    "ring_simulate",
    "ring_systematic_resample",
]
