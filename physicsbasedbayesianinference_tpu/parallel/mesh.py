"""Device mesh construction and ensemble sharding.

Replaces the reference's planned MPI topology (hostfile `127.0.0.1:6`
runtime model, reference manuals/SetUp.md:168-183) with a
``jax.sharding.Mesh`` over a single ``walkers`` axis. Walkers are i.i.d.
chains — the embarrassingly parallel axis — so a 1-D mesh is the right
topology; XLA routes the small ensemble reductions over the device
interconnect.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

WALKER_AXIS = "walkers"


def make_walker_mesh(devices: Optional[Sequence[jax.Device]] = None,
                     axis_name: str = WALKER_AXIS) -> Mesh:
    """1-D mesh over all (or the given) devices, axis ``walkers``."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def walker_sharding(mesh: Mesh, ndim: int = 2,
                    axis_name: str = WALKER_AXIS) -> NamedSharding:
    """Sharding that splits the leading (walker) axis; rest replicated."""
    return NamedSharding(mesh, P(axis_name, *([None] * (ndim - 1))))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_ensemble(tree, mesh: Mesh, axis_name: str = WALKER_AXIS):
    """Place a pytree of ensemble arrays on the mesh: every array whose

    leading dimension is the walker count is split on the walker axis;
    scalars and per-dim arrays (e.g. the shared diagonal metric) are
    replicated. Walker count is taken from the first array leaf with ndim>=1.
    """
    leaves = [l for l in jax.tree_util.tree_leaves(tree)
              if hasattr(l, "ndim") and l.ndim >= 1]
    if not leaves:
        raise ValueError("no array leaves to shard")
    num_walkers = leaves[0].shape[0]

    def place(x):
        if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] == num_walkers:
            spec = P(axis_name, *([None] * (x.ndim - 1)))
        else:
            spec = P()
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(place, tree)


REPLICA_AXIS = "replicas"


def make_replica_mesh(num_replica_shards: int,
                      devices: Optional[Sequence[jax.Device]] = None,
                      axis_names: tuple = (REPLICA_AXIS, WALKER_AXIS)
                      ) -> Mesh:
    """2-D mesh (replicas x walkers) for parallel tempering at scale:
    the temperature ladder maps onto its own mesh axis instead of being
    replicated per device. Replica-axis
    communication is only the adjacent-pair swap exchange once per
    transition; everything else is replica-local, so the replica axis
    tolerates the slower mesh dimension."""
    if devices is None:
        devices = jax.devices()
    devs = np.asarray(devices)
    if devs.size % num_replica_shards != 0:
        raise ValueError(
            f"{devs.size} devices not divisible by "
            f"{num_replica_shards} replica shards")
    return Mesh(devs.reshape(num_replica_shards, -1), axis_names)


def replica_sharding(mesh: Mesh, ndim: int = 3) -> NamedSharding:
    """Sharding for [R, W, ...] replica-ensemble arrays on a replica mesh."""
    return NamedSharding(
        mesh, P(REPLICA_AXIS, WALKER_AXIS, *([None] * (ndim - 2))))
