"""Checkpoint / resume for long sampling runs.

The reference persists nothing — samples accumulate in an in-memory array
returned at the end (reference HMC.py:136-145,178-183; SURVEY.md §5
"Checkpoint/resume: absent"). Here the full sampler state pytree
(ensemble q/p/mass, cached potential+grad, adapted step size, RNG key,
iteration counter) is written as numbered step directories:

    <directory>/<step>/manifest.json        leaf count, shapes, dtypes
    <directory>/<step>/shards.p<k>.npz      process k's array shards

Every process writes the shards it can address (one copy of each, the
``replica_id == 0`` one), so a multi-process sharded state is saved
without gathering it anywhere; restore reads all shard files and places
each leaf into the template's sharding. That is the multi-host recovery
story: no elastic membership; restart with the same topology and
continue. Writes go to a temporary directory that is renamed into place
once complete, so a crash mid-save leaves the previous step intact.

Typed PRNG keys are unwrapped to their uint32 key data for serialisation
and rewrapped on restore.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

_KEY_SENTINEL = "__prng_key__"
_MANIFEST = "manifest.json"


def _pack(tree):
    """Replace typed PRNG keys with serialisable dicts."""
    def pack_leaf(x):
        if isinstance(x, jax.Array) and jnp.issubdtype(x.dtype, jax.dtypes.prng_key):
            return {_KEY_SENTINEL: jax.random.key_data(x)}
        return x
    return jax.tree_util.tree_map(
        pack_leaf, tree,
        is_leaf=lambda x: isinstance(x, jax.Array))


def _unpack(tree):
    def is_packed(x):
        return isinstance(x, dict) and set(x) == {_KEY_SENTINEL}

    def unpack_leaf(x):
        if is_packed(x):
            return jax.random.wrap_key_data(x[_KEY_SENTINEL])
        return x
    return jax.tree_util.tree_map(unpack_leaf, tree, is_leaf=is_packed)


def _barrier(name: str) -> None:
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices(name)


def _local_shards(x) -> list:
    """[(index tuple of slices, numpy block)] this process must write."""
    if isinstance(x, jax.Array):
        return [(s.index, np.asarray(s.data)) for s in x.addressable_shards
                if s.replica_id == 0]
    if jax.process_index() != 0:
        return []
    arr = np.asarray(x)
    return [(tuple(slice(0, n) for n in arr.shape), arr)]


def _slice_bounds(index, shape) -> list:
    return [list(sl.indices(n)[:2]) for sl, n in zip(index, shape)]


@dataclasses.dataclass
class CheckpointManager:
    """Numbered checkpoints under ``directory`` with retention. Any pytree
    of arrays (sampler states included) plus scalars/keys round-trips."""

    directory: str
    max_to_keep: int = 3

    def __post_init__(self):
        self.directory = os.path.abspath(self.directory)
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self) -> list:
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.exists(
                    os.path.join(self.directory, name, _MANIFEST)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> None:
        leaves = jax.tree_util.tree_leaves(_pack(state))
        tmp = self._step_dir(step) + ".tmp"
        if jax.process_index() == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        _barrier(f"ckpt_mkdir_{step}")

        blocks, bounds = {}, {}
        for i, leaf in enumerate(leaves):
            shape = np.shape(leaf)
            for j, (index, block) in enumerate(_local_shards(leaf)):
                blocks[f"{i}_{j}"] = block
                bounds[f"{i}_{j}"] = _slice_bounds(index, shape)
        pid = jax.process_index()
        np.savez(os.path.join(tmp, f"shards.p{pid}.npz"), **blocks)
        with open(os.path.join(tmp, f"shards.p{pid}.json"), "w") as f:
            json.dump(bounds, f)
        _barrier(f"ckpt_written_{step}")

        if pid == 0:
            manifest = {
                "num_leaves": len(leaves),
                "shapes": [list(np.shape(x)) for x in leaves],
                "dtypes": [str(np.dtype(x.dtype)) if hasattr(x, "dtype")
                           else str(np.asarray(x).dtype) for x in leaves],
                "process_count": jax.process_count(),
            }
            with open(os.path.join(tmp, _MANIFEST), "w") as f:
                json.dump(manifest, f)
            final = self._step_dir(step)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)
        _barrier(f"ckpt_done_{step}")

    def _read_leaves(self, step: int) -> list:
        d = self._step_dir(step)
        with open(os.path.join(d, _MANIFEST)) as f:
            manifest = json.load(f)
        full = [np.zeros(s, np.dtype(t))
                for s, t in zip(manifest["shapes"], manifest["dtypes"])]
        for pid in range(manifest["process_count"]):
            with open(os.path.join(d, f"shards.p{pid}.json")) as f:
                bounds = json.load(f)
            with np.load(os.path.join(d, f"shards.p{pid}.npz")) as blocks:
                for name, bnd in bounds.items():
                    i = int(name.split("_")[0])
                    idx = tuple(slice(a, b) for a, b in bnd)
                    full[i][idx] = blocks[name]
        return full

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """Restore into the structure/shardings of ``template`` (pass the
        freshly-initialised state — shapes/dtypes must match)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoints under {self.directory}")
        packed = _pack(template)
        t_leaves, treedef = jax.tree_util.tree_flatten(packed)
        saved = self._read_leaves(step)
        if len(saved) != len(t_leaves):
            raise ValueError(
                f"checkpoint step {step} holds {len(saved)} leaves; the "
                f"template has {len(t_leaves)}")
        out = []
        for i, (t, arr) in enumerate(zip(t_leaves, saved)):
            t_shape = tuple(np.shape(t))
            t_dtype = np.dtype(t.dtype) if hasattr(t, "dtype") \
                else np.asarray(t).dtype
            if arr.shape != t_shape or arr.dtype != t_dtype:
                raise ValueError(
                    f"checkpoint leaf {i}: saved {arr.dtype}{list(arr.shape)}"
                    f" != template {t_dtype}{list(t_shape)}")
            if isinstance(t, jax.Array):
                out.append(jax.make_array_from_callback(
                    arr.shape, t.sharding, lambda idx, a=arr: a[idx]))
            else:
                out.append(jnp.asarray(arr))
        return _unpack(jax.tree_util.tree_unflatten(treedef, out))
