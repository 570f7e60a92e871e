"""Frozen pytree dataclasses for sampler state.

``@struct.dataclass`` makes a frozen dataclass whose fields are pytree
children (so states pass through ``jit``/``scan``/``shard_map``), with
``field(pytree_node=False)`` marking static metadata and ``.replace(**kw)``
returning an updated copy. Built on ``jax.tree_util.register_dataclass``.
"""

from __future__ import annotations

import dataclasses

import jax


def field(*, pytree_node: bool = True, **kwargs):
    """A dataclass field; ``pytree_node=False`` makes it static metadata
    (part of the tree structure, not a leaf)."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **updates):
    return dataclasses.replace(self, **updates)


def dataclass(cls):
    """Frozen dataclass registered as a pytree node, with ``.replace``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields
                     if f.metadata.get("pytree_node", True)],
        meta_fields=[f.name for f in fields
                     if not f.metadata.get("pytree_node", True)])
    cls.replace = _replace
    return cls
