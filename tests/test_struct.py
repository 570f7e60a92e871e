"""The pytree-dataclass helper (utils/struct.py) and every sampler state
class built on it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from physicsbasedbayesianinference_tpu.adaptation import (
    CovarianceState, DualAveragingState, VarianceState)
from physicsbasedbayesianinference_tpu.chees import ChEESAdaptState
from physicsbasedbayesianinference_tpu.ensemble import EnsembleState
from physicsbasedbayesianinference_tpu.hmc import HMCInfo, HMCState
from physicsbasedbayesianinference_tpu.nuts import NUTSInfo
from physicsbasedbayesianinference_tpu.physics.nbody import NBodySystem
from physicsbasedbayesianinference_tpu.physics.simulate import Trajectory
from physicsbasedbayesianinference_tpu.smc import SMCResult
from physicsbasedbayesianinference_tpu.utils import struct

STATE_CLASSES = [EnsembleState, DualAveragingState, VarianceState,
                 CovarianceState, Trajectory, NBodySystem, SMCResult,
                 HMCState, HMCInfo, ChEESAdaptState, NUTSInfo]


@struct.dataclass
class _Point:
    x: jax.Array
    scale: jax.Array
    label: str = struct.field(pytree_node=False, default="p")


def test_struct_replace_and_static_field():
    p = _Point(x=jnp.arange(3.0), scale=jnp.float32(2.0), label="a")
    q = p.replace(scale=jnp.float32(5.0))
    assert float(q.scale) == 5.0 and float(p.scale) == 2.0
    assert q.label == "a"
    # the static field is structure, not a leaf
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2
    assert jax.tree_util.tree_structure(p.replace(label="b")) != treedef
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.x = jnp.zeros(3)

    @jax.jit
    def f(pt):
        return pt.replace(x=pt.x * pt.scale)

    out = f(p)
    np.testing.assert_allclose(np.asarray(out.x), [0.0, 2.0, 4.0])
    assert out.label == "a"


def _filled(cls):
    """An instance with every field a distinct small array (nested state
    classes get a filled EnsembleState)."""
    kw = {}
    for i, f in enumerate(dataclasses.fields(cls)):
        if f.name == "ensemble":
            kw[f.name] = _filled(EnsembleState)
        else:
            kw[f.name] = jnp.full((2, 3), float(i), jnp.float32)
    return cls(**kw)


@pytest.mark.parametrize("cls", STATE_CLASSES, ids=lambda c: c.__name__)
def test_state_class_jit_roundtrip(cls):
    state = _filled(cls)
    n_leaves = len(jax.tree_util.tree_leaves(state))
    assert n_leaves >= len(dataclasses.fields(cls))

    out = jax.jit(lambda s: jax.tree_util.tree_map(lambda a: a + 1.0, s))(
        state)
    assert type(out) is cls
    for a, b in zip(jax.tree_util.tree_leaves(out),
                    jax.tree_util.tree_leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b) + 1.0)
    first = dataclasses.fields(cls)[0].name
    replaced = state.replace(**{first: getattr(out, first)})
    assert getattr(replaced, first) is getattr(out, first)
