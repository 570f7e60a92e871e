"""Checkpoints without orbax: numbered step directories of per-process
shard files, restored into a template's structure and shardings."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from physicsbasedbayesianinference_tpu import chees, hmc, nuts, smc
from physicsbasedbayesianinference_tpu.checkpoint import CheckpointManager
from physicsbasedbayesianinference_tpu.config import RunConfig
from physicsbasedbayesianinference_tpu.main import CHECKPOINT_SCHEMA, run
from physicsbasedbayesianinference_tpu.ops import potentials as pot

W, D = 32, 3


def _q(seed):
    return jax.random.normal(jax.random.key(seed), (W, D))


def _payload(kind, seed):
    target = pot.make_standard_normal(D)
    q = _q(seed)
    if kind == "hmc":
        return hmc.build_hmc_kernel(target, num_steps=4).init(q)
    if kind == "nuts":
        return nuts.build_nuts_kernel(target, max_depth=3).init(q)
    if kind == "chees":
        init_fn, _ = chees.build_jittered_hmc_kernel(target)
        return {"state": init_fn(q), "adapt": chees.chees_init(1.0 + seed),
                "tau": jnp.float32(seed)}
    if kind == "pt":
        qr = jnp.stack([q, 2.0 * q])
        return {"q": qr, "u": jnp.sum(qr, -1), "g": qr,
                "i": jnp.int32(seed)}
    if kind == "smc":
        m = smc.build_smc_machinery(target, W, jnp.float32, max_stages=5)
        return m["init_carry"](jax.random.key(seed), q)
    raise ValueError(kind)


def _assert_tree_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        if jnp.issubdtype(x.dtype, jax.dtypes.prng_key):
            x, y = jax.random.key_data(x), jax.random.key_data(y)
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("kind", ["hmc", "nuts", "chees", "pt", "smc"])
def test_sampler_state_roundtrip(tmp_path, kind):
    saved = _payload(kind, 1)
    mgr = CheckpointManager(str(tmp_path / kind))
    mgr.save(3, saved)
    assert mgr.latest_step() == 3
    restored = mgr.restore(_payload(kind, 2))
    _assert_tree_equal(restored, saved)


def test_typed_keys_roundtrip(tmp_path):
    keys = {"one": jax.random.key(42),
            "many": jax.random.split(jax.random.key(7), 4)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, keys)
    restored = mgr.restore({"one": jax.random.key(0),
                            "many": jax.random.split(jax.random.key(0), 4)})
    assert jnp.issubdtype(restored["one"].dtype, jax.dtypes.prng_key)
    _assert_tree_equal(restored, keys)
    # a restored key draws the same numbers as the saved one
    np.testing.assert_array_equal(
        np.asarray(jax.random.normal(restored["one"], (3,))),
        np.asarray(jax.random.normal(keys["one"], (3,))))


def test_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore({"x": jnp.zeros(2)})
    for step in (1, 2, 3):
        mgr.save(step, {"x": jnp.full((2,), float(step))})
    assert mgr.all_steps() == [2, 3]
    assert float(mgr.restore({"x": jnp.zeros(2)})["x"][0]) == 3.0
    assert float(mgr.restore({"x": jnp.zeros(2)}, step=2)["x"][0]) == 2.0
    # an unfinished save (no manifest) is not a step
    os.makedirs(tmp_path / "9.tmp")
    assert mgr.latest_step() == 3


def test_template_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": jnp.zeros((4, 2))})
    with pytest.raises(ValueError, match="leaf 0"):
        mgr.restore({"x": jnp.zeros((4, 3))})
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore({"x": jnp.zeros((4, 2)), "y": jnp.zeros(1)})


def test_sharded_state_restores_into_template_sharding(tmp_path):
    from physicsbasedbayesianinference_tpu.parallel import (
        make_walker_mesh, walker_sharding)
    mesh = make_walker_mesh()
    q = jax.device_put(jnp.arange(64.0).reshape(16, 4),
                       walker_sharding(mesh, 2))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"q": q})
    template = {"q": jax.device_put(jnp.zeros((16, 4)),
                                    walker_sharding(mesh, 2))}
    restored = mgr.restore(template)
    assert restored["q"].sharding == template["q"].sharding
    np.testing.assert_array_equal(np.asarray(restored["q"]), np.asarray(q))


def test_cli_rejects_mismatched_checkpoint_schema(tmp_path, monkeypatch):
    from physicsbasedbayesianinference_tpu import main as cli

    def cfg(name):
        return RunConfig(model="builtin:std_normal_2d", sampler="hmc",
                         num_walkers=32, num_warmup=10, num_samples=4,
                         num_steps=2, checkpoint_dir=str(tmp_path / name),
                         checkpoint_every=2, collect="moments")

    first = run(cfg("a"))
    assert first["checkpoints_written"] == 2
    # a payload of another structure: a clear error, not a crash
    mgr = CheckpointManager(str(tmp_path / "a"))
    mgr.save(mgr.latest_step() + 1, {"x": jnp.zeros(3)})
    with pytest.raises(RuntimeError, match="does not match"):
        run(cfg("a"))

    # the same structure written under an older schema version
    monkeypatch.setattr(cli, "CHECKPOINT_SCHEMA", CHECKPOINT_SCHEMA - 1)
    run(dataclasses.replace(cfg("b"), num_samples=2))
    monkeypatch.setattr(cli, "CHECKPOINT_SCHEMA", CHECKPOINT_SCHEMA)
    with pytest.raises(RuntimeError, match=f"v{CHECKPOINT_SCHEMA - 1}"):
        run(cfg("b"))
