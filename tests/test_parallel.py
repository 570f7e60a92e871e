"""Multi-device sharding tests on the virtual 8-device CPU mesh.

The distributed-testing capability the reference lacks entirely
(SURVEY.md §4: "Distributed testing: none exists").
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import physicsbasedbayesianinference_tpu as pbbi
from physicsbasedbayesianinference_tpu import parallel as par
from physicsbasedbayesianinference_tpu.ops import potentials as pot


def test_mesh_has_8_devices():
    mesh = par.make_walker_mesh()
    assert mesh.devices.size == 8


def test_shard_ensemble_placement():
    mesh = par.make_walker_mesh()
    state = pbbi.new_ensemble(num_walkers=64, num_dims=4,
                              mass=jnp.ones(4))
    sharded = par.shard_ensemble(state, mesh)
    # q/p/log_weight split on walkers; per-dim mass replicated
    assert sharded.q.sharding.is_equivalent_to(
        par.walker_sharding(mesh, 2), 2)
    assert len(sharded.q.addressable_shards) == 8
    assert sharded.q.addressable_shards[0].data.shape == (8, 4)
    assert sharded.mass.sharding.is_fully_replicated


def test_gspmd_run_bitwise_matches_single_device():
    # Same key, fixed step size: GSPMD sharding must not change results at
    # all (threefry is partitionable, per-walker ops are element-wise).
    fn = pot.make_banana()
    q0 = jax.random.normal(jax.random.key(0), (64, 2))
    kw = dict(num_warmup=0, num_samples=30, num_steps=8, init_step_size=0.05)
    r_single = pbbi.run_hmc(jax.random.key(1), fn, q0, **kw)
    mesh = par.make_walker_mesh()
    r_shard = par.sharded_run_hmc(jax.random.key(1), fn, q0, mesh=mesh, **kw)
    np.testing.assert_array_equal(np.asarray(r_single.samples),
                                  np.asarray(r_shard.samples))


def test_gspmd_adapted_run_matches_moments():
    # With warmup, cross-walker reductions reorder float sums, so agreement
    # is statistical: posterior moments must match to MC error.
    fn = pot.make_standard_normal(3)
    q0 = jax.random.normal(jax.random.key(4), (1024, 3))
    kw = dict(num_warmup=150, num_samples=150, num_steps=10,
              collect="moments")
    r_single = pbbi.run_hmc(jax.random.key(5), fn, q0, **kw)
    mesh = par.make_walker_mesh()
    r_shard = par.sharded_run_hmc(jax.random.key(5), fn, q0, mesh=mesh, **kw)
    np.testing.assert_allclose(np.asarray(r_shard.mean),
                               np.asarray(r_single.mean), atol=0.05)
    np.testing.assert_allclose(np.asarray(r_shard.var),
                               np.asarray(r_single.var), rtol=0.08)


def test_shard_map_step_stats_and_moments():
    fn = pot.make_standard_normal(2)
    kernel = pbbi.build_hmc_kernel(fn, num_steps=12)
    mesh = par.make_walker_mesh()
    q0 = jax.random.normal(jax.random.key(2), (4096, 2))
    state = kernel.init(q0)
    state = par.shard_ensemble(state, mesh)
    step = par.build_sharded_hmc_step(kernel, mesh, state)

    key = jax.random.key(3)
    qs = []
    for i in range(40):
        key, sub = jax.random.split(key)
        state, info, stats = step(sub, state, 0.3)
        if i >= 15:
            qs.append(np.asarray(state.ensemble.q))
    assert 0.7 < float(stats["accept_rate"]) <= 1.0
    assert float(stats["divergence_rate"]) == 0.0
    samples = np.concatenate(qs, 0)
    np.testing.assert_allclose(samples.mean(axis=0), 0.0, atol=0.05)
    np.testing.assert_allclose(samples.std(axis=0), 1.0, rtol=0.05)
    # state stays sharded across steps (no silent gather)
    assert len(state.ensemble.q.addressable_shards) == 8


def test_sharded_run_hmc_fused_composition_moments():
    """The shard_map composition through the full driver:
    ``run_hmc(kernel=shard_map_kernel(build_hmc_kernel(...), mesh))`` —
    the shard_map transition inside the run_hmc warmup+sampling scans,
    per-shard RNG, sharded outputs, at K=8."""
    fn = pot.make_standard_normal(3)
    q0 = jax.random.normal(jax.random.key(7), (2048, 3))
    mesh = par.make_walker_mesh()
    kw = dict(num_warmup=100, num_samples=200, num_steps=8,
              collect="moments")
    kernel = par.shard_map_kernel(
        pbbi.build_hmc_kernel(fn, num_steps=8), mesh)
    r = pbbi.run_hmc(jax.random.key(8), fn, q0, kernel=kernel, **kw)
    assert r.kernel_used == "xla+shard_map"
    np.testing.assert_allclose(np.asarray(r.mean), 0.0, atol=0.06)
    np.testing.assert_allclose(np.asarray(r.var), 1.0, rtol=0.08)
    assert 0.6 < float(r.accept_rate) <= 1.0
    # the final state is still sharded over all 8 devices — the
    # composition never forced a gather
    assert len(r.state.ensemble.q.addressable_shards) == 8


def test_shard_map_per_shard_rng_distinct():
    # Different shards must draw different momenta (key folded by axis idx).
    fn = pot.make_standard_normal(2)
    kernel = pbbi.build_hmc_kernel(fn, num_steps=2)
    mesh = par.make_walker_mesh()
    q0 = jnp.zeros((16, 2))
    state = par.shard_ensemble(kernel.init(q0), mesh)
    step = par.build_sharded_hmc_step(kernel, mesh, state)
    state, info, _ = step(jax.random.key(0), state, 0.2)
    p = np.asarray(state.ensemble.p).reshape(8, 2, 2)  # [shard, local_w, D]
    # no two shards share the same momentum block
    for i in range(8):
        for j in range(i + 1, 8):
            assert not np.allclose(p[i], p[j])


def test_walker_divisibility_error():
    fn = pot.make_standard_normal(2)
    mesh = par.make_walker_mesh()
    try:
        par.sharded_run_hmc(jax.random.key(0), fn, jnp.zeros((30, 2)),
                            mesh=mesh, num_warmup=0, num_samples=1,
                            num_steps=1)
        raise AssertionError("expected ValueError")
    except ValueError as e:
        assert "divisible" in str(e)


def test_initialize_distributed_single_host_noop():
    summary = par.initialize_distributed()
    assert summary["process_count"] == 1
    assert summary["global_devices"] == 8


def test_two_process_distributed_hmc():
    """REAL multi-process runtime: two
    OS processes x 4 virtual CPU devices each, joined by
    ``jax.distributed.initialize`` into one 8-device mesh; a sharded sum
    (cross-process all-reduce) and one sharded HMC transition must agree
    across processes AND with this process's single-process 8-device
    reference — the multi-node story the reference planned as an MPI
    stack (reference manuals/SetUp.md:82-200)."""
    import json
    import socket
    import subprocess
    import sys as _sys

    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "distributed_worker.py")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen(
        [_sys.executable, worker, str(port), str(pid)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env) for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))

    for pid, row in enumerate(outs):
        assert row["process_count"] == 2
        assert row["process_index"] == pid
        assert row["global_devices"] == 8
        assert row["local_devices"] == 4

    # both processes see identical globally-reduced values
    for key in ("sum", "accept", "mean_q", "mean_u"):
        np.testing.assert_allclose(outs[0][key], outs[1][key], rtol=1e-6)

    # ... and they match the single-process 8-device reference run here
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()), ("walkers",))
    w, d = 64, 4
    sharding = NamedSharding(mesh, P("walkers", None))
    base = np.arange(w * d, dtype=np.float32).reshape(w, d) / (w * d)
    np.testing.assert_allclose(outs[0]["sum"], base.sum(), rtol=1e-5)
    qnp = np.asarray(
        jax.random.normal(jax.random.key(3), (w, d), jnp.float32))
    q0 = jax.device_put(jnp.asarray(qnp), sharding)
    kernel = pbbi.build_hmc_kernel(pot.make_standard_normal(d),
                                   num_steps=4)
    state = kernel.init(q0)
    st, info = jax.jit(
        lambda k, s: kernel.step(k, s, jnp.float32(0.5)))(
        jax.random.key(0), state)
    np.testing.assert_allclose(
        outs[0]["accept"], float(jnp.mean(info.accept_prob)), atol=1e-5)
    np.testing.assert_allclose(
        outs[0]["mean_q"], float(jnp.mean(st.ensemble.q)), atol=1e-5)


def _launch_workers(mode, ckpt_dir):
    import json
    import socket
    import subprocess
    import sys as _sys

    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "distributed_worker.py")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen(
        [_sys.executable, worker, str(port), str(pid), mode, ckpt_dir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env) for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return outs


def test_two_process_fused_checkpoint_restart(tmp_path):
    """The full multi-host RECOVERY story in one test: 2 real processes x 4
    virtual devices run the
    shard_map composition, checkpoint the sharded state mid-run
    (per-process shard files), the cluster dies, a FRESH 2-process cluster
    restores and replays the remaining transitions — and lands on
    bit-identical moments to the uninterrupted run."""
    ckpt = str(tmp_path / "ckpt")

    full = _launch_workers("fused_ckpt_run", ckpt)
    resumed = _launch_workers("fused_ckpt_resume", ckpt)

    for outs in (full, resumed):
        assert {o["process_index"] for o in outs} == {0, 1}
        for o in outs:
            assert o["global_devices"] == 8
            assert "shard_map" in o["kernel_kind"]
        # both processes compute identical global reductions
        for key in ("mean_q", "mean_q2", "mean_u"):
            np.testing.assert_allclose(outs[0][key], outs[1][key],
                                       rtol=1e-6)

    # restart == uninterrupted, bit for bit (same compiled program, same
    # keys, same topology)
    for key in ("mean_q", "mean_q2", "mean_u"):
        assert full[0][key] == resumed[0][key], (
            key, full[0][key], resumed[0][key])


def test_sharded_specs_mass_not_walker_sharded_when_d_equals_w():
    """r5 review finding: the spec inference walker-sharded an adapted
    [D] diagonal mass whenever D == num_walkers. With structural specs
    the metric stays replicated and a warmup-adapting sharded run at
    W == D completes."""
    fn = pot.make_standard_normal(32)
    q0 = jax.random.normal(jax.random.key(0), (32, 32))
    mesh = par.make_walker_mesh()
    kernel = par.shard_map_kernel(
        pbbi.build_hmc_kernel(fn, num_steps=4), mesh)
    r = pbbi.run_hmc(jax.random.key(1), fn, q0, kernel=kernel,
                     num_warmup=40, num_samples=10, num_steps=4,
                     collect="none")
    assert 0.0 < float(r.accept_rate) <= 1.0
    assert np.asarray(r.mass).shape == (32,)
    assert r.state.ensemble.mass.sharding.is_fully_replicated


def test_sharded_dense_metric_rejects_explicit_fused():
    fn = pot.make_standard_normal(4)
    q0 = jnp.zeros((64, 4))
    mesh = par.make_walker_mesh()
    kw = dict(metric="dense", num_warmup=0, num_samples=1, num_steps=1)
    with pytest.raises(ValueError, match="'auto' or 'xla'"):
        par.sharded_run_hmc(jax.random.key(0), fn, q0, mesh=mesh,
                            kernel="fused", **kw)
    with pytest.raises(ValueError, match="dense-metric"):
        pbbi.run_hmc(jax.random.key(0), fn, q0, kernel="fused", **kw)
    r = par.sharded_run_hmc(jax.random.key(0), fn, q0, mesh=mesh, **kw)
    assert r.kernel_used == "dense"
