"""Runtime-layer tests: diagnostics, checkpoint/resume, config, CLI driver."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import physicsbasedbayesianinference_tpu as pbbi
from physicsbasedbayesianinference_tpu import diagnostics as diag
from physicsbasedbayesianinference_tpu.checkpoint import CheckpointManager
from physicsbasedbayesianinference_tpu.config import RunConfig
from physicsbasedbayesianinference_tpu.main import build_potential, run
from physicsbasedbayesianinference_tpu.ops import potentials as pot


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------

def test_ess_iid_equals_sample_count():
    x = jax.random.normal(jax.random.key(0), (200, 32, 2))
    ess = diag.effective_sample_size(x)
    np.testing.assert_allclose(np.asarray(ess), 200 * 32, rtol=0.15)


def test_ess_detects_autocorrelation():
    """AR(1) with rho=0.9 has ESS fraction ~ (1-rho)/(1+rho) ~ 1/19."""
    key = jax.random.key(1)
    t, w = 1000, 16
    eps = jax.random.normal(key, (t, w, 1))

    def step(x, e):
        x = 0.9 * x + e
        return x, x
    _, series = jax.lax.scan(step, jnp.zeros((w, 1)), eps)
    ess = float(diag.effective_sample_size(series)[0])
    frac = ess / (t * w)
    assert 0.02 < frac < 0.12, frac


def test_rhat_flags_unmixed_walkers():
    key = jax.random.key(2)
    good = jax.random.normal(key, (100, 8, 1))
    assert float(diag.split_rhat(good)[0]) < 1.05
    offset = jnp.arange(8.0)[None, :, None] * 5.0
    bad = good + offset
    assert float(diag.split_rhat(bad)[0]) > 1.5


def test_summary_keys():
    x = jax.random.normal(jax.random.key(3), (50, 8, 3))
    s = diag.summary(x)
    assert set(s) == {"mean", "sd", "quantiles", "ess", "rhat"}
    assert s["quantiles"].shape == (3, 3)


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    kernel = pbbi.build_hmc_kernel(pot.make_standard_normal(3), num_steps=4)
    state = kernel.init(jax.random.normal(jax.random.key(1), (32, 3)))
    payload = {"sampler": state, "step_size": jnp.float32(0.3),
               "key": jax.random.key(42), "iteration": jnp.int32(7)}
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(7, payload)
    template = {"sampler": kernel.init(jnp.zeros((32, 3))),
                "step_size": jnp.float32(0.0),
                "key": jax.random.key(0), "iteration": jnp.int32(0)}
    restored = mgr.restore(template)
    assert int(restored["iteration"]) == 7
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(restored["key"])),
        np.asarray(jax.random.key_data(payload["key"])))
    np.testing.assert_allclose(np.asarray(restored["sampler"].ensemble.q),
                               np.asarray(state.ensemble.q))
    assert mgr.latest_step() == 7


def test_checkpoint_resume_continues_sampling(tmp_path):
    """Save mid-run, restore, continue: resumed chain must equal the
    uninterrupted chain (same keys -> identical trajectories)."""
    kernel = pbbi.build_hmc_kernel(pot.make_standard_normal(2), num_steps=8)
    state = kernel.init(jax.random.normal(jax.random.key(0), (64, 2)))
    keys = jax.random.split(jax.random.key(1), 10)
    step = jax.jit(kernel.step)
    s = state
    for k in keys[:5]:
        s, _ = step(k, s, jnp.float32(0.5))
    mgr = CheckpointManager(str(tmp_path / "c2"))
    mgr.save(5, s)
    s_restored = mgr.restore(kernel.init(jnp.zeros((64, 2))))
    a, b = s, s_restored
    for k in keys[5:]:
        a, _ = step(k, a, jnp.float32(0.5))
        b, _ = step(k, b, jnp.float32(0.5))
    np.testing.assert_allclose(np.asarray(a.ensemble.q),
                               np.asarray(b.ensemble.q))


# ---------------------------------------------------------------------------
# config + CLI
# ---------------------------------------------------------------------------

def test_config_json_roundtrip():
    cfg = RunConfig(model="builtin:banana", sampler="nuts", num_walkers=64)
    cfg2 = RunConfig.from_json(cfg.to_json())
    assert cfg2 == cfg


def test_config_unknown_key_rejected():
    with pytest.raises(ValueError, match="unknown config keys"):
        RunConfig.from_json('{"walkers": 3}')


def test_build_potential_builtin():
    fn, init, constrain = build_potential(RunConfig(model="builtin:banana"))
    q = init(jax.random.key(0), 8)
    assert q.shape == (8, 2)
    assert jnp.isfinite(fn(q[0]))
    assert constrain is None


def test_build_potential_bad_ref():
    with pytest.raises(ValueError, match="builtin"):
        build_potential(RunConfig(model="builtin:nope"))
    with pytest.raises(ValueError, match="bad model reference"):
        build_potential(RunConfig(model="nonsense"))


def test_cli_run_hmc_gaussian(tmp_path):
    out = str(tmp_path / "run.npz")
    cfg = RunConfig(model="builtin:std_normal_2d", sampler="hmc",
                    num_walkers=256, num_warmup=100, num_samples=100,
                    num_steps=8, output_path=out)
    summary = run(cfg)
    assert summary["accept_rate"] > 0.6
    np.testing.assert_allclose(summary["posterior_mean"], 0.0, atol=0.1)
    assert summary["max_rhat"] < 1.1
    data = np.load(out, allow_pickle=False)
    assert data["samples"].shape == (100, 256, 2)
    assert json.loads(str(data["summary"]))["accept_rate"] > 0.6


def test_cli_checkpointed_run_resumes(tmp_path):
    """CLI fault-tolerance path: a second invocation against the same
    checkpoint_dir resumes from the latest checkpoint instead of
    rewarming, and extends the run to the new num_samples."""
    ckpt = str(tmp_path / "ckpt")
    base = dict(model="builtin:std_normal_2d", sampler="hmc",
                num_walkers=128, num_warmup=80, num_steps=8,
                checkpoint_dir=ckpt, checkpoint_every=20, seed=5)
    s1 = run(RunConfig(num_samples=40, **base))
    assert s1["resumed_from"] is None
    assert s1["samples_done"] == 40
    assert s1["checkpoints_written"] == 2

    s2 = run(RunConfig(num_samples=80, **base))
    assert s2["resumed_from"] == 40
    assert s2["samples_done"] == 80
    assert s2["checkpoints_written"] == 2
    np.testing.assert_allclose(s2["posterior_mean"], 0.0, atol=0.1)
    np.testing.assert_allclose(s2["posterior_var"], 1.0, atol=0.2)


def test_cli_run_example_coin_toss(tmp_path):
    data_path = str(tmp_path / "coins.json")
    with open(data_path, "w") as f:
        json.dump({"c1": [1, 0] * 10, "c2": [1] * 15 + [0] * 5}, f)
    cfg = RunConfig(model="example:coin_toss", data_path=data_path,
                    sampler="hmc", num_walkers=256, num_warmup=150,
                    num_samples=150, num_steps=8)
    summary = run(cfg)
    means = summary["constrained_means"]
    assert abs(means["p1"] - 0.5) < 0.05
    assert abs(means["p2"] - 16 / 22) < 0.06


def test_ess_geyer_adaptive_lag_slow_chain():
    """A chain mixing slower than any fixed window must not have its tau
    truncated: AR(1) with phi=0.995 has tau = (1+phi)/(1-phi) ~ 400; the
    old fixed max_lag=128 estimator reported ~3x too much ESS."""
    import numpy as onp
    rng = onp.random.RandomState(0)
    t, w = 8192, 4
    phi = 0.995
    x = onp.zeros((t, w, 1), onp.float32)
    eps = rng.randn(t, w, 1).astype(onp.float32)
    for i in range(1, t):
        x[i] = phi * x[i - 1] + eps[i] * onp.sqrt(1 - phi * phi)
    ess = float(diag.effective_sample_size(jnp.asarray(x))[0])
    tau_true = (1 + phi) / (1 - phi)
    ess_true = t * w / tau_true
    assert 0.5 * ess_true < ess < 2.0 * ess_true, (ess, ess_true)


def test_cli_kernel_option(tmp_path):
    """--kernel flows config -> run_hmc; summary reports the engine that
    actually ran, and "fused" off the GPU fails instead of falling back."""
    cfg = RunConfig(model="builtin:std_normal_2d", sampler="hmc",
                    num_walkers=128, num_warmup=20, num_samples=20,
                    num_steps=4, kernel="auto", collect="moments")
    summary = run(cfg)
    assert summary["kernel_used"] == "xla"
    assert "kernel_variant" not in summary
    assert summary["sampling_seconds"] >= 0.0
    with pytest.raises(ValueError, match="no fused engine"):
        run(dataclasses.replace(cfg, kernel="fused"))
    cfg_bad = RunConfig(model="builtin:std_normal_2d", kernel="bogus",
                        num_walkers=64, num_warmup=4, num_samples=4,
                        num_steps=2)
    with pytest.raises(ValueError, match="kernel"):
        run(cfg_bad)


@pytest.mark.parametrize("sampler", ["nuts", "chees", "pt"])
def test_cli_checkpointed_non_hmc_resumes(tmp_path, sampler):
    """Checkpoint/resume now covers every scan-shaped sampler: a resumed
    run must continue to the new num_samples and reproduce the exact
    moments of an uninterrupted run (identical chunk-indexed RNG +
    Halton schedule)."""
    ckpt = str(tmp_path / f"ckpt_{sampler}")
    base = dict(model="builtin:std_normal_2d", sampler=sampler,
                num_walkers=128, num_warmup=60, num_steps=8,
                checkpoint_dir=ckpt, checkpoint_every=15, seed=5)
    if sampler == "pt":
        base.update(num_warmup=30, pt_replicas=4)
    s1 = run(RunConfig(num_samples=30, **base))
    assert s1["resumed_from"] is None
    assert s1["samples_done"] == 30

    s2 = run(RunConfig(num_samples=60, **base))
    assert s2["resumed_from"] == 30
    assert s2["samples_done"] == 60
    np.testing.assert_allclose(s2["posterior_mean"], 0.0, atol=0.12)
    np.testing.assert_allclose(s2["posterior_var"], 1.0, atol=0.25)

    # resumed-equality: an uninterrupted run of the full length from a
    # fresh dir must produce identical streamed moments
    ckpt2 = str(tmp_path / f"ckpt2_{sampler}")
    s3 = run(RunConfig(num_samples=60,
                       **dict(base, checkpoint_dir=ckpt2)))
    np.testing.assert_allclose(s2["posterior_mean"], s3["posterior_mean"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s2["posterior_var"], s3["posterior_var"],
                               rtol=1e-5)


def test_cli_checkpointed_smc_resumes(tmp_path):
    """Fault-tolerant SMC: the stage carry
    checkpoints after every annealing stage; a run resumed from an
    intermediate stage checkpoint must reproduce the uninterrupted run's
    final evidence and posterior exactly (the RNG key rides in the
    carry)."""
    import shutil

    ckpt_a = tmp_path / "smc_a"
    # 32-dim target from a near-flat start so the ESS-adaptive ladder
    # genuinely needs several stages (2-D from beta0=0.1 finishes in one)
    base = dict(model="builtin:std_normal_32d", sampler="smc",
                num_walkers=256, num_steps=8, smc_beta0=0.02,
                smc_max_stages=25, seed=3)
    s1 = run(RunConfig(checkpoint_dir=str(ckpt_a), **base))
    assert s1["resumed_from"] is None
    assert s1["checkpoints_written"] == s1["num_stages"]
    # resampling correlates walkers: effective N << 256, so per-dim MC
    # error is a few x 1/sqrt(256)
    np.testing.assert_allclose(s1["posterior_mean"], 0.0, atol=0.4)

    # simulate an interruption: seed a fresh dir with an INTERMEDIATE
    # stage checkpoint (retention keeps the last 3) and re-run
    stages = sorted(int(p.name) for p in ckpt_a.iterdir()
                    if p.name.isdigit())
    assert len(stages) >= 2
    mid = stages[0]
    assert mid < s1["num_stages"]
    ckpt_b = tmp_path / "smc_b"
    ckpt_b.mkdir()
    shutil.copytree(ckpt_a / str(mid), ckpt_b / str(mid))
    s2 = run(RunConfig(checkpoint_dir=str(ckpt_b), **base))
    assert s2["resumed_from"] == mid
    assert s2["num_stages"] == s1["num_stages"]
    np.testing.assert_allclose(s2["log_evidence"], s1["log_evidence"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s2["posterior_mean"], s1["posterior_mean"],
                               rtol=1e-5, atol=1e-6)

    # a completed run resumed again is a no-op that returns the result
    s3 = run(RunConfig(checkpoint_dir=str(ckpt_a), **base))
    assert s3["checkpoints_written"] == 0
    np.testing.assert_allclose(s3["log_evidence"], s1["log_evidence"],
                               rtol=1e-5, atol=1e-5)


def test_cli_reparam_auto_eight_schools(tmp_path):
    """The CLI's reparam="auto" flag (RunConfig.reparam) non-centers the
    reference's centered eight-schools: the latent space carries the
    decentered coordinate and the adapted step size is an order of
    magnitude larger than the raw geometry allows."""
    import json as _json

    data = tmp_path / "es.json"
    data.write_text(_json.dumps({
        "J": 8, "y": [28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0],
        "sigma": [15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0]}))
    cfg = RunConfig(model="example:eight_schools", data_path=str(data),
                    reparam="auto", num_walkers=128, num_warmup=150,
                    num_samples=50, num_steps=10, collect="moments")
    out = run(cfg)
    assert out["config"]["reparam"] == "auto"
    assert out["step_size"] > 0.15, out["step_size"]  # decentered geometry
    assert 0.5 < out["accept_rate"] <= 1.0


def test_cli_reparam_rejected_for_numpyro_models():
    """The native reparam handler cannot see inside a numpyro model's
    trace; setting reparam on a numpyro: reference must fail fast, not
    silently sample the centered geometry (r5 review finding)."""
    cfg = RunConfig(model="numpyro:some.mod:model", reparam="auto")
    with pytest.raises(ValueError, match="numpyro"):
        build_potential(cfg)
