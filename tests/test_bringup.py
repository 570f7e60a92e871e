"""What running on the GPU forced: no flax/orbax dependency, one engine
per single-engine sampler (an explicit kernel="fused" raises there), and
the compile cache's placement."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from physicsbasedbayesianinference_tpu import chees, smc, tempering
from physicsbasedbayesianinference_tpu.ops import potentials as pot
from physicsbasedbayesianinference_tpu.parallel import sharded
from physicsbasedbayesianinference_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORTS = """
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("flax", "orbax", "numpyro", "matplotlib"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, _Block())
"""


def test_package_and_cli_run_without_flax_or_orbax(tmp_path):
    code = _BLOCKED_IMPORTS + """
import physicsbasedbayesianinference_tpu as pbbi
from physicsbasedbayesianinference_tpu.main import main
sys.exit(main(["--model", "builtin:std_normal_2d", "--num-walkers", "64",
               "--num-warmup", "10", "--num-samples", "5",
               "--checkpoint-dir", sys.argv[1], "--collect", "moments"]))
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path / "ck")],
                       cwd=REPO, capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert '"checkpoints_written": 1' in r.stdout


def _run_chees(kernel):
    chees.run_chees_hmc(jax.random.key(0), pot.make_standard_normal(2),
                        jnp.zeros((16, 2)), num_warmup=0, num_samples=1,
                        kernel=kernel)


def _run_smc(kernel):
    smc.run_smc(jax.random.key(0), pot.make_standard_normal(2),
                jnp.zeros((16, 2)), max_stages=1, kernel=kernel)


def _run_pt(kernel):
    tempering.run_parallel_tempering(
        jax.random.key(0), pot.make_standard_normal(2), jnp.zeros((16, 2)),
        num_replicas=2, num_warmup=0, num_samples=1, kernel=kernel)


def _run_sharded_dense(kernel):
    sharded.sharded_run_hmc(
        jax.random.key(0), pot.make_standard_normal(2), jnp.zeros((16, 2)),
        metric="dense", num_warmup=0, num_samples=1, num_steps=1,
        kernel=kernel)


@pytest.mark.parametrize("run", [_run_chees, _run_smc, _run_pt,
                                 _run_sharded_dense],
                         ids=["chees", "smc", "pt", "sharded_dense"])
def test_single_engine_samplers_reject_fused(run):
    with pytest.raises(ValueError, match="'auto' or 'xla'"):
        run("fused")
    run("xla")


def test_compile_cache_follows_env_var(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; nothing else is set
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_fixed_checkout_path(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        # the same path every time: it is part of the cache's key
        assert compile_cache.enable_compile_cache() == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
