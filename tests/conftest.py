"""Test configuration: run the suite on a virtual 8-device CPU mesh.

``--xla_force_host_platform_device_count=8`` gives the CPU backend eight
devices, so shard_map / GSPMD collectives run without a multi-card host
(SURVEY.md §4). The platform is pinned to the CPU through ``jax.config``
before any computation, unless ``PBBI_TEST_BACKEND=gpu`` asks for the
card: that is how ``chip_smoke.py``'s test phase runs the tests marked
``gpu`` (``python -m pytest -m gpu tests/`` on the machine with the card).

Tests marked ``gpu`` need the card; the ``_gpu_only`` fixture skips them
at run time, with the reason, when JAX's backend is not a GPU.
"""

import os

import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if os.environ.get("PBBI_TEST_BACKEND") != "gpu":
    jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (compiled Pallas/Triton "
        "kernels); run on the card with PBBI_TEST_BACKEND=gpu "
        "python -m pytest -m gpu tests/")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    if request.node.get_closest_marker("gpu") is not None \
            and jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; runs in chip_smoke.py's test phase")
