"""API-faithful stand-in for the slice of NumPyro the adapter consumes.

numpyro cannot be installed in every environment (none here: zero egress),
but ``models/numpyro_adapter.py`` must still be *executed* by the suite.
This shim reproduces the exact
``numpyro.infer.util.initialize_model`` contract the adapter relies on
(verified against NumPyro's documented behaviour with
``dynamic_args=False``):

    ModelInfo(param_info, potential_fn, postprocess_fn, model_trace)
      .param_info.z        unconstrained named params (pytree dict)
      potential_fn(z)      scalar potential at unconstrained params
      postprocess_fn(z)    constrained named params

backed by the native DSL, so the adapter's ravel/unravel + vmap
postprocess + init machinery runs for real. The companion *gated* tests in
test_numpyro.py run the same assertions against actual NumPyro (and its
NUTS oracle, reference CoinTossExample.py:35-65) whenever it is installed
— e.g. in CI, which pip-installs numpyro.
"""

from __future__ import annotations

import sys
import types
from collections import namedtuple

import jax
import jax.numpy as jnp

from physicsbasedbayesianinference_tpu.models.potential import (
    make_model_potential,
)

ModelInfo = namedtuple(
    "ModelInfo", ["param_info", "potential_fn", "postprocess_fn",
                  "model_trace"])
ParamInfo = namedtuple("ParamInfo", ["z", "potential_energy", "z_grad"])


def initialize_model(rng_key, model, *, model_args=(), model_kwargs=None,
                     dynamic_args=False, init_strategy=None):
    assert not dynamic_args, "shim implements the dynamic_args=False form"
    mp = make_model_potential(model, tuple(model_args),
                              dict(model_kwargs or {}))
    flat0 = mp.init(rng_key, 1, jitter=0.5)[0]
    z = mp.unflatten_unconstrained(flat0)

    def _flat(params):
        parts = [jnp.reshape(params[s.name], (-1,)) for s in mp.specs]
        return jnp.concatenate(parts) if parts else jnp.zeros((0,))

    def potential_fn(params):
        return mp.potential(_flat(params))

    def postprocess_fn(params):
        return {s.name: s.transform.forward(params[s.name])
                for s in mp.specs}

    pe = potential_fn(z)
    grad = jax.grad(potential_fn)(z)
    return ModelInfo(ParamInfo(z, pe, grad), potential_fn, postprocess_fn,
                     {})


def install() -> None:
    """Register the shim as ``numpyro`` in sys.modules (no-op if the real
    numpyro is importable — never shadow the genuine article)."""
    try:
        import numpyro  # noqa: F401
        return
    except ImportError:
        pass
    numpyro_mod = types.ModuleType("numpyro")
    infer_mod = types.ModuleType("numpyro.infer")
    util_mod = types.ModuleType("numpyro.infer.util")
    util_mod.initialize_model = initialize_model
    infer_mod.util = util_mod
    numpyro_mod.infer = infer_mod
    numpyro_mod.__is_pbbi_shim__ = True
    sys.modules["numpyro"] = numpyro_mod
    sys.modules["numpyro.infer"] = infer_mod
    sys.modules["numpyro.infer.util"] = util_mod


def uninstall() -> None:
    mod = sys.modules.get("numpyro")
    if mod is not None and getattr(mod, "__is_pbbi_shim__", False):
        for name in ("numpyro", "numpyro.infer", "numpyro.infer.util"):
            sys.modules.pop(name, None)
