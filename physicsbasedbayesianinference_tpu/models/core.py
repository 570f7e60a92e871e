"""Native probabilistic-model DSL: sample/plate statements + effect handlers.

The reference defines models the NumPyro way — a plain Python function with
``sample(name, dist, obs=...)`` statements, optionally inside ``plate``
blocks, consumed via ``numpyro.infer.util.log_density(model, args, kwargs,
params)`` (reference samples/NumpyroExamples/CoinToss/CoinToss.py:5-22,
CoinTossExample.py:75-107; eight_schools.py:5-10). NumPyro is not a
guaranteed dependency of this framework, so this module implements that
exact contract natively: a minimal effect-handler stack (seed / substitute /
trace) over ``sample`` statements. Models written for the reference port by
changing one import.

Everything here happens at JAX *trace* time — the model function is plain
Python that runs once per compilation, emitting jnp ops; there is no
runtime interpretation overhead inside jitted samplers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import zlib
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from .distributions import Distribution

Array = jax.Array

_HANDLER_STACK: list = []
_PLATE_STACK: list = []


@dataclasses.dataclass
class Site:
    """One recorded sample statement."""

    name: str
    dist: Distribution
    value: Any
    is_observed: bool
    log_prob: Optional[Array] = None
    scale: float = 1.0  # plate-subsampling likelihood rescale (prod over
    #                     active plates of size/subsample_size)
    is_deterministic: bool = False  # value computed from other sites (a
    #                     reparameterised site); contributes no log_prob
    #                     and is not a latent dimension


class _Handler:
    def process(self, name: str, dist: Distribution, obs) -> tuple:
        """Return (value, handled: bool)."""
        raise NotImplementedError

    def postprocess(self, site: Site) -> None:
        pass

    def __enter__(self):
        _HANDLER_STACK.append(self)
        return self

    def __exit__(self, *exc):
        assert _HANDLER_STACK.pop() is self


class seed(_Handler):
    """Draw unobserved sites from their priors using a PRNG key."""

    def __init__(self, key: Array):
        self.key = key
        self._count = 0

    def process(self, name, dist, obs):
        if obs is not None:
            return obs, True
        self._count += 1
        subkey = jax.random.fold_in(self.key, self._count)
        shape = _plate_shape(dist)
        return dist.sample(subkey, shape), True


class substitute(_Handler):
    """Fix named latent sites to given values (constrained space)."""

    def __init__(self, params: dict):
        self.params = params

    def process(self, name, dist, obs):
        if obs is not None:
            return obs, True
        if name in self.params:
            return self.params[name], True
        return None, False


class trace(_Handler):
    """Record every site (value + log_prob) into ``self.sites``."""

    def __init__(self):
        self.sites: dict[str, Site] = {}

    def process(self, name, dist, obs):
        return None, False

    def postprocess(self, site):
        if site.name in self.sites:
            raise ValueError(f"duplicate sample site {site.name!r}")
        self.sites[site.name] = site


# Loc-scale families: dist(loc, scale) == loc + scale * dist(0, 1) with all
# other fields held fixed — the algebraic fact LocScaleReparam relies on.
def _loc_scale_types():
    from . import distributions as d
    return (d.Normal, d.Cauchy, d.StudentT, d.Laplace)


DECENTERED_SUFFIX = "_decentered"


class reparam(_Handler):
    """Non-centering (LocScaleReparam) handler: rewrite selected latent
    loc-scale sites ``x ~ D(loc, scale)`` as an auxiliary standard site
    ``x_decentered ~ D(0, 1)`` with the deterministic value
    ``x = loc + scale * x_decentered``.

    Same joint density, radically different geometry: centered
    hierarchical models (the reference's exact eight-schools form,
    reference samples/NumpyroExamples/eight_schools.py:5-10) put HMC in a
    Neal's-funnel throat where the step size must track ``tau``;
    the non-centered coordinates decouple the hierarchy and sample well
    at a fixed step.

    ``config``:

    * ``"auto"`` — reparameterise every latent loc-scale site whose loc
      or scale is a traced/computed array (i.e. depends on other
      latents); constant-parameter sites are left alone.
    * an iterable of site names — reparameterise exactly those.
    * a dict ``{name: bool}`` — explicit per-site control.
    """

    def __init__(self, config="auto"):
        if isinstance(config, str) and config != "auto":
            # a bare site name, NOT a char-iterable ("theta" must mean
            # the site 'theta', never the sites 't','h','e','a')
            config = [config]
        if config != "auto" and not isinstance(config, dict):
            config = {name: True for name in config}
        self.config = config
        self._rewritten: set = set()

    def _selected(self, name: str, dist) -> bool:
        if name.endswith(DECENTERED_SUFFIX):
            return False
        if not isinstance(dist, _loc_scale_types()):
            return False
        if isinstance(self.config, dict):
            return bool(self.config.get(name, False))
        # auto: loc/scale computed from other sites arrive as jax values;
        # literal model constants stay python/numpy scalars
        return isinstance(dist.loc, (jax.Array, jax.core.Tracer)) \
            or isinstance(dist.scale, (jax.Array, jax.core.Tracer))

    def process(self, name, dist, obs):
        if obs is not None or not self._selected(name, dist):
            return None, False
        base = dataclasses.replace(dist, loc=0.0, scale=1.0)
        z = sample(name + DECENTERED_SUFFIX, base)
        self._rewritten.add(name)
        return dist.loc + dist.scale * z, True

    def postprocess(self, site):
        if site.name in self._rewritten:
            site.is_deterministic = True
            site.log_prob = jnp.zeros_like(jnp.asarray(site.log_prob))


def reparametrized(model: Callable, config="auto") -> Callable:
    """Wrap a model so it always runs under :class:`reparam`; the wrapped
    model's latent space uses the decentered coordinates."""
    def wrapped(*args, **kwargs):
        with reparam(config):
            return model(*args, **kwargs)
    wrapped.__name__ = getattr(model, "__name__", "model") + "_reparam"
    return wrapped


@dataclasses.dataclass
class _Plate:
    name: str
    size: int
    dim: int                       # negative, NumPyro convention
    subsample_size: int            # == size when not subsampling
    idx: Any                       # [subsample_size] int indices into 0..size


@contextlib.contextmanager
def plate(name: str, size: int, subsample_size: Optional[int] = None,
          dim: Optional[int] = None, key: Optional[Array] = None):
    """Conditionally-independent batch dimension (reference
    eight_schools.py:8: ``with plate("J", J):``).

    NumPyro-compatible semantics:

    * ``dim`` is the (negative) batch axis this plate controls. When
      omitted it is allocated NumPyro-style — the rightmost dim not
      occupied by an enclosing plate — so nested plates index distinct
      axes and samples inside ``plate(a) > plate(b)`` have shape
      ``(size_b, size_a)``.
    * ``subsample_size`` enables minibatch subsampling: the block yields
      a ``[subsample_size]`` index array (use it to slice observed
      data), sample statements inside draw ``subsample_size`` copies
      along ``dim``, and their log probabilities are rescaled by
      ``size / subsample_size`` so the joint density is an unbiased
      estimate of the full-data density. Indices come from ``key`` if
      given, else from an enclosing :class:`seed` handler.

    Yields the subsample index array (``arange(size)`` when not
    subsampling); ``with plate(...):`` without ``as`` keeps working.
    """
    size = int(size)
    if dim is None:
        used = {p.dim for p in _PLATE_STACK}
        dim = -1
        while dim in used:
            dim -= 1
    else:
        dim = int(dim)
        if dim >= 0:
            raise ValueError(f"plate dim must be negative, got {dim}")
        if any(p.dim == dim for p in _PLATE_STACK):
            raise ValueError(
                f"plate {name!r}: dim {dim} already taken by an enclosing "
                f"plate")
    if subsample_size is not None and int(subsample_size) > size:
        raise ValueError(
            f"plate {name!r}: subsample_size={int(subsample_size)} exceeds "
            f"size={size}")
    if subsample_size is None or int(subsample_size) == size:
        sub, idx = size, jnp.arange(size)
    else:
        sub = int(subsample_size)
        if key is None:
            for handler in reversed(_HANDLER_STACK):
                if isinstance(handler, seed):
                    # Deterministic digest (NOT Python's salted hash(), which
                    # varies per process and would break seeded determinism),
                    # folded under a 'PLAT' tag so plate keys live in a
                    # namespace disjoint from seed.process's small per-site
                    # counters.
                    digest = zlib.crc32(name.encode("utf-8")) & 0x7FFFFFFF
                    key = jax.random.fold_in(
                        jax.random.fold_in(handler.key, 0x504C4154), digest)
                    break
        if key is None:
            raise ValueError(
                f"plate {name!r}: subsample_size={sub} needs randomness — "
                f"pass key=... or run the model under seed(key)")
        idx = jax.random.choice(key, size, (sub,), replace=False)
    _PLATE_STACK.append(_Plate(name, size, dim, sub, idx))
    try:
        yield idx
    finally:
        _PLATE_STACK.pop()


def _plate_shape(dist: Distribution) -> tuple:
    """Batch shape implied by active plates: each plate's (sub)size placed
    at its own dim (NumPyro allocation), broadcast with the distribution's
    intrinsic batch shape."""
    if not _PLATE_STACK:
        return jnp.broadcast_shapes((), dist.batch_shape)
    ndim = max(-p.dim for p in _PLATE_STACK)
    shape = [1] * ndim
    for p in _PLATE_STACK:
        shape[p.dim] = p.subsample_size
    return jnp.broadcast_shapes(tuple(shape), dist.batch_shape)


def _plate_scale() -> float:
    scale = 1.0
    for p in _PLATE_STACK:
        if p.subsample_size != p.size:
            scale *= p.size / p.subsample_size
    return scale


def sample(name: str, dist: Distribution, obs=None):
    """A sample statement. Under no handler, requires ``obs``."""
    value = obs
    for handler in reversed(_HANDLER_STACK):
        v, handled = handler.process(name, dist, obs)
        if handled:
            value = v
            break
    if value is None:
        raise RuntimeError(
            f"latent site {name!r} reached bottom of handler stack; run the "
            f"model under seed(key) or substitute(params)")
    site = Site(name=name, dist=dist, value=value, is_observed=obs is not None,
                scale=_plate_scale())
    site.log_prob = dist.log_prob(value)
    for handler in reversed(_HANDLER_STACK):
        handler.postprocess(site)
    return value


def log_density(model: Callable, model_args: tuple, model_kwargs: dict,
                params: dict) -> tuple[Array, dict]:
    """Joint log density of the model at constrained ``params``.

    Signature-compatible with ``numpyro.infer.util.log_density`` as the
    reference uses it (CoinTossExample.py:75-81: returns ``(logp, trace)``);
    gradients via ``jax.grad(lambda p: log_density(model, args, kwargs,
    p)[0])`` work exactly as in CoinTossExample.py:96-107.
    """
    with trace() as tr, substitute(params):
        model(*model_args, **model_kwargs)
    total = jnp.asarray(0.0)
    for site in tr.sites.values():
        if site.is_deterministic:
            continue
        lp = jnp.sum(site.log_prob)
        total = total + (site.scale * lp if site.scale != 1.0 else lp)
    return total, tr.sites


def trace_model(model: Callable, model_args: tuple = (),
                model_kwargs: Optional[dict] = None, *,
                key: Optional[Array] = None,
                params: Optional[dict] = None) -> dict[str, Site]:
    """Run the model and return its site dict; latent sites come from
    ``params`` when given, else from prior draws with ``key``."""
    model_kwargs = model_kwargs or {}
    ctx: Any
    if params is not None:
        ctx = substitute(params)
    else:
        ctx = seed(key if key is not None else jax.random.key(0))
    with trace() as tr, ctx:
        model(*model_args, **model_kwargs)
    return tr.sites
