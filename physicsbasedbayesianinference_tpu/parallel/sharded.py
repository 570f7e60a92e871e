"""Sharded HMC execution: shard_map kernel wrapper + auto-SPMD run.

Two complementary paths, both over a ``walkers`` mesh axis (the
replacement for the reference's planned MPI parallelism, reference
manuals/SetUp.md:82-200; SURVEY.md §2 parallelism audit):

* :func:`build_sharded_hmc_step` / :func:`shard_map_kernel` — an explicit
  ``jax.shard_map`` wrapper around a built HMC kernel: each device owns a
  walker block, draws its own per-shard RNG stream (key folded with the
  mesh axis index), and ensemble scalars reduce with ``pmean``.
  Communication is explicit and provably just a few scalar collectives
  per transition.

* :func:`sharded_run_hmc` — the zero-ceremony path: place the initial
  positions with a walker sharding and let XLA auto-partition (GSPMD) the
  ordinary :func:`~..hmc.run_hmc` scans, inserting the scalar adaptation
  collectives itself. Statistically both match the single-device run
  (RNG streams per shard; floating-point reduction order in ensemble-mean
  statistics may differ across shardings), which the parity tests check
  to tolerance.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..hmc import HMCInfo, HMCKernel, HMCState
from .mesh import WALKER_AXIS, walker_sharding


def _specs_like(tree, num_walkers: int, axis_name: str):
    """Partition specs for a sampler-state pytree.

    :class:`~..hmc.HMCState` trees get STRUCTURAL specs (the ensemble's
    q/p/log_weight and the cached potential/grad are walker-leading; the
    mass/metric is replicated regardless of its shape — a [D] adapted
    diagonal mass with D == num_walkers must NOT be walker-sharded, the
    shape-sniffing failure mode). Other trees fall back to the
    leading-dim heuristic."""
    from ..hmc import HMCState

    def dim0_spec(x):
        if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] == num_walkers:
            return P(axis_name, *([None] * (x.ndim - 1)))
        return P()

    if isinstance(tree, HMCState):
        ens = tree.ensemble
        mass = jnp.asarray(ens.mass)
        # per-walker masses are [W, 1] (ensemble convention) -> sharded;
        # scalar / [D] diagonal metrics -> replicated
        mass_spec = (P(axis_name, *([None] * (mass.ndim - 1)))
                     if mass.ndim >= 2 and mass.shape[0] == num_walkers
                     else P())
        return HMCState(
            ensemble=ens.replace(
                q=P(axis_name, None), p=P(axis_name, None),
                mass=mass_spec,
                log_weight=P(axis_name)),
            potential_energy=P(axis_name),
            grad=P(axis_name, None))
    return jax.tree_util.tree_map(dim0_spec, tree)


def build_sharded_hmc_step(kernel: HMCKernel, mesh: Mesh,
                           state_example: HMCState,
                           axis_name: str = WALKER_AXIS):
    """Wrap ``kernel.step`` in shard_map over the walker axis.

    Returns a jitted ``step(key, state, step_size) -> (state', info, stats)``
    where ``key`` is a single replicated key (each shard folds in its mesh
    position for an independent stream) and ``stats`` is a dict of
    ensemble-level scalars pmean-reduced across all devices (the psum-shaped
    metric reductions SURVEY.md §5 calls for).
    """
    num_walkers = state_example.ensemble.q.shape[0]
    state_specs = _specs_like(state_example, num_walkers, axis_name)
    info_specs = HMCInfo(
        accept_prob=P(axis_name),
        accepted=P(axis_name),
        energy_error=P(axis_name),
        divergent=P(axis_name),
        potential_energy=P(axis_name),
        step_size=P(),
    )

    def local_step(key, state, step_size):
        idx = jax.lax.axis_index(axis_name)
        key = jax.random.fold_in(key, idx)
        new_state, info = kernel.step(key, state, step_size)
        stats = {
            "accept_rate": jax.lax.pmean(
                jnp.mean(info.accept_prob), axis_name),
            "divergence_rate": jax.lax.pmean(
                jnp.mean(info.divergent.astype(jnp.float32)), axis_name),
            "mean_potential_energy": jax.lax.pmean(
                jnp.mean(info.potential_energy), axis_name),
        }
        return new_state, info, stats

    sharded = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(), state_specs, P()),
        out_specs=(state_specs, info_specs, P()),
        # the specs above are the full contract (a pallas_call inside the
        # kernel carries no varying-mesh-axes annotation to check)
        check_vma=False,
    )

    @jax.jit
    def step(key, state, step_size):
        return sharded(key, state, jnp.asarray(step_size))

    # the un-jitted shard_map callable, for composing into larger jitted
    # programs (e.g. a lax.scan over transitions)
    step.inner = sharded  # type: ignore[attr-defined]
    return step


def shard_map_kernel(kernel: HMCKernel, mesh: Mesh,
                     axis_name: str = WALKER_AXIS) -> HMCKernel:
    """Wrap a built HMC kernel so its transition runs INSIDE
    ``jax.shard_map`` over the walker axis: each device runs the kernel
    unpartitioned on its own walker block (the composition a
    ``pallas_call``, which GSPMD cannot partition, needs to run on a
    mesh).

    The returned kernel has the standard ``step(key, state, step_size)``
    interface, so it drops straight into :func:`~..hmc.run_hmc`'s warmup
    and sampling scans: ensemble-mean adaptation statistics are computed
    by the driver OUTSIDE the shard_map on the (sharded) global info
    arrays, where XLA inserts the scalar cross-device reductions — the
    same one-all-reduce-per-transition census as the GSPMD path
    (BASELINE.md collective census). Each shard folds its mesh position
    into the step key for an independent RNG stream.

    ``init`` places positions with the walker sharding before delegating,
    so the initial (u, g) evaluation is sharded too.
    """
    _sharded_cache: dict = {}

    def _sharded_for(state):
        num_walkers = state.ensemble.q.shape[0]
        mass_ndim = jnp.asarray(state.ensemble.mass).ndim
        ck = (num_walkers, state.ensemble.q.shape[-1], mass_ndim)
        hit = _sharded_cache.get(ck)
        if hit is not None:
            return hit
        state_specs = _specs_like(state, num_walkers, axis_name)
        info_specs = HMCInfo(
            accept_prob=P(axis_name), accepted=P(axis_name),
            energy_error=P(axis_name), divergent=P(axis_name),
            potential_energy=P(axis_name), step_size=P())

        def local_step(key, st, eps):
            idx = jax.lax.axis_index(axis_name)
            return kernel.step(jax.random.fold_in(key, idx), st, eps)

        sharded = jax.shard_map(
            local_step, mesh=mesh,
            in_specs=(P(), state_specs, P()),
            out_specs=(state_specs, info_specs),
            check_vma=False)
        _sharded_cache[ck] = sharded
        return sharded

    from jax.sharding import NamedSharding

    def _globalize_state(state):
        """Re-place any process-local leaves (e.g. the scalar mass and
        the fresh log_weight zeros kernel.init creates eagerly) as
        GLOBAL arrays over the mesh — a multi-process shard_map rejects
        single-process-committed inputs. Leaves already spanning
        processes (q and everything GSPMD derived from it) are not
        fully addressable and pass through untouched."""
        num_walkers = state.ensemble.q.shape[0]
        specs = _specs_like(state, num_walkers, axis_name)

        def fix(x, spec):
            if not isinstance(x, jax.Array) \
                    or not x.sharding.is_fully_addressable:
                return x
            sh = NamedSharding(mesh, spec)
            if x.sharding.is_equivalent_to(sh, x.ndim):
                return x
            import numpy as onp
            xn = onp.asarray(x)
            return jax.make_array_from_callback(
                xn.shape, sh, lambda idx, xn=xn: xn[idx])

        return jax.tree_util.tree_map(fix, state, specs)

    def init(q, *, mass=1.0):
        q = jax.device_put(jnp.asarray(q), walker_sharding(mesh, 2))
        return _globalize_state(kernel.init(q, mass=mass))

    def _replicate(x):
        # Eager (non-traced) scalars arrive committed to the caller's
        # local default device, which a multi-process global mesh
        # rejects; rebuild them as mesh-replicated GLOBAL arrays from the
        # process-local value. Inside a jit trace the in_specs handle
        # placement.
        if isinstance(x, jax.core.Tracer):
            return x
        rep = NamedSharding(mesh, P())
        import numpy as onp
        if jnp.issubdtype(getattr(x, "dtype", jnp.float32),
                          jax.dtypes.prng_key):
            data = jax.make_array_from_process_local_data(
                rep, onp.asarray(jax.random.key_data(x)))
            return jax.random.wrap_key_data(data)
        return jax.make_array_from_process_local_data(rep, onp.asarray(x))

    def step(key, state, step_size):
        return _sharded_for(state)(
            _replicate(key), state, _replicate(jnp.asarray(step_size)))

    return HMCKernel(
        init=init, step=step, num_steps=kernel.num_steps,
        grad_evals_per_step=kernel.grad_evals_per_step,
        kind=kernel.kind + "+shard_map")


def sharded_run_hmc(key, potential_fn, init_q, *, mesh: Optional[Mesh] = None,
                    kernel: str = "auto", **run_kwargs):
    """The zero-ceremony multi-device surface: run :func:`~..hmc.run_hmc`
    with the ensemble sharded over the mesh's walker axis (the reference's
    planned multi-node HMC, reference manuals/SetUp.md:82-200). XLA
    partitions the ordinary scan engine (GSPMD); ``kernel`` takes "auto"
    or "xla". For the explicit shard_map composition pass
    ``run_hmc(..., kernel=shard_map_kernel(build_hmc_kernel(...), mesh))``.

    Matches the unsharded sampler's equilibrium statistics (parity tests
    in tests/test_parallel.py).
    """
    from ..hmc import require_xla_kernel, run_hmc
    from .mesh import make_walker_mesh

    require_xla_kernel(kernel, "sharded_run_hmc")
    if mesh is None:
        mesh = make_walker_mesh()
    init_q = jnp.asarray(init_q)
    if init_q.shape[0] % mesh.devices.size != 0:
        raise ValueError(
            f"num_walkers={init_q.shape[0]} must be divisible by the mesh "
            f"size {mesh.devices.size}")
    init_q = jax.device_put(init_q, walker_sharding(mesh, init_q.ndim))
    return run_hmc(key, potential_fn, init_q, kernel="xla", **run_kwargs)
