"""Parallel tempering (replica exchange) over physical temperatures.

The reference frames HMC as statistical mechanics — walkers at a physical
temperature with Maxwell-Boltzmann momenta (reference README.md:6-9,
ensemble.py:78-93) — and plans tempered-ensemble methods (reference
references/PhysicsBasedHMC_SoHPC2022_WeekPlan.md:39; the Boltzmann weights
of references/NotesOnParticleBasedHMC.pdf eq. 1). :mod:`.smc` anneals one
ensemble through a temperature ladder *sequentially*; this module runs the
whole ladder *simultaneously*: R replicas of the walker ensemble at
temperatures ``T_r = T / beta_r`` evolve side by side, and adjacent
replicas periodically exchange configurations with the Metropolis rule

    P(swap a<->b) = min(1, exp((beta_a - beta_b) (U(q_a) - U(q_b)))) ,

so cold chains inherit the hot chains' mode-hopping. This is the standard
replica-exchange construction (Swendsen & Wang 1986; Earl & Deem 2005).

Design:

* the replica axis is a ``vmap`` — one compiled transition advances all
  R x W walkers; trajectories for every replica run in the same fused
  program with per-replica step sizes;
* swaps are per-walker and elementwise across the (small, replicated)
  replica axis: a gather by a static partner permutation + ``jnp.where``.
  Even/odd pair phases alternate per transition (deterministic-even-odd
  scheme, which mixes faster than random pair choice);
* walker-axis sharding passes straight through: nothing here communicates
  across walkers, so the GSPMD walker partitioning of :mod:`.parallel`
  applies unchanged and swaps stay device-local.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from .adaptation import da_init, da_update
from .constants import Constants, NATURAL
from .ensemble import thermal_momentum_std
from .hmc import require_xla_kernel
from .ops.integrators import get_integrator
from .ops.potentials import batched_value_and_grad

Array = jax.Array


def geometric_ladder(num_replicas: int, beta_min: float = 0.05,
                     dtype=jnp.float32) -> Array:
    """Inverse-temperature ladder ``[1, ..., beta_min]`` with geometric
    spacing — the standard choice: swap acceptance between neighbors is
    roughly uniform when log-beta is evenly spaced (Earl & Deem 2005)."""
    if num_replicas < 1:
        raise ValueError("need at least one replica")
    if num_replicas == 1:
        return jnp.ones((1,), dtype)
    expo = jnp.arange(num_replicas, dtype=dtype) / (num_replicas - 1)
    return jnp.asarray(beta_min, dtype) ** expo


def _partner_tables(num_replicas: int) -> tuple[np.ndarray, np.ndarray]:
    """Static even/odd adjacent-pair partner permutations.

    even: (0,1)(2,3)...; odd: (1,2)(3,4)... Unpaired replicas map to
    themselves (the swap mask excludes them).
    """
    even = np.arange(num_replicas)
    for a in range(0, num_replicas - 1, 2):
        even[a], even[a + 1] = a + 1, a
    odd = np.arange(num_replicas)
    for a in range(1, num_replicas - 1, 2):
        odd[a], odd[a + 1] = a + 1, a
    return even, odd


def build_pt_transition(
    potential_fn: Callable[[Array], Array],
    *,
    betas: Array,
    num_steps: int = 10,
    integrator: str = "leapfrog",
    mass: Union[float, Array] = 1.0,
    temperature: Union[float, Array] = 1.0,
    constants: Constants = NATURAL,
    kernel: str = "auto",
    dtype=jnp.float32,
):
    """Build the replica-exchange transition as a standalone jittable
    kernel (shared by :func:`run_parallel_tempering` and the CLI's
    checkpointed PT driver, main._checkpointed_run):

        transition(key, q[R,W,D], u[R,W], g[R,W,D], step_sizes[R], i)
            -> (q, u, g, accept[R], swap_rate[R])

    with ``i`` the transition counter selecting the even/odd swap phase.

    ``kernel``: "auto" or "xla" (the replica sweeps run the XLA scan
    integrator); anything else raises ``ValueError``.

    Returns ``(transition, vg)``.
    """
    require_xla_kernel(kernel, "parallel tempering")
    betas = jnp.asarray(betas, dtype)
    num_replicas = betas.shape[0]
    integ = get_integrator(integrator)
    vg = batched_value_and_grad(potential_fn)
    base_beta = constants.beta(temperature)          # 1/(k_B T)
    beta_eff = base_beta * betas                     # [R]
    mass = jnp.asarray(mass, dtype)

    even_np, odd_np = _partner_tables(num_replicas)
    partner_even = jnp.asarray(even_np, jnp.int32)
    partner_odd = jnp.asarray(odd_np, jnp.int32)
    r_idx = jnp.arange(num_replicas, dtype=jnp.int32)

    def replica_step(key, q, u, g, beta_e, step_size):
        """One HMC transition at effective inverse temperature ``beta_e =
        base_beta * beta_r``: unscaled potential, momenta thermalised at
        T_r (std ``sqrt(m / beta_e)``), accept with ``exp(-beta_e dH)`` —
        the physically-consistent tempering of hmc.py (docstring there)."""
        k_mom, k_acc = jax.random.split(key)
        p_std = thermal_momentum_std(mass, 1.0, NATURAL) / jnp.sqrt(beta_e)
        p0 = p_std * jax.random.normal(k_mom, q.shape, dtype=dtype)
        inv_mass = 1.0 / mass
        q1, p1, u1, g1 = integ(
            vg, q, p0, step_size=step_size, num_steps=num_steps,
            inv_mass=inv_mass, grad=g, potential_energy=u)
        h0 = 0.5 * jnp.sum(p0 * p0 * inv_mass, axis=-1) + u
        h1 = 0.5 * jnp.sum(p1 * p1 * inv_mass, axis=-1) + u1
        derr = beta_e * (h1 - h0)
        derr = jnp.where(jnp.isfinite(derr), derr, jnp.inf)
        log_uni = jnp.log(jax.random.uniform(
            k_acc, derr.shape, dtype=dtype,
            minval=jnp.finfo(dtype).tiny))
        acc = log_uni < -derr
        sel = acc[:, None]
        return (jnp.where(sel, q1, q), jnp.where(acc, u1, u),
                jnp.where(sel, g1, g),
                jnp.mean(jnp.exp(jnp.minimum(0.0, -derr))))

    v_step = jax.vmap(replica_step, in_axes=(0, 0, 0, 0, 0, 0))

    def hmc_phase(key, q, u, g, step_sizes):
        return v_step(jax.random.split(key, num_replicas), q, u, g,
                      beta_eff, step_sizes)

    def swap_phase(key, q, u, g, parity):
        num_walkers = q.shape[1]
        partner = jnp.where(parity == 0, partner_even, partner_odd)
        # symmetric pair statistic: both members see the same delta/uniform
        delta = ((beta_eff - beta_eff[partner])[:, None]
                 * (u - u[partner]))                        # [R, W]
        log_uni = jnp.log(jax.random.uniform(
            key, (num_replicas, num_walkers), dtype=dtype,
            minval=jnp.finfo(dtype).tiny))
        pair_rep = jnp.minimum(r_idx, partner)
        log_uni = log_uni[pair_rep]
        do = (log_uni < delta) & (partner != r_idx)[:, None]
        sel = do[:, :, None]
        q = jnp.where(sel, q[partner], q)
        u = jnp.where(do, u[partner], u)
        g = jnp.where(sel, g[partner], g)
        return q, u, g, jnp.mean(do.astype(dtype), axis=1)

    def transition(key, q, u, g, step_sizes, i):
        k_hmc, k_swap = jax.random.split(key)
        q, u, g, acc = hmc_phase(k_hmc, q, u, g, step_sizes)
        q, u, g, swaps = swap_phase(k_swap, q, u, g, i % 2)
        return q, u, g, acc, swaps

    return transition, vg


@dataclasses.dataclass
class PTResult:
    """Output of :func:`run_parallel_tempering`."""

    samples: Optional[Array]       # [S, W, D] cold-replica draws
    q: Array                       # [R, W, D] final replica positions
    accept_rate: Array             # [R] per-replica HMC acceptance
    swap_rate: Array               # [R] fraction of accepted swaps per slot
    step_sizes: Array              # [R] adapted per-replica step sizes
    betas: Array                   # [R] the ladder used
    mean: Optional[Array] = None   # [D] cold-replica streaming moments
    var: Optional[Array] = None
    kernel_used: str = "xla"       # HMC engine: the XLA scan integrator


def run_parallel_tempering(
    key: Array,
    potential_fn: Callable[[Array], Array],
    init_q: Array,
    *,
    num_replicas: int = 8,
    betas: Optional[Array] = None,
    beta_min: float = 0.05,
    num_warmup: int = 200,
    num_samples: int = 500,
    num_steps: int = 10,
    init_step_size: float = 0.2,
    target_accept: float = 0.8,
    integrator: str = "leapfrog",
    mass: Union[float, Array] = 1.0,
    temperature: Union[float, Array] = 1.0,
    constants: Constants = NATURAL,
    collect: str = "samples",
    kernel: str = "auto",
) -> PTResult:
    """Replica-exchange ensemble HMC.

    ``init_q``: ``[W, D]`` (broadcast to every replica) or ``[R, W, D]``.
    The cold replica (``betas[0]``, default 1) targets
    ``exp(-U/(k_B T))``; hot replicas flatten the target and feed
    decorrelated states down the ladder through swaps. Samples/moments are
    collected from the cold replica only.

    Per-replica step sizes adapt by dual averaging during warmup (hot
    replicas want larger steps); swaps run during warmup too.

    ``kernel``: "auto" or "xla" — see :func:`build_pt_transition`.
    """
    if collect not in ("samples", "moments", "none"):
        raise ValueError(f"bad collect={collect!r}")
    init_q = jnp.asarray(init_q)
    if betas is None:
        betas = geometric_ladder(num_replicas, beta_min, init_q.dtype)
    betas = jnp.asarray(betas, init_q.dtype)
    num_replicas = betas.shape[0]
    if init_q.ndim == 2:
        init_q = jnp.broadcast_to(
            init_q, (num_replicas,) + init_q.shape)
    if init_q.shape[0] != num_replicas:
        raise ValueError(
            f"init_q leading axis {init_q.shape[0]} != R={num_replicas}")
    _, num_walkers, num_dims = init_q.shape
    dtype = init_q.dtype

    transition, vg = build_pt_transition(
        potential_fn, betas=betas, num_steps=num_steps,
        integrator=integrator, mass=mass, temperature=temperature,
        constants=constants, kernel=kernel, dtype=dtype)

    u0, g0 = jax.vmap(vg)(init_q)

    # ---- warmup: per-replica dual averaging --------------------------------
    key, k_warm, k_sample = jax.random.split(key, 3)
    step_sizes = jnp.full((num_replicas,), init_step_size, dtype)
    if num_warmup > 0:
        v_da_update = jax.vmap(
            lambda st, a: da_update(st, a, target=target_accept))

        @jax.jit
        def warmup(q, u, g, keys):
            da = da_init(jnp.full((num_replicas,), init_step_size, dtype))

            def body(carry, ki):
                q, u, g, da, i = carry
                q, u, g, acc, _ = transition(
                    ki, q, u, g, jnp.exp(da.log_step), i)
                da = v_da_update(da, acc)
                return (q, u, g, da, i + 1), None

            (q, u, g, da, _), _ = jax.lax.scan(
                body, (q, u, g, da, jnp.asarray(0)), keys)
            return q, u, g, jnp.exp(da.log_avg_step)

        q, u0, g0, step_sizes = warmup(
            init_q, u0, g0, jax.random.split(k_warm, num_warmup))
    else:
        q = init_q

    # ---- sampling -----------------------------------------------------------
    @jax.jit
    def sample(q, u, g, keys):
        def body(carry, ki):
            q, u, g, mean, m2, n, i = carry
            q, u, g, acc, swaps = transition(ki, q, u, g, step_sizes, i)
            out = {}
            if collect == "samples":
                out["q"] = q[0]
            elif collect == "moments":
                cold = q[0]
                w = cold.shape[0]
                n_new = n + w
                bm = jnp.mean(cold, axis=0)
                delta = bm - mean
                mean = mean + delta * (w / n_new)
                m2 = m2 + jnp.sum((cold - bm) ** 2, axis=0) \
                    + delta**2 * (n * w / n_new)
                n = n_new
            return (q, u, g, mean, m2, n, i + 1), (out, acc, swaps)

        mean0 = jnp.zeros((num_dims,), dtype)
        m2_0 = jnp.zeros((num_dims,), dtype)
        (q, u, g, mean, m2, n, _), (outs, accs, swapss) = jax.lax.scan(
            body, (q, u, g, mean0, m2_0, jnp.zeros((), dtype),
                   jnp.asarray(0)), keys)
        return q, mean, m2, n, outs, accs, swapss

    q, mean, m2, n, outs, accs, swapss = sample(
        q, u0, g0, jax.random.split(k_sample, num_samples))

    samples = outs.get("q") if collect == "samples" else None
    post_mean = post_var = None
    if collect == "moments":
        post_mean = mean
        post_var = m2 / jnp.maximum(n - 1.0, 1.0)

    return PTResult(
        samples=samples,
        q=q,
        accept_rate=jnp.mean(accs, axis=0),
        swap_rate=jnp.mean(swapss, axis=0),
        step_sizes=step_sizes,
        betas=betas,
        mean=post_mean,
        var=post_var,
    )
