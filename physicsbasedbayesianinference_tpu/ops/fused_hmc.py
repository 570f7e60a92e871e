"""Fused HMC transition for the GPU: one Pallas kernel on the Triton route.

The XLA engine (``hmc.build_hmc_kernel``) runs a trajectory as a
``lax.scan`` whose carry ``(q, p, grad, U)`` goes through device memory on
every leapfrog step. Here each program of the kernel takes one block of
walkers and runs the whole L-step kick-drift-kick trajectory, the
Metropolis test and the accept-select in registers, so a transition reads
and writes each ``[W, D]`` array once. Inside the trajectory only the
gradient is evaluated; the potential's value is computed once, at the
endpoint, where the Metropolis test needs it.

Randomness stays outside the kernel: the caller draws the momenta and the
Metropolis log-uniforms with ``jax.random`` exactly as the XLA step does
and passes them in, so both engines take the same decisions walker by
walker (up to float32 reduction order).

The potential's jaxpr is evaluated inside the kernel. Its captured
constants (a design matrix, labels) become whole-array kernel inputs, so a
``q @ x.T`` in the potential becomes a ``pl.dot`` on the tensor cores.
The Triton route lowers a fixed set of primitives and only power-of-two
shapes; :func:`check_lowerable` names what it cannot lower when the
kernel is built, so a caller never falls back silently.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
from jax._src.interpreters import partial_eval as pe
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

Array = jax.Array

# Walkers per program and warps per program, chosen by measurement on the
# card (chip_smoke.py --sweep; PERF.md); not user options. Read when a
# transition is built.
BLOCK_WALKERS = 16
NUM_WARPS = 4


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def _sub_jaxprs(params):
    for v in params.values():
        if isinstance(v, jax.extend.core.ClosedJaxpr):
            yield v.jaxpr
        elif isinstance(v, jax.extend.core.Jaxpr):
            yield v
        elif isinstance(v, (tuple, list)):
            for x in v:
                if isinstance(x, jax.extend.core.ClosedJaxpr):
                    yield x.jaxpr
                elif isinstance(x, jax.extend.core.Jaxpr):
                    yield x


def check_lowerable(closed) -> None:
    """Raise ``ValueError`` naming the first primitive or shape of the
    potential's jaxpr that the Pallas Triton route cannot lower."""
    from jax._src.pallas.triton.lowering import triton_lowering_rules

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive not in triton_lowering_rules:
                raise ValueError(
                    f"kernel='fused': the potential uses primitive "
                    f"{eqn.primitive.name!r}, which the Pallas Triton route "
                    f"cannot lower; use kernel='xla'")
            for var in list(eqn.invars) + list(eqn.outvars):
                shape = getattr(var.aval, "shape", ())
                size = 1
                for n in shape:
                    size *= n
                if not _is_pow2(size):
                    raise ValueError(
                        f"kernel='fused': the potential's {eqn.primitive.name}"
                        f" has an operand of shape {tuple(shape)}; the Pallas"
                        f" Triton route needs power-of-two sizes; use "
                        f"kernel='xla'")
            for sub in _sub_jaxprs(eqn.params):
                walk(sub)

    walk(closed.jaxpr)


def trace_potential(vg_fn: Callable, block_walkers: int, num_dims: int,
                    dtype=jnp.float32):
    """The potential's value-and-grad jaxpr at one block's shape."""
    example = jax.ShapeDtypeStruct((block_walkers, num_dims), dtype)
    return jax.make_jaxpr(vg_fn)(example)


def make_fused_transition(
    vg_fn: Callable,
    *,
    num_dims: int,
    num_steps: int,
    divergence_threshold: float = 1000.0,
    interpret: bool = False,
):
    """Build ``transition(q, u, g, p0, log_u, mass, step_size, beta) ->
    (q', p', u', g', accept_prob, accepted, energy_error)``.

    ``p0`` are the refreshed momenta and ``log_u`` the Metropolis
    log-uniforms, both drawn by the caller. ``mass`` is the diagonal metric
    broadcastable to ``[D]``. The result follows ``hmc.build_hmc_kernel``'s
    step: proposal momenta are flipped, a rejected walker keeps ``q``, ``U``
    and ``grad`` and takes ``p0``.

    ``interpret=True`` runs the kernel under the Pallas interpreter (tests
    on the CPU); otherwise it is compiled for the GPU.
    """
    if not _is_pow2(num_dims):
        raise ValueError(
            f"kernel='fused' needs a power-of-two number of dimensions on "
            f"the Pallas Triton route; got D={num_dims}; use kernel='xla'")
    bw, num_warps = BLOCK_WALKERS, NUM_WARPS
    closed = trace_potential(vg_fn, bw, num_dims)
    check_lowerable(closed)
    # the same jaxpr cut down to the value alone and to the gradient alone
    value_jaxpr, _ = pe.dce_jaxpr(closed.jaxpr, [True, False])
    grad_jaxpr, _ = pe.dce_jaxpr(closed.jaxpr, [False, True])
    consts = [jnp.asarray(c) for c in closed.consts]
    const_shapes = [c.shape for c in consts]
    # 0-d constants travel as [1] arrays and are reshaped back in-kernel
    const_inputs = [c.reshape(1) if c.ndim == 0 else c for c in consts]
    for c in const_inputs:
        if not all(_is_pow2(n) for n in c.shape):
            raise ValueError(
                f"kernel='fused': the potential captures an array of shape "
                f"{c.shape}; the Pallas Triton route needs power-of-two "
                f"dimensions; use kernel='xla'")
    n_consts = len(const_inputs)
    d = num_dims

    def kernel(sc_ref, q_ref, p_ref, g_ref, u_ref, lu_ref, m_ref, *rest):
        const_refs, outs = rest[:n_consts], rest[n_consts:]
        q_out, p_out, g_out, u_out, acc_out, taken_out, err_out = outs
        cvals = [r[...].reshape(s) for r, s in zip(const_refs, const_shapes)]

        def value(q):
            return jax.core.eval_jaxpr(value_jaxpr, cvals, q)[0]

        def grad(q):
            return jax.core.eval_jaxpr(grad_jaxpr, cvals, q)[0]

        dt = sc_ref[0]
        beta = sc_ref[1]
        mass = m_ref[...][None, :]
        inv_mass = 1.0 / mass
        q0, p0, g0, u0 = q_ref[...], p_ref[...], g_ref[...], u_ref[...]
        half = 0.5 * dt

        def body(_, carry):
            q, p, g = carry
            p = p - half * g
            q = q + dt * p * inv_mass
            g = grad(q)
            p = p - half * g
            return q, p, g

        q1, p1, g1 = jax.lax.fori_loop(0, num_steps, body, (q0, p0, g0))
        u1 = value(q1)
        p1 = -p1
        h0 = 0.5 * jnp.sum(p0 * p0 / mass, axis=1) + u0
        h1 = 0.5 * jnp.sum(p1 * p1 / mass, axis=1) + u1
        err = beta * (h1 - h0)
        err = jnp.where(jnp.isfinite(err), err, jnp.inf)
        divergent = err > divergence_threshold
        accepted = (lu_ref[...] < -err) & ~divergent
        sel = accepted[:, None]
        q_out[...] = jnp.where(sel, q1, q0)
        p_out[...] = jnp.where(sel, p1, p0)
        g_out[...] = jnp.where(sel, g1, g0)
        u_out[...] = jnp.where(accepted, u1, u0)
        acc_out[...] = jnp.where(
            divergent, 0.0, jnp.exp(jnp.minimum(0.0, -err)))
        taken_out[...] = accepted.astype(jnp.float32)
        err_out[...] = err

    rows = pl.BlockSpec((bw, d), lambda i: (i, 0))
    vec = pl.BlockSpec((bw,), lambda i: (i,))
    whole = lambda shape: pl.BlockSpec(shape, lambda i: (0,) * len(shape))

    @functools.partial(jax.named_call, name="fused_hmc_transition")
    def transition(q, u, g, p0, log_u, mass, step_size, beta):
        w = q.shape[0]
        if q.shape[1] != d:
            raise ValueError(f"built for D={d}; got positions {q.shape}")
        dtype = q.dtype
        w_pad = -(-w // bw) * bw
        pad = w_pad - w

        def padw(x):
            return x if pad == 0 else jnp.pad(
                x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))

        mass_row = jnp.broadcast_to(jnp.asarray(mass, dtype), (d,))
        scalars = jnp.stack([jnp.asarray(step_size, dtype),
                             jnp.asarray(beta, dtype)])
        mat = jax.ShapeDtypeStruct((w_pad, d), dtype)
        col = jax.ShapeDtypeStruct((w_pad,), dtype)
        out = pl.pallas_call(
            kernel,
            grid=(w_pad // bw,),
            in_specs=[whole((2,)), rows, rows, rows, vec, vec, whole((d,))]
            + [whole(c.shape) for c in const_inputs],
            out_specs=[rows, rows, rows, vec, vec, vec, vec],
            out_shape=[mat, mat, mat, col, col, col, col],
            compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                                 num_stages=1),
            interpret=interpret,
            backend="triton",
            name="fused_hmc_transition",
        )(scalars, padw(q), padw(p0), padw(g), padw(u), padw(log_u),
          mass_row, *const_inputs)
        q1, p1, g1, u1, acc, taken, err = (x[:w] for x in out)
        return q1, p1, u1, g1, acc, taken > 0.5, err

    return transition
