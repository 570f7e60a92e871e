"""Ring-parallel O(N^2) N-body forces over a device mesh.

The reference computes gravitational interactions body-by-body in Python
(reference potential.py:30-53 ``getAccelNBody``; MiscFunctions.py:51-78
``Accel``) and planned to distribute work with MPI point-to-point calls
(reference manuals/SetUp.md:82-200). The realisation here is the
blockwise-ring pattern (SURVEY.md §5 "long-context" analog): shard bodies
over a 1-D mesh axis, keep each device's block resident, and rotate
*partner* blocks around the ring with ``jax.lax.ppermute`` — the same
communication schedule as ring attention, applied to gravitational pairs.

Per ring step each device computes an ``[n_local, n_local]`` pairwise tile
(elementwise work that XLA fuses). After ``k = mesh size`` steps every
device has accumulated forces from all N bodies while only ever holding
``2 N/k`` positions, so memory per device is O(N/k) and the all-pairs
traffic is k-1 neighbour hops instead of an all-to-all.

Everything here is shape-static and jit-safe; mesh size 1 degenerates to
the dense computation.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..constants import Constants, NATURAL

Array = jax.Array

BODY_AXIS = "bodies"


def make_body_mesh(devices=None, axis_name: str = BODY_AXIS) -> Mesh:
    """1-D mesh over the body axis (distinct name from the walker axis so
    ensemble-of-systems runs can use a 2-D ``(walkers, bodies)`` mesh)."""
    import numpy as np
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def pad_bodies(x: Array, mass: Array, multiple: int,
               v: Optional[Array] = None):
    """Pad bodies with zero-mass particles at +inf-free sentinel positions
    so N divides the mesh size. Zero-mass sources exert no force; padded
    *targets* receive garbage accelerations the caller discards. Returns
    ``(x_pad, mass_pad[, v_pad], n_original)``.

    Sentinels are spread on a distant line (1e6 * max|x| + index) so padded
    bodies neither coincide with each other nor with real bodies (coincident
    points would produce 0 * inf = nan even at zero mass).
    """
    n = x.shape[0]
    n_pad = -(-n // multiple) * multiple
    extra = n_pad - n
    if extra == 0:
        out = (x, mass) if v is None else (x, mass, v)
        return (*out, n)
    scale = 1e6 * (1.0 + jnp.max(jnp.abs(x)))
    sent = jnp.zeros((extra, x.shape[1]), x.dtype)
    sent = sent.at[:, 0].set(
        scale * (1.0 + jnp.arange(extra, dtype=x.dtype)))
    x_pad = jnp.concatenate([x, sent], axis=0)
    mass_pad = jnp.concatenate(
        [mass, jnp.zeros((extra,), mass.dtype)], axis=0)
    if v is None:
        return x_pad, mass_pad, n
    v_pad = jnp.concatenate(
        [v, jnp.zeros((extra, v.shape[1]), v.dtype)], axis=0)
    return x_pad, mass_pad, v_pad, n


def _block_accel(xi, xj, mj, *, soft2, mask_self: bool):
    """Acceleration on each body of block i from all bodies of block j.

    xi: [ni, D] targets; xj: [nj, D], mj: [nj] sources. ``mask_self``
    statically marks the s == 0 ring step, where block j IS block i and the
    diagonal must drop out (reference masks via np.delete, potential.py:44;
    here a static eye mask keeps shapes fixed).
    """
    dr = xj[None, :, :] - xi[:, None, :]            # [ni, nj, D]
    r2 = jnp.sum(dr * dr, axis=-1) + soft2          # [ni, nj]
    zero = r2 <= 0.0
    if mask_self:
        zero = zero | jnp.eye(xi.shape[0], dtype=bool)
    inv_r3 = jnp.where(zero, 0.0,
                       jax.lax.rsqrt(jnp.where(zero, 1.0, r2)) ** 3)
    w = mj[None, :] * inv_r3                        # [ni, nj]
    return jnp.einsum("ij,ijd->id", w, dr)


def _block_pot(xi, mi, xj, mj, *, soft2, mask_self: bool):
    """sum_{i in blk_i, j in blk_j} m_i m_j / r_ij (each ordered pair once)."""
    dr = xj[None, :, :] - xi[:, None, :]
    r2 = jnp.sum(dr * dr, axis=-1) + soft2
    zero = r2 <= 0.0
    if mask_self:
        zero = zero | jnp.eye(xi.shape[0], dtype=bool)
    inv_r = jnp.where(zero, 0.0,
                      jax.lax.rsqrt(jnp.where(zero, 1.0, r2)))
    return jnp.sum((mi[:, None] * mj[None, :]) * inv_r)


def _ring_sweep(x_blk, m_blk, *, axis_name, mesh_size, soft2, want_pot):
    """One full ring pass: accumulate local accelerations (and optionally
    the potential-energy partial sum) from all ``mesh_size`` blocks."""
    acc = jnp.zeros_like(x_blk)
    pot = jnp.zeros((), x_blk.dtype)
    xj, mj = x_blk, m_blk
    perm = [(j, (j - 1) % mesh_size) for j in range(mesh_size)]
    for s in range(mesh_size):
        acc = acc + _block_accel(
            x_blk, xj, mj, soft2=soft2, mask_self=(s == 0))
        if want_pot:
            pot = pot + _block_pot(
                x_blk, m_blk, xj, mj, soft2=soft2, mask_self=(s == 0))
        if s + 1 < mesh_size:
            # rotate partner block one hop around the ring; XLA overlaps
            # this transfer with the next tile's compute
            xj = jax.lax.ppermute(xj, axis_name, perm)
            mj = jax.lax.ppermute(mj, axis_name, perm)
    return acc, pot


def _body_specs(mesh: Mesh, axis_name: str):
    return P(axis_name, None), P(axis_name)


@partial(jax.jit, static_argnames=("mesh", "axis_name", "constants",
                                   "softening"))
def ring_nbody_accelerations(
    x: Array,
    mass: Array,
    *,
    mesh: Mesh,
    axis_name: str = BODY_AXIS,
    constants: Constants = NATURAL,
    softening: float = 0.0,
) -> Array:
    """Distributed ``a_i = G sum_{j != i} m_j r_ij / |r_ij|^3`` with bodies
    sharded over ``axis_name``; bitwise-stable partner order (every device
    accumulates blocks in ring order starting from its own).

    ``x: [N, D]``, ``mass: [N]``; N must divide the mesh size (see
    :func:`pad_bodies`). Matches ``ops.potentials.nbody_accelerations`` to
    float tolerance (tested on the virtual 8-device mesh).
    """
    k = mesh.shape[axis_name]
    if x.shape[0] % k != 0:
        raise ValueError(
            f"num_bodies={x.shape[0]} must divide the mesh size {k}; "
            f"pad with pad_bodies()")
    soft2 = float(softening) ** 2
    g = constants.G

    def local(x_blk, m_blk):
        acc, _ = _ring_sweep(
            x_blk, m_blk, axis_name=axis_name, mesh_size=k,
            soft2=soft2, want_pot=False)
        return g * acc

    xs, ms = _body_specs(mesh, axis_name)
    return jax.shard_map(
        local, mesh=mesh, in_specs=(xs, ms), out_specs=xs)(x, mass)


@partial(jax.jit, static_argnames=("mesh", "axis_name", "constants",
                                   "softening"))
def ring_nbody_potential_energy(
    x: Array,
    mass: Array,
    *,
    mesh: Mesh,
    axis_name: str = BODY_AXIS,
    constants: Constants = NATURAL,
    softening: float = 0.0,
) -> Array:
    """Distributed total gravitational energy ``-G sum_{i<j} m_i m_j / r``
    (sign fixed vs reference potential.py:69 — SURVEY.md §7). Each ordered
    pair is counted once on its target-owner device; the psum of partials
    times 1/2 gives the unordered-pair sum, replicated on every device."""
    k = mesh.shape[axis_name]
    if x.shape[0] % k != 0:
        raise ValueError(
            f"num_bodies={x.shape[0]} must divide the mesh size {k}")
    soft2 = float(softening) ** 2
    g = constants.G

    def local(x_blk, m_blk):
        _, pot = _ring_sweep(
            x_blk, m_blk, axis_name=axis_name, mesh_size=k,
            soft2=soft2, want_pot=True)
        return -0.5 * g * jax.lax.psum(pot, axis_name)

    xs, ms = _body_specs(mesh, axis_name)
    return jax.shard_map(
        local, mesh=mesh, in_specs=(xs, ms), out_specs=P())(x, mass)


@partial(jax.jit, static_argnames=(
    "num_steps", "save_every", "mesh", "axis_name", "constants",
    "softening"))
def ring_simulate(
    x: Array,
    v: Array,
    mass: Array,
    dt,
    *,
    num_steps: int,
    mesh: Mesh,
    save_every: int = 1,
    axis_name: str = BODY_AXIS,
    constants: Constants = NATURAL,
    softening: float = 0.0,
):
    """Velocity-Verlet N-body trajectory with ring forces, the WHOLE run one
    jitted shard_map: the ``lax.scan`` over steps lives *inside* the sharded
    region, so positions/velocities never leave their device between steps
    and each step costs exactly k-1 neighbor ppermutes.

    Returns ``(x_final, v_final, energies[num_steps // save_every])`` with
    energies = on-device total-energy diagnostics (the reference's
    energy-drift oracle, NBody.py:68-77), replicated scalars.
    """
    if num_steps % save_every != 0:
        raise ValueError("num_steps must divide save_every")
    k = mesh.shape[axis_name]
    if x.shape[0] % k != 0:
        raise ValueError(
            f"num_bodies={x.shape[0]} must divide the mesh size {k}")
    soft2 = float(softening) ** 2
    g = constants.G
    dt = jnp.asarray(dt, x.dtype)

    def local(x_blk, v_blk, m_blk):
        def accel(xb):
            a, _ = _ring_sweep(
                xb, m_blk, axis_name=axis_name, mesh_size=k,
                soft2=soft2, want_pot=False)
            return g * a

        def energy(xb, vb):
            a_unused, pot = _ring_sweep(
                xb, m_blk, axis_name=axis_name, mesh_size=k,
                soft2=soft2, want_pot=True)
            kin = 0.5 * jnp.sum(m_blk * jnp.sum(vb * vb, axis=-1))
            return (jax.lax.psum(kin, axis_name)
                    - 0.5 * g * jax.lax.psum(pot, axis_name))

        def one_step(carry, _):
            xb, vb, ab = carry
            # velocity Verlet: reuse the previous step's acceleration so
            # each step costs ONE ring sweep, not two
            vh = vb + 0.5 * dt * ab
            xb2 = xb + dt * vh
            ab2 = accel(xb2)
            vb2 = vh + 0.5 * dt * ab2
            return (xb2, vb2, ab2), None

        def save_block(carry, _):
            carry, _ = jax.lax.scan(
                one_step, carry, None, length=save_every)
            xb, vb, _ = carry
            return carry, energy(xb, vb)

        a0 = accel(x_blk)
        (xb, vb, _), es = jax.lax.scan(
            save_block, (x_blk, v_blk, a0), None,
            length=num_steps // save_every)
        return xb, vb, es

    xs, ms = _body_specs(mesh, axis_name)
    return jax.shard_map(
        local, mesh=mesh, in_specs=(xs, xs, ms),
        out_specs=(xs, xs, P()))(x, v, mass)
