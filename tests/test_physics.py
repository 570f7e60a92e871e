"""Physics-layer tests. The reference validates its integrators by
eyeballing plots (energy drift NBody.py:68-77, Kepler invariants
Integrators2B.py:115-137, solar-system orbits test_integrator_solar_system);
here the same three oracle families are automated tolerance asserts
(SURVEY.md §4 implications)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest


@pytest.fixture(autouse=True)
def _x64():
    """Physics-mode oracles need float64 (the reference runs numpy f64
    throughout); restore f32 afterwards so sampler tests stay float32."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)

from physicsbasedbayesianinference_tpu import physics
from physicsbasedbayesianinference_tpu.constants import NATURAL
from physicsbasedbayesianinference_tpu.ops.potentials import (
    nbody_potential_energy,
)


def _kepler():
    sys_, const = physics.kepler_two_body(eccentricity=0.5, dtype=jnp.float64)
    return sys_, const


# ---------------------------------------------------------------------------
# conserved quantities / invariants
# ---------------------------------------------------------------------------

def test_two_body_invariants_initial_values():
    sys_, const = _kepler()
    inv = physics.two_body_invariants(sys_, constants=const)
    np.testing.assert_allclose(float(inv["runge_lenz"]), 0.5, rtol=1e-6)
    np.testing.assert_allclose(float(inv["semi_major_axis"]), 1.0, rtol=1e-6)


@pytest.mark.parametrize("method,tol", [
    ("velocity_verlet", 1e-4),
    ("position_verlet", 1e-4),
    ("symplectic_euler", 2e-2),
    ("implicit_midpoint", 1e-4),
    ("rk4", 1e-8),
    ("hermite", 1e-7),
])
def test_energy_conservation_kepler(method, tol):
    """Symplectic/high-order methods keep |dE/E| bounded over 10 orbits."""
    sys_, const = _kepler()
    period = 2.0 * np.pi  # a=1, GM~1
    steps = 20_000
    dt = 10.0 * period / steps
    traj = physics.simulate_lib.simulate(
        sys_, dt, steps, method=method, save_every=500, constants=const)
    drift = physics.energy_drift(traj)
    assert float(jnp.max(drift)) < tol, float(jnp.max(drift))


def test_kepler_invariants_conserved():
    sys_, const = _kepler()
    steps = 8000
    dt = 2.0 * np.pi * 5.0 / steps
    traj = physics.simulate_lib.simulate(
        sys_, dt, steps, method="velocity_verlet", save_every=400,
        constants=const)
    final = traj.final
    inv = physics.two_body_invariants(final, constants=const)
    np.testing.assert_allclose(float(inv["runge_lenz"]), 0.5, atol=2e-3)
    np.testing.assert_allclose(float(inv["semi_major_axis"]), 1.0, atol=2e-3)
    # angular momentum is conserved to machine precision by symplectic maps
    inv0 = physics.two_body_invariants(sys_, constants=const)
    np.testing.assert_allclose(
        float(inv["angular_momentum"]), float(inv0["angular_momentum"]),
        rtol=1e-10)


def test_explicit_euler_drifts_more_than_verlet():
    """The negative control: EE energy error must dwarf velocity-Verlet's
    at the same step size (the comparison the reference's drift plots
    exist to show)."""
    sys_, const = _kepler()
    dt = 2.0 * np.pi / 2000
    ee = physics.simulate_lib.simulate(
        sys_, dt, 2000, method="explicit_euler", save_every=2000,
        constants=const)
    vv = physics.simulate_lib.simulate(
        sys_, dt, 2000, method="velocity_verlet", save_every=2000,
        constants=const)
    ee_drift = float(physics.energy_drift(ee)[-1])
    vv_drift = float(physics.energy_drift(vv)[-1])
    assert ee_drift > 50.0 * vv_drift, (ee_drift, vv_drift)


# ---------------------------------------------------------------------------
# order of accuracy (reference test_integrator_harmonic.plotError,
# qErrorVsStepSize.png — automated)
# ---------------------------------------------------------------------------

def _harmonic_error(method, dt, t_final=1.0):
    """Integrate a 1-'body' unit harmonic oscillator by treating a central
    spring as the acceleration field, vs the closed-form solution
    (reference test_integrator_harmonic.py:27-38)."""
    step = physics.get_physics_integrator(method)
    accel = lambda x: -x
    x = jnp.array([[1.0]], dtype=jnp.float64)
    v = jnp.array([[0.0]], dtype=jnp.float64)
    n = int(round(t_final / dt))

    def body(carry, _):
        x, v = carry
        if method == "hermite":
            x, v = step(accel, lambda x, v: -v, x, v, dt)
        else:
            x, v = step(accel, x, v, dt)
        return (x, v), None

    (x, v), _ = jax.lax.scan(body, (x, v), None, length=n)
    return abs(float(x[0, 0]) - np.cos(t_final))


@pytest.mark.parametrize("method,order", [
    ("explicit_euler", 1), ("symplectic_euler", 1),
    ("velocity_verlet", 2), ("position_verlet", 2),
    ("explicit_midpoint", 2), ("implicit_midpoint", 2),
    ("rk4", 4), ("hermite", 4),
])
def test_convergence_order(method, order):
    e1 = _harmonic_error(method, 0.02)
    e2 = _harmonic_error(method, 0.01)
    rate = np.log2(e1 / e2)
    assert rate > order - 0.5, (method, rate)


# ---------------------------------------------------------------------------
# solar system (reference test_integrator_solar_system.py oracle)
# ---------------------------------------------------------------------------

def test_earth_orbit_one_period():
    """Integrate Earth-Sun-Moon in AU units for one full orbital period
    and check Earth returns near its start (the closure the reference's
    orbit plots show). The reference's initial data (1.52e11 m, 29.8 km/s;
    test_integrator_solar_system.py:33-34) defines an orbit with
    a = 1.033 AU -> period ~383 d (not exactly 1 yr), computed here from
    vis-viva rather than assumed."""
    sys_, const = physics.solar_system(units="astro")
    sys_ = physics.center_of_mass_frame(sys_)
    # vis-viva for the Earth orbit: a = 1 / (2/r - v^2/GM)
    gm = const.G * float(jnp.sum(sys_.mass))
    r0 = float(jnp.linalg.norm(sys_.x[0] - sys_.x[1]))
    v0 = float(jnp.linalg.norm(sys_.v[0] - sys_.v[1]))
    a = 1.0 / (2.0 / r0 - v0 * v0 / gm)
    period = 2.0 * np.pi * np.sqrt(a**3 / gm)
    dt = 0.01  # days
    steps = int(period / dt)
    steps -= steps % 100
    traj = physics.simulate_lib.simulate(
        sys_, dt, steps, method="velocity_verlet", save_every=100,
        constants=const)
    drift = physics.energy_drift(traj)
    assert float(jnp.max(drift)) < 1e-4
    start = np.asarray(sys_.x[0])
    end = np.asarray(traj.final.x[0])
    # closure: |q(T) - q(0)| small compared to the ~1 AU orbit radius
    assert np.linalg.norm(end - start) < 0.05, np.linalg.norm(end - start)


def test_solar_system_si_units_f64():
    """SI-unit physics mode (float64): same orbit, reference's raw constants
    (test_integrator_solar_system.py:28-40)."""
    sys_, const = physics.solar_system(units="si")
    sys_ = physics.center_of_mass_frame(sys_)
    dt = 600.0  # seconds (the reference's stepSize)
    steps = 5000
    traj = physics.simulate_lib.simulate(
        sys_, dt, steps, method="velocity_verlet", save_every=1000,
        constants=const)
    assert float(jnp.max(physics.energy_drift(traj))) < 1e-8


# ---------------------------------------------------------------------------
# jerk and adaptive dt
# ---------------------------------------------------------------------------

def test_jerk_matches_autodiff():
    """jerk = d a / dt along the flow = (da/dx) v, checked with jvp."""
    sys_, const = _kepler()
    accel = lambda x: physics.accelerations(
        sys_.replace(x=x), constants=const)
    _, analytic = jax.jvp(accel, (sys_.x,), (sys_.v,))
    ours = physics.jerk(sys_.x, sys_.v, sys_.mass, constants=const)
    np.testing.assert_allclose(np.asarray(ours), np.asarray(analytic),
                               rtol=1e-8, atol=1e-12)


def test_adaptive_simulation_reaches_final_time():
    sys_, const = _kepler()
    traj = physics.simulate_lib.simulate_adaptive(
        sys_, 0.05, 6.28, method="velocity_verlet", criterion="simple",
        max_steps=5000, constants=const)
    nv = int(traj.num_valid)
    assert 0 < nv < 5000
    np.testing.assert_allclose(float(traj.final.time), 6.28, rtol=1e-6)
    assert float(physics.energy_drift(traj)[nv - 1] if nv > 0 else 0) < 1e-2


def test_adaptive_advanced_criterion_positive():
    sys_, const = _kepler()
    dt = physics.adaptive_dt_advanced(sys_, 0.05, constants=const)
    assert float(dt) > 0.0


def test_adaptive_hermite_reaches_final_time_and_conserves():
    """Adaptive-dt Hermite (reference ``IntegrateHIA``, samples/NBody/
    Integrators.py:320-350): the jerk-needing scheme under both adaptive
    criteria must reach final_time with energy drift no worse than the
    fixed-step Hermite at the same dt0."""
    sys_, const = _kepler()
    for criterion in ("simple", "advanced"):
        traj = physics.simulate_lib.simulate_adaptive(
            sys_, 0.05, 6.28, method="hermite", criterion=criterion,
            max_steps=5000, constants=const)
        nv = int(traj.num_valid)
        assert 0 < nv < 5000, criterion
        np.testing.assert_allclose(float(traj.final.time), 6.28, rtol=1e-6)
        drift = float(physics.energy_drift(traj)[nv - 1])
        assert drift < 1e-3, (criterion, drift)

    fixed = physics.simulate_lib.simulate(
        sys_, 0.05, num_steps=126, method="hermite", constants=const)
    nfv = int(fixed.num_valid)
    drift_fixed = float(physics.energy_drift(fixed)[nfv - 1])
    adaptive = physics.simulate_lib.simulate_adaptive(
        sys_, 0.05, 6.28, method="hermite", criterion="simple",
        max_steps=5000, constants=const)
    nav = int(adaptive.num_valid)
    drift_adaptive = float(physics.energy_drift(adaptive)[nav - 1])
    # adaptive shrinks dt near pericentre: at least as accurate
    assert drift_adaptive <= drift_fixed * 2.0


# ---------------------------------------------------------------------------
# IC format round-trip (reference MiscFunctions.ReadInput)
# ---------------------------------------------------------------------------

PL3_TEXT = """ 3  220.0       0.1
0.99990
0.00001
0.00009
0.0      0.0       0.0
1.0      0.0       0.0
-2.25    0.0       0.0
0.0      0.0       0.0
0.0      1.0       0.0
0.0     -0.66667   0.0
"""


def test_load_nbody_text():
    sys_, tmax, dt = physics.load_nbody_text(PL3_TEXT)
    assert sys_.num_bodies == 3
    assert tmax == 220.0 and dt == 0.1
    np.testing.assert_allclose(float(sys_.mass[0]), 0.9999)
    np.testing.assert_allclose(np.asarray(sys_.x[2]), [-2.25, 0, 0])
    np.testing.assert_allclose(np.asarray(sys_.v[2]), [0, -0.66667, 0])


def test_nbody_text_roundtrip():
    sys_, tmax, dt = physics.load_nbody_text(PL3_TEXT)
    text = physics.save_nbody_text(sys_, tmax, dt)
    sys2, tmax2, dt2 = physics.load_nbody_text(text)
    np.testing.assert_allclose(np.asarray(sys2.x), np.asarray(sys_.x))
    np.testing.assert_allclose(np.asarray(sys2.v), np.asarray(sys_.v))
    assert (tmax2, dt2) == (tmax, dt)


def test_load_truncated_raises():
    with pytest.raises(ValueError, match="truncated"):
        physics.load_nbody_text("3 1.0 0.1\n0.5\n")


def test_com_frame():
    sys_, _ = _kepler()
    com = physics.center_of_mass_frame(sys_)
    total = float(jnp.sum(com.mass))
    np.testing.assert_allclose(
        np.asarray(jnp.sum(com.mass[:, None] * com.x, axis=0) / total),
        0.0, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(jnp.sum(com.mass[:, None] * com.v, axis=0) / total),
        0.0, atol=1e-12)


def test_potential_energy_matches_python_reference_formula():
    """Cross-check vectorised pairwise energy against a direct double loop
    (the reference's Energy, MiscFunctions.py:155-171)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 3))
    m = rng.uniform(1, 2, size=5)
    u = 0.0
    for i in range(5):
        for j in range(i + 1, 5):
            u += -m[i] * m[j] / np.linalg.norm(x[j] - x[i])
    ours = nbody_potential_energy(
        jnp.asarray(x), jnp.asarray(m), constants=NATURAL)
    np.testing.assert_allclose(float(ours), u, rtol=1e-6)


# ---------------------------------------------------------------------------
# embedded RK45 (the working ode45, reference Integrators.py:10 is broken)
# ---------------------------------------------------------------------------

def test_rk45_kepler_accuracy_and_adaptivity():
    """One eccentric Kepler orbit under error control: energy conserved to
    near the tolerance, and the controller actually varies dt (smaller near
    perihelion than aphelion)."""
    sys_, const = _kepler()
    period = 2.0 * np.pi
    traj = physics.simulate_rk45(
        sys_, 1e-2, 3.0 * period, rtol=1e-9, atol=1e-12,
        max_steps=20_000, constants=const)
    n = int(traj.num_valid)
    assert 0 < n < 20_000
    drift = physics.energy_drift(traj)[:n]
    assert float(jnp.max(drift)) < 1e-7, float(jnp.max(drift))
    # reached final time
    np.testing.assert_allclose(float(traj.final.time), 3.0 * period,
                               rtol=1e-12)
    # adaptive: step sizes span a real range on an e=0.5 orbit
    dts = np.diff(np.asarray(traj.times[:n]))
    assert dts.min() > 0
    assert dts.max() / dts.min() > 3.0


def test_rk45_step_order():
    """Single-step error scales ~dt^6 (local order of the 5th-order pair):
    halving dt shrinks the one-step position error by ~2^6."""
    sys_, const = _kepler()
    accel = lambda x: physics.accelerations(
        sys_.replace(x=x), constants=const)

    def one_step_err(dt):
        ref = physics.simulate_rk45(
            sys_, dt / 64, dt, rtol=1e-13, atol=1e-15,
            max_steps=8192, constants=const)
        x1, _, _, _ = physics.integrators.rk45_step(
            accel, sys_.x, sys_.v, jnp.asarray(dt, jnp.float64))
        return float(jnp.max(jnp.abs(x1 - ref.final.x)))

    e1, e2 = one_step_err(0.2), one_step_err(0.1)
    ratio = e1 / e2
    assert 2**5 < ratio < 2**8, ratio
