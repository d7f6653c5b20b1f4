"""Newton-Schulz temporal-warm-start chain: f32 drift, divergence guard,
and the blocked exact re-seed (rollout's reseed_every).

These tests pin the f32 NS-vs-cold agreement and the divergence guard:
the carried-inverse rollout must track a cold (exact-inverse-every-step)
rollout in float32 over a contact-rich horizon, and a divergent refresh must
freeze (bounded) rather than explode.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np

from judo_tpu.physics import make_state, put_model, rollout
from judo_tpu.physics.step import _ns_refresh, seed_inverses, step

# Contact-rich mini-scene: actuated 2-link arm pressing a free box against the
# floor — exercises contacts, limits, and mass-matrix variation with pose.
ARM_BOX = """
<mujoco>
  <option timestep="0.005"/>
  <worldbody>
    <geom name="floor" type="plane" size="2 2 0.1"/>
    <body name="link1" pos="0 0 0.4">
      <joint name="j1" type="hinge" axis="0 1 0" range="-1.5 1.5" damping="0.2"/>
      <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.04" mass="0.5"/>
      <body name="link2" pos="0.3 0 0">
        <joint name="j2" type="hinge" axis="0 1 0" range="-2 2" damping="0.1"/>
        <geom type="capsule" fromto="0 0 0 0.25 0 0" size="0.035" mass="0.3"/>
      </body>
    </body>
    <body name="box" pos="0.45 0 0.08">
      <freejoint/>
      <geom type="box" size="0.06 0.06 0.06" mass="0.2"/>
    </body>
  </worldbody>
  <actuator>
    <position joint="j1" kp="30" ctrlrange="-1.5 1.5"/>
    <position joint="j2" kp="20" ctrlrange="-2 2"/>
  </actuator>
</mujoco>
"""


def _model(dtype):
    mj = mujoco.MjModel.from_xml_string(ARM_BOX)
    return put_model(mj, dtype=dtype)


def _controls(pm, T, dtype):
    rng = np.random.default_rng(3)
    base = np.array([-0.4, -0.6])
    ctrl = base + 0.3 * np.sin(0.1 * np.arange(T))[:, None] + 0.05 * rng.standard_normal((T, 2))
    return jnp.asarray(ctrl, dtype)


def _cold_rollout(pm, s0, controls):
    """Exact inverses every step: step() never carries warm inverses."""

    def body(s, c):
        s = step(pm, s, c)
        return s, jnp.concatenate([s.qpos, s.qvel])

    return jax.lax.scan(body, s0, controls)[1]


def test_f32_ns_tracks_cold_rollout():
    pm = _model(jnp.float32)
    T = 120
    ctrl = _controls(pm, T, jnp.float32)
    s0 = make_state(pm)

    warm = jax.jit(lambda s, c: rollout(pm, s, c).states)(s0, ctrl)
    cold = jax.jit(lambda s, c: _cold_rollout(pm, s, c))(s0, ctrl)

    warm = np.asarray(warm)
    cold = np.asarray(cold)
    assert np.all(np.isfinite(warm)), "NS-carried f32 rollout produced non-finite states"
    # bounded divergence: the two inverse strategies agree to f32 roundoff
    # accumulated through contact switches over the horizon (states are O(1);
    # measured ~5e-3 — an exploding NS chain produces inf/1e10s, not 1e-2)
    assert np.abs(warm - cold).max() < 2e-2


def test_ns_refresh_guard_freezes_on_divergent_seed():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((6, 6))
    a = jnp.asarray(q @ q.T + 6 * np.eye(6), jnp.float32)
    good = jnp.linalg.inv(a)
    # a catastrophically wrong seed: residual ||I - A X|| >> 1
    bad = 50.0 * good

    refreshed_good = _ns_refresh(a, good)
    refreshed_bad = _ns_refresh(a, bad)

    # healthy seed: refresh keeps (improves) the inverse
    np.testing.assert_allclose(np.asarray(refreshed_good), np.asarray(good), atol=1e-5)
    # divergent seed: frozen, NOT exploded/NaN
    assert np.all(np.isfinite(np.asarray(refreshed_bad)))
    np.testing.assert_allclose(np.asarray(refreshed_bad), np.asarray(bad), atol=1e-5)


def test_reseed_block_padding_matches_unpadded():
    """T not divisible by reseed_every: outputs are identical up to the
    different exact-reseed points (f64 ⇒ tight agreement)."""
    pm = _model(jnp.float64)
    T = 23
    ctrl = _controls(pm, T, jnp.float64)
    s0 = make_state(pm)

    padded = jax.jit(lambda s, c: rollout(pm, s, c, reseed_every=10).states)(s0, ctrl)
    whole = jax.jit(lambda s, c: rollout(pm, s, c, reseed_every=23).states)(s0, ctrl)

    assert padded.shape == (T, pm.nq + pm.nv)
    np.testing.assert_allclose(np.asarray(padded), np.asarray(whole), atol=1e-9)


def test_seed_inverses_are_exact():
    pm = _model(jnp.float64)
    s0 = make_state(pm)
    minv, mhinv = seed_inverses(pm, s0)
    from judo_tpu.physics import smooth
    from judo_tpu.physics.step import implicit_damping

    kin = smooth.kinematics(pm, s0)
    com = smooth.com_quantities(pm, kin)
    mm = smooth.crb_mass_matrix(pm, com)
    np.testing.assert_allclose(np.asarray(minv @ mm), np.eye(pm.nv), atol=1e-10)
    mh = mm + pm.timestep * jnp.diag(implicit_damping(pm))
    np.testing.assert_allclose(np.asarray(mhinv @ mh), np.eye(pm.nv), atol=1e-10)
