"""Parity of the batch-in-lanes engine (lane_engine/lane_step/lane_rollout)
against the vmap(step.rollout) formulation.

The lanes rollout is one of the controller's two rollout backends; its
numerics must match the reference formulation that is itself
MuJoCo-trajectory-parity-tested (test_parity.py). Small inline scenes keep CPU
compile times in check.

Replaces-semantics reference: judo/utils/mj_rollout_backend.py:84 (the rollout
loop both formulations implement).
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np

from judo_tpu.physics import make_state, put_model, rollout
from judo_tpu.physics.lane_rollout import rollout_lanes

from .test_parity import CARTPOLE, SPHERE_PLANE


def _vmap_reference(pm, qpos, qvel, ctrl):
    def one(qp, qv, c):
        out = rollout(pm, make_state(pm, qpos=qp, qvel=qv), c)
        return out.states, out.sensordata

    return jax.jit(jax.vmap(one))(qpos, qvel, ctrl)


def _batch(mj, R, T, rng, qpos0, qvel_scale=0.1, ctrl_scale=0.3):
    qpos = np.tile(np.asarray(qpos0, np.float64), (R, 1))
    qvel = qvel_scale * rng.standard_normal((R, mj.nv))
    ctrl = ctrl_scale * rng.standard_normal((R, T, mj.nu)) if mj.nu else np.zeros((R, T, 0))
    return jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(ctrl)


def test_lanes_xla_matches_vmap_cartpole():
    mj = mujoco.MjModel.from_xml_string(CARTPOLE)
    pm = put_model(mj, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    qp, qv, ct = _batch(mj, R=4, T=40, rng=rng, qpos0=[0.2, 2.9])

    ref_states, ref_sens = _vmap_reference(pm, qp, qv, ct)
    lane = jax.jit(lambda a, b, c: rollout_lanes(pm, a, b, c))(qp, qv, ct)

    np.testing.assert_allclose(np.asarray(lane.states), np.asarray(ref_states), atol=1e-9)
    np.testing.assert_allclose(np.asarray(lane.sensordata), np.asarray(ref_sens), atol=1e-9)


def test_lanes_xla_matches_vmap_contacts():
    """Contact-rich scene: lanes assembly/APGD vs the reference solver.

    The lanes APGD uses exact per-step inverses (no Newton-Schulz chain) and a
    matrix-free apply, so agreement is to solver convergence, not machine eps.
    """
    mj = mujoco.MjModel.from_xml_string(SPHERE_PLANE)
    pm = put_model(mj, dtype=jnp.float64)
    rng = np.random.default_rng(1)
    qp, qv, ct = _batch(mj, R=4, T=60, rng=rng, qpos0=[0, 0, 0.25, 1, 0, 0, 0], qvel_scale=0.4)

    ref_states, _ = _vmap_reference(pm, qp, qv, ct)
    lane = jax.jit(lambda a, b, c: rollout_lanes(pm, a, b, c))(qp, qv, ct)

    assert bool(jnp.all(jnp.isfinite(lane.states)))
    np.testing.assert_allclose(np.asarray(lane.states), np.asarray(ref_states), atol=1e-5)


def test_controller_lanes_backend_matches_vmap():
    """End-to-end: a solve built on the lanes rollout produces near-identical
    rewards and nominal knots to the vmap solve under the same PRNG stream.

    MPPI (smooth softmax update), not PS: the two rollout formulations differ
    by f32 roundoff, which argmax would amplify into a discrete elite flip on
    near-tied rewards."""
    from judo_tpu.controller import ControllerConfig, Controller
    from judo_tpu.optimizers import get_registered_optimizers
    from judo_tpu.tasks import get_registered_tasks

    task_cls, _ = get_registered_tasks()["cylinder_push"]
    opt_cls, opt_cfg_cls = get_registered_optimizers()["mppi"]

    knots, rewards = {}, {}
    for backend in ("vmap", "lanes_xla"):
        np.random.seed(7)  # cylinder_push reset is randomized (ring reset)
        task = task_cls()
        cfg = opt_cfg_cls()
        cfg.num_rollouts = 8
        cfg.num_nodes = 4
        opt = opt_cls(cfg, task.nu)
        c = Controller(ControllerConfig(), task, opt, rollout_backend=backend)
        assert c._resolve_rollout_backend() == backend
        c.update_action()
        knots[backend] = np.asarray(c.nominal_knots).copy()
        rewards[backend] = np.sort(np.asarray(c.last_outputs.rewards))

    np.testing.assert_allclose(rewards["lanes_xla"], rewards["vmap"], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(knots["lanes_xla"], knots["vmap"], atol=1e-3)


def test_lanes_power_lipschitz_matches_holder():
    """The power-iteration Lipschitz estimate (1.6x Rayleigh safety) must
    give the same converged contact forces as the always-valid Hoelder bound
    on a contact-rich scene."""
    mj = mujoco.MjModel.from_xml_string(SPHERE_PLANE)
    pm = put_model(mj, dtype=jnp.float64)
    rng = np.random.default_rng(5)
    qp, qv, ct = _batch(mj, R=4, T=60, rng=rng, qpos0=[0, 0, 0.25, 1, 0, 0, 0], qvel_scale=0.4)

    hold = jax.jit(lambda a, b, c: rollout_lanes(pm, a, b, c))(qp, qv, ct)
    pwr = jax.jit(lambda a, b, c: rollout_lanes(pm, a, b, c, lipschitz="power"))(qp, qv, ct)

    assert bool(jnp.all(jnp.isfinite(pwr.states)))
    np.testing.assert_allclose(np.asarray(pwr.states), np.asarray(hold.states), atol=2e-5)
