"""SpotTireUpright reward parity vs a numpy transcription of the reference
(judo/tasks/spot/spot_tire_upright.py:101-237 in /root/reference).

This pins every term (orientation goal, gripper/foot/torso proximity
shaping, both anti-hack gripper penalties, fall penalty, control cost) by
evaluating the reference arithmetic independently in numpy on random
states/sensors/controls and requiring our jnp reward to match.
"""

import numpy as np
import pytest

from judo_tpu.tasks.spot import spot_constants as sc
from judo_tpu.tasks.spot.spot_tire_upright import SpotTireUpright


def _quat_rotate_np(q, v):
    w, x, y, z = q
    u = np.array([x, y, z])
    uv = np.cross(u, v)
    uuv = np.cross(u, uv)
    return v + 2.0 * (w * uv + uuv)


def _reference_reward(task, states, sensors, controls):
    cfg = task.config
    qpos = states[..., : task.model.nq]

    W_p_tire = qpos[..., task.object_pose_idx : task.object_pose_idx + 3]
    W_p_torso = qpos[..., task.body_pose_idx : task.body_pose_idx + 3]
    d = W_p_torso - W_p_tire
    u = d / (np.linalg.norm(d, axis=-1, keepdims=True) + 1e-8)

    gripper_des = W_p_tire + (sc.TIRE_RADIUS - 0.05) * u
    gripper_des[..., 2] = sc.TIRE_HALF_WIDTH + 0.1
    W_p_gripper = sensors[..., task.gripper_pos_idx : task.gripper_pos_idx + 3]
    gripper_prox = -cfg.w_gripper_proximity * np.linalg.norm(
        W_p_gripper - gripper_des, axis=-1
    ).mean(-1)

    qp = np.array([np.cos(np.pi / 8), 0, 0, np.sin(np.pi / 8)])
    qn = np.array([np.cos(np.pi / 8), 0, 0, -np.sin(np.pi / 8)])
    right_des = W_p_tire + sc.TIRE_RADIUS * np.apply_along_axis(
        lambda v: _quat_rotate_np(qp, v), -1, u
    )
    right_des[..., 2] = 0.1
    left_des = W_p_tire + sc.TIRE_RADIUS * np.apply_along_axis(
        lambda v: _quat_rotate_np(qn, v), -1, u
    )
    left_des[..., 2] = 0.1
    fr = sensors[..., task.fr_pos_idx : task.fr_pos_idx + 3]
    fl = sensors[..., task.fl_pos_idx : task.fl_pos_idx + 3]
    right_prox = -cfg.w_foot_proximity * np.linalg.norm(fr - right_des, axis=-1).mean(-1)
    left_prox = -cfg.w_foot_proximity * np.linalg.norm(fl - left_des, axis=-1).mean(-1)
    foot_prox = np.maximum(right_prox, left_prox)

    torso_des = W_p_tire + 0.75 * u
    torso_des[..., 2] = sc.STANDING_HEIGHT
    torso_prox = -cfg.w_torso_proximity * np.linalg.norm(W_p_torso - torso_des, axis=-1).mean(-1)

    tire_y = sensors[..., task.tire_y_axis_idx : task.tire_y_axis_idx + 3]
    orient = -cfg.w_tire_orientation * np.exp(
        np.abs(tire_y[..., 2]) / cfg.orientation_error_smoothing_width
    ).mean(-1)

    g_from_tire = np.linalg.norm(W_p_gripper - W_p_tire, axis=-1)
    inside = -cfg.gripper_too_inside_tire_penalty * (
        g_from_tire < sc.TIRE_RADIUS * 0.5
    ).mean(-1)
    not_above = np.logical_and(
        W_p_gripper[..., 2] < 2 * sc.TIRE_HALF_WIDTH + 0.05, g_from_tire > sc.TIRE_RADIUS
    )
    not_above_pen = -cfg.gripper_not_above_tire_penalty * not_above.mean(-1)

    body_h = qpos[..., task.body_pose_idx + 2]
    fallen = -cfg.fall_penalty * (body_h <= cfg.spot_fallen_threshold).any(-1)

    ctrl = -cfg.w_controls * np.linalg.norm(controls, axis=-1).mean(-1)

    return (
        orient + gripper_prox + foot_prox + torso_prox + inside + not_above_pen + fallen + ctrl
    )


@pytest.fixture(scope="module")
def task():
    return SpotTireUpright()


def test_tire_upright_reward_matches_reference_transcription(task):
    rng = np.random.default_rng(0)
    R, T = 6, 9
    nq, nv, nu = task.model.nq, task.model.nv, task.nu
    ns = task.model.nsensordata
    states = rng.standard_normal((R, T, nq + nv))
    # realistic-ish heights so the fall penalty exercises both branches
    states[..., task.body_pose_idx + 2] = rng.uniform(0.1, 0.7, (R, T))
    sensors = rng.standard_normal((R, T, ns))
    controls = rng.standard_normal((R, T, nu))

    ours = np.asarray(
        task.reward(states.astype(np.float32), sensors.astype(np.float32),
                    controls.astype(np.float32), task.task_params(), {})
    )
    ref = _reference_reward(task, states, sensors, controls)
    np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=2e-3)


def test_tire_upright_fall_penalty_dominates(task):
    """A fallen rollout must rank below any standing one (anti-hack check)."""
    rng = np.random.default_rng(1)
    R, T = 2, 5
    nq, nv, nu = task.model.nq, task.model.nv, task.nu
    states = rng.standard_normal((R, T, nq + nv)) * 0.1
    states[0, :, task.body_pose_idx + 2] = 0.6   # standing
    states[1, :, task.body_pose_idx + 2] = 0.05  # fallen
    sensors = np.zeros((R, T, task.model.nsensordata))
    controls = np.zeros((R, T, nu))
    r = np.asarray(
        task.reward(states.astype(np.float32), sensors.astype(np.float32),
                    controls.astype(np.float32), task.task_params(), {})
    )
    assert r[0] > r[1]
    assert r[0] - r[1] >= 0.5 * task.config.fall_penalty
