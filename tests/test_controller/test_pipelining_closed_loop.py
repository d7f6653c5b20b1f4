"""Closed-loop task success is preserved under pipelined planning: with ``pipeline_depth > 0`` the published spline lags ``depth``
solves — this test pins that the staleness does not break the MPC loop.

Mirrors the reference's plan-freshness semantics (the reference keeps
planning while the sim advances, judo/app/dora/controller.py:126-157); here
the explicit depth knob must not change task outcome, only telemetry.
"""

import mujoco
import numpy as np
import pytest

from judo_tpu.app.structs import MujocoState
from judo_tpu.controller import make_controller


def _run_cylinder_push(depth: int, steps: int = 180) -> float:
    """Closed loop on cylinder_push; returns final cart-to-goal distance."""
    np.random.seed(3)
    c = make_controller("cylinder_push", "mppi")
    c.controller_cfg.pipeline_depth = depth
    task = c.task
    d = task.data
    mujoco.mj_forward(task.model, d)
    goal = np.asarray(task.config.goal_pos[:2])

    for _ in range(steps):
        c.update_states(
            MujocoState(d.time, d.qpos.copy(), d.qvel.copy(), None, None, None, None, {})
        )
        c.update_action()
        d.ctrl[:] = c.action(d.time)
        for _ in range(2):  # 2 sim steps per plan (sim dt < control period)
            mujoco.mj_step(task.model, d)
    c.flush_pipeline()
    cart = d.qpos[2:4]  # cart cylinder x, y
    return float(np.linalg.norm(cart - goal))


@pytest.mark.parametrize("depth", [0, 2])
def test_cylinder_push_reaches_goal_at_depth(depth):
    dist = _run_cylinder_push(depth)
    assert dist < 0.3, f"cart ended {dist:.3f} from goal at pipeline_depth={depth}"
