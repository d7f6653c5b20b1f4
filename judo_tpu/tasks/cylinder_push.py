"""Cylinder-pushing task (reference: judo/tasks/cylinder_push.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import jax.numpy as jnp
import numpy as np

from judo_tpu import MODEL_PATH
from judo_tpu.gui import slider
from judo_tpu.ops.costs import quadratic_norm
from judo_tpu.tasks.base import Task, TaskConfig
from judo_tpu.utils.fields import np_1d_field

XML_PATH = str(MODEL_PATH / "xml" / "cylinder_push.xml")


@slider("w_pusher_proximity", 0.0, 5.0, 0.1)
@dataclass
class CylinderPushConfig(TaskConfig):
    """Reward weights + GUI-draggable goal (cylinder_push.py:20-36)."""

    w_pusher_proximity: float = 0.5
    w_pusher_velocity: float = 0.0
    w_cart_position: float = 0.1
    pusher_goal_offset: float = 0.25
    goal_pos: np.ndarray = np_1d_field(
        np.array([0.0, 0.0]),
        names=["x", "y"],
        mins=[-1.0, -1.0],
        maxs=[1.0, 1.0],
        steps=[0.01, 0.01],
        vis_name="goal_position",
        xyz_vis_indices=[0, 1, None],
        xyz_vis_defaults=[0.0, 0.0, 0.0],
    )


class CylinderPush(Task[CylinderPushConfig]):
    """Push the cart cylinder to a movable goal with the pusher cylinder."""

    name: str = "cylinder_push"
    config_t: type[CylinderPushConfig] = CylinderPushConfig

    def __init__(self, model_path: str = XML_PATH, sim_model_path: str | None = None) -> None:
        super().__init__(model_path=model_path, sim_model_path=sim_model_path)
        self.reset()

    def reward(
        self,
        states: jnp.ndarray,
        sensors: jnp.ndarray,
        controls: jnp.ndarray,
        params: dict[str, Any],
        system_metadata: dict[str, Any] | None = None,
    ) -> jnp.ndarray:
        """Pusher-behind-cart proximity + pusher velocity + cart-to-goal
        (cylinder_push.py:50-93)."""
        pusher_pos = states[..., 0:2]
        cart_pos = states[..., 2:4]
        pusher_vel = states[..., 4:6]
        goal = params["goal_pos"][0:2]

        cart_to_goal = goal - cart_pos
        dist = jnp.linalg.norm(cart_to_goal, axis=-1, keepdims=True)
        direction = cart_to_goal / dist
        pusher_goal = cart_pos - params["pusher_goal_offset"] * direction

        pusher_rew = -params["w_pusher_proximity"] * quadratic_norm(pusher_pos - pusher_goal).sum(-1)
        velocity_rew = -params["w_pusher_velocity"] * quadratic_norm(pusher_vel).sum(-1)
        goal_rew = -params["w_cart_position"] * quadratic_norm(cart_pos - goal).sum(-1)
        return pusher_rew + velocity_rew + goal_rew

    def reset(self) -> None:
        """Random ring reset (cylinder_push.py:95-107)."""
        theta = 2 * np.pi * np.random.rand(2)
        self.data.qpos = np.array(
            [np.cos(theta[0]), np.sin(theta[0]), 2 * np.cos(theta[1]), 2 * np.sin(theta[1])]
        )
        self.data.qvel = np.zeros(4)
        self.forward()
