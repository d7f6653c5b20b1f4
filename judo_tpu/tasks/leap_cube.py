"""LEAP cube in-hand rotation task (reference: judo/tasks/leap_cube.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import jax.numpy as jnp
import numpy as np

from judo_tpu.gui import slider
from judo_tpu.models.leap import leap_cube_xml_path
from judo_tpu.ops.math import quat_diff, quat_diff_so3
from judo_tpu.tasks.base import Task, TaskConfig

QPOS_HOME = np.array(
    [
        0.0, 0.03, 0.1, 1.0, 0.0, 0.0, 0.0,  # cube free joint
        0.5, -0.75, 0.75, 0.25,  # index
        0.5, 0.0, 0.75, 0.25,  # middle
        0.5, 0.75, 0.75, 0.25,  # ring
        0.65, 0.9, 0.75, 0.6,  # thumb
    ]
)  # fmt: skip


@slider("w_pos", 0.0, 200.0)
@slider("w_rot", 0.0, 1.0)
@dataclass
class LeapCubeConfig(TaskConfig):
    """Tracking weights (leap_cube.py:29-35)."""

    w_pos: float = 100.0
    w_rot: float = 0.1


class LeapCube(Task[LeapCubeConfig]):
    """Rotate the cube in-hand to track goal orientations.

    The goal quaternion lives in the *sim* process and crosses to the
    controller through sim metadata (leap_cube.py:133-135).
    """

    name: str = "leap_cube"
    config_t: type[LeapCubeConfig] = LeapCubeConfig

    def __init__(self, model_path: str | None = None, sim_model_path: str | None = None) -> None:
        # planner plans on leap_cube.xml; the plant integrates the finer
        # leap_cube_sim.xml (reference: judo/tasks/leap_cube.py:14-15) so
        # closed-loop tests exercise planner-vs-plant model error
        if model_path is None and sim_model_path is None:
            sim_model_path = leap_cube_xml_path("leap_cube_sim")
        super().__init__(model_path=model_path or leap_cube_xml_path(), sim_model_path=sim_model_path)
        self.goal_pos = np.array([0.0, 0.03, 0.1])
        self.goal_quat = np.array([1.0, 0.0, 0.0, 0.0])
        self.qpos_home = QPOS_HOME
        self.reset_command = QPOS_HOME[7:].copy()
        self.reset()

    def reward(
        self,
        states: jnp.ndarray,
        sensors: jnp.ndarray,
        controls: jnp.ndarray,
        params: dict[str, Any],
        system_metadata: dict[str, Any] | None = None,
    ) -> jnp.ndarray:
        """Position + SO(3) log-map orientation tracking, averaged over time
        (leap_cube.py:63-88)."""
        metadata = system_metadata or {}
        goal_quat = metadata.get("goal_quat", jnp.asarray([1.0, 0.0, 0.0, 0.0], states.dtype))
        goal_pos = jnp.asarray(self.goal_pos, states.dtype)

        pos_diff = states[..., :3] - goal_pos
        quat_err = quat_diff_so3(states[..., 3:7], goal_quat)
        pos_cost = params["w_pos"] * 0.5 * jnp.square(pos_diff).sum(-1).mean(-1)
        rot_cost = params["w_rot"] * 0.5 * jnp.square(quat_err).sum(-1).mean(-1)
        return -(pos_cost + rot_cost)

    def optimizer_warm_start(self) -> np.ndarray:
        return self.reset_command.copy()

    def post_sim_step(self) -> None:
        """Cube-drop reset + new random goal on success (leap_cube.py:90-123)."""
        if self.data.qpos[2] < -0.3:
            self.reset()

        q_diff = np.asarray(quat_diff(jnp.asarray(self.data.qpos[3:7]), jnp.asarray(self.goal_quat)))
        sin_half = np.linalg.norm(q_diff[1:])
        angle = 2.0 * np.arctan2(sin_half, q_diff[0])
        if angle > np.pi:
            angle -= 2.0 * np.pi
        if np.abs(angle) < 0.4:
            self._update_goal_quat()

    def _update_goal_quat(self) -> None:
        """Uniform random unit quaternion -> mocap + metadata."""
        uvw = np.random.rand(3)
        goal_quat = np.array(
            [
                np.sqrt(1 - uvw[0]) * np.sin(2 * np.pi * uvw[1]),
                np.sqrt(1 - uvw[0]) * np.cos(2 * np.pi * uvw[1]),
                np.sqrt(uvw[0]) * np.sin(2 * np.pi * uvw[2]),
                np.sqrt(uvw[0]) * np.cos(2 * np.pi * uvw[2]),
            ]
        )
        if self.data.mocap_quat.shape[0] > 0:
            self.data.mocap_quat[0] = goal_quat
        self.goal_quat = goal_quat

    def reset(self) -> None:
        self.data.qpos[:] = self.qpos_home
        self.data.qvel[:] = 0.0
        self.data.ctrl[:] = self.reset_command
        self._update_goal_quat()
        self.forward()

    def get_sim_metadata(self) -> dict[str, Any]:
        return {"goal_quat": self.goal_quat}
