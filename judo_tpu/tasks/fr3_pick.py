"""FR3 pick-and-place task (reference: judo/tasks/fr3_pick.py).

The reference computes the task phase host-side in ``pre_rollout`` from the
current state (fr3_pick.py:191-223) and branches the reward on it. Here the
phase crosses into the jitted solve as a metadata scalar and the reward
selects between phase branches with ``where`` — branchless, per SURVEY §7's
build plan note.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any

import jax.numpy as jnp
import numpy as np

from judo_tpu.gui import slider
from judo_tpu.models.fr3 import fr3_pick_xml_path
from judo_tpu.tasks.base import Task, TaskConfig
from judo_tpu.utils.fields import np_1d_field

QPOS_HOME = np.array(
    [
        0.7, 0, 0.02, 1, 0, 0, 0,  # object free joint
        0, -0.7854, 0.0, -2.3562, 0.0, 1.5708, 0.7854,  # arm
        0.04, 0.04,  # gripper (equality-coupled)
    ]
)  # fmt: skip


class Phase(Enum):
    LIFT = 0
    MOVE = 1
    PLACE = 2
    HOMING = 3


@slider("w_lift_close", 0.0, 10.0, 0.01)
@slider("w_lift_height", 0.0, 10.0, 0.01)
@dataclass
class LiftConfig:
    w_lift_close: float = 1.0
    w_lift_height: float = 10.0


@slider("w_move_goal", 0.0, 10.0, 0.01)
@slider("w_move_close", 0.0, 10.0, 0.01)
@dataclass
class MoveConfig:
    w_move_goal: float = 1.0
    w_move_close: float = 10.0


@slider("w_place_table", 0.0, 10.0, 0.01)
@slider("w_place_goal", 0.0, 10.0, 0.01)
@dataclass
class PlaceConfig:
    w_place_table: float = 1.0
    w_place_goal: float = 1.0


@slider("w_upright", 0.0, 10.0, 0.01)
@slider("w_coll", 0.0, 10.0, 0.01)
@slider("w_qvel", 0.0, 10.0, 0.01)
@slider("w_open", 0.0, 10.0, 0.01)
@dataclass
class GlobalConfig:
    w_upright: float = 0.25
    w_coll: float = 0.1
    w_qvel: float = 0.005
    w_open: float = 2.0


@slider("goal_radius", 0.005, 0.1, 0.005)
@slider("pick_height", 0.0, 1.0, 0.01)
@dataclass
class FR3PickConfig(TaskConfig):
    lift_weights: LiftConfig = field(default_factory=LiftConfig)
    move_weights: MoveConfig = field(default_factory=MoveConfig)
    place_weights: PlaceConfig = field(default_factory=PlaceConfig)
    global_weights: GlobalConfig = field(default_factory=GlobalConfig)
    goal_pos: np.ndarray = np_1d_field(
        np.array([0.6, 0.4]),
        names=["x", "y"],
        mins=[0.4, -1.0],
        maxs=[1.0, 1.0],
        steps=[0.01, 0.01],
        vis_name="goal_position",
        xyz_vis_indices=[0, 1, None],
        xyz_vis_defaults=[0.0, 0.0, 0.0],
    )
    goal_radius: float = 0.05
    pick_height: float = 0.3


class FR3Pick(Task[FR3PickConfig]):
    """Lift the cube, carry it to the goal, place it, go home."""

    name: str = "fr3_pick"
    config_t: type[FR3PickConfig] = FR3PickConfig

    def __init__(self, model_path: str | None = None, sim_model_path: str | None = None) -> None:
        super().__init__(model_path=model_path or fr3_pick_xml_path(), sim_model_path=sim_model_path)

        self.obj_pos_adr = self.get_joint_position_start_index("object_joint")
        self.obj_pos_slice = slice(self.obj_pos_adr, self.obj_pos_adr + 3)
        arm_pos_adr = self.get_joint_position_start_index("fr3_joint1")
        self.arm_pos_slice = slice(arm_pos_adr, arm_pos_adr + 9)

        self.left_finger_table_adr = self.get_sensor_start_index("left_finger_table")
        self.right_finger_table_adr = self.get_sensor_start_index("right_finger_table")
        self.obj_table_adr = self.get_sensor_start_index("obj_table")
        self.grasp_site_adr = self.get_sensor_start_index("trace_grasp_site")
        self.ee_z_adr = self.get_sensor_start_index("ee_z")

        self.phase = Phase.LIFT
        self.reset_command = np.concatenate([QPOS_HOME[7:14], [0.04]])
        self.reset()

    def in_goal_xy(self, curr_state: np.ndarray) -> bool:
        """Object within the goal-tube radius in xy (fr3_pick.py:145-158)."""
        obj_xy = curr_state[self.obj_pos_adr : self.obj_pos_adr + 2]
        return bool(np.linalg.norm(obj_xy - self.config.goal_pos) <= self.config.goal_radius)

    def pre_rollout(self, curr_state: np.ndarray) -> dict[str, Any]:
        """Phase machine from current state (fr3_pick.py:191-223)."""
        obj_in_air = curr_state[self.obj_pos_adr + 2] > 0.02 + 1e-3
        in_goal = self.in_goal_xy(curr_state)
        phase = Phase.LIFT
        if obj_in_air:
            phase = Phase.MOVE
        if in_goal and obj_in_air:
            phase = Phase.PLACE
        if in_goal and curr_state[self.obj_pos_adr + 2] <= 0.02 + 1e-3:
            phase = Phase.HOMING
        self.phase = phase
        return {"phase": np.asarray(phase.value)}

    def reward(
        self,
        states: jnp.ndarray,
        sensors: jnp.ndarray,
        controls: jnp.ndarray,
        params: dict[str, Any],
        system_metadata: dict[str, Any] | None = None,
    ) -> jnp.ndarray:
        """Phase-switched rewards + global terms (fr3_pick.py:225-311)."""
        meta = system_metadata or {}
        phase = meta.get("phase", jnp.asarray(0.0, states.dtype))

        lf_table = sensors[..., self.left_finger_table_adr]
        rf_table = sensors[..., self.right_finger_table_adr]
        obj_table = sensors[..., self.obj_table_adr]
        grasp_pos = sensors[..., self.grasp_site_adr : self.grasp_site_adr + 3]
        ee_z = sensors[..., self.ee_z_adr : self.ee_z_adr + 3]

        obj_pos = states[..., self.obj_pos_slice]
        arm_pos = states[..., self.arm_pos_slice]
        obj_xy = states[..., self.obj_pos_adr : self.obj_pos_adr + 2]
        z_obj = states[..., self.obj_pos_adr + 2]
        qvel = states[..., self.model.nq : self.model.nq + self.model.nv]
        qvel_norm = jnp.linalg.norm(qvel, axis=-1)
        gripper_pos = arm_pos[..., -1]

        q_arm_goal = jnp.asarray(QPOS_HOME[self.arm_pos_slice], states.dtype)
        grasp_dist = jnp.square(grasp_pos - obj_pos).sum(-1)
        pick_height_err = jnp.square(z_obj - params["pick_height"])
        goal_dist = jnp.linalg.norm(obj_xy - params["goal_pos"], axis=-1)
        home_dist = jnp.linalg.norm(arm_pos - q_arm_goal, axis=-1)

        lw, mw, pw, gw = (
            params["lift_weights"], params["move_weights"], params["place_weights"], params["global_weights"],
        )
        r_lift = -(lw["w_lift_close"] * grasp_dist + lw["w_lift_height"] * pick_height_err).sum(-1)
        r_move = -(mw["w_move_goal"] * goal_dist + mw["w_move_close"] * grasp_dist).sum(-1)
        r_place = -(pw["w_place_table"] * obj_table + pw["w_place_goal"] * goal_dist).sum(-1)
        r_home = -home_dist.sum(-1)

        phase_rewards = jnp.stack([r_lift, r_move, r_place, r_home], axis=-1)  # (R, 4)
        idx = jnp.clip(phase.astype(jnp.int32), 0, 3)
        rewards = jnp.take_along_axis(
            phase_rewards, jnp.broadcast_to(idx, phase_rewards.shape[:-1])[..., None], axis=-1
        )[..., 0]

        hand_touching = (lf_table <= 0.0) | (rf_table <= 0.0)
        down = jnp.asarray([0.0, 0.0, -1.0], states.dtype)
        rew_upright = -jnp.linalg.norm(ee_z - down, axis=-1).sum(-1)
        rew_coll = (1.0 - hand_touching.astype(states.dtype)).sum(-1)
        time_decay = jnp.linspace(1.0, 0.0, states.shape[1], dtype=states.dtype)
        rew_qvel = -(time_decay * qvel_norm).sum(-1)
        rew_open = -jnp.square(gripper_pos - 0.04).sum(-1)

        return rewards + (
            gw["w_upright"] * rew_upright
            + gw["w_coll"] * rew_coll
            + gw["w_qvel"] * rew_qvel
            + gw["w_open"] * rew_open
        )

    def optimizer_warm_start(self) -> np.ndarray:
        return self.reset_command.copy()

    def reset(self) -> None:
        self.data.qpos[:] = QPOS_HOME
        self.data.qvel[:] = 0.0
        self.data.ctrl[:] = self.reset_command
        self.forward()
