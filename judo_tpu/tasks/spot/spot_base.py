"""Spot base task (reference: judo/tasks/spot/spot_base.py).

Controls are a compact vector mapped to the 25-dim policy command
[base_vel(3), arm(7), legs(12), torso(3)] — the mapping, gripper/leg
selection-mask semantics and soft ctrl limits mirror spot_base.py:171-391,
re-expressed as pure jnp (branchless selection via where) so
``task_to_sim_ctrl`` runs inside the jitted solve.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Generic, TypeVar

import jax.numpy as jnp
import numpy as np

from judo_tpu.models.spot import spot_xml_path
from judo_tpu.tasks.base import Task, TaskConfig
from judo_tpu.tasks.spot import spot_constants as sc
from judo_tpu.tasks.spot.policy import SpotPolicy


@dataclass
class SpotBaseConfig(TaskConfig):
    """Base Spot config (spot_base.py:56-66)."""

    fall_penalty: float = 2500.0
    spot_fallen_threshold: float = 0.35
    w_goal: float = 60.0
    w_controls: float = 0.0


ConfigT = TypeVar("ConfigT", bound=SpotBaseConfig)


def _spot_planner_pairs(m, g1: int, g2: int) -> bool:
    """Planner contact budget: keep ground contacts and object contacts, drop
    robot self-collision (the locomotion policy, not the planner, is
    responsible for leg clearance)."""
    b1, b2 = int(m.geom_bodyid[g1]), int(m.geom_bodyid[g2])
    import mujoco as _mj

    name1 = _mj.mj_id2name(m, _mj.mjtObj.mjOBJ_BODY, b1) or ""
    name2 = _mj.mj_id2name(m, _mj.mjtObj.mjOBJ_BODY, b2) or ""
    is_object = ("box_body" in (name1, name2)) or ("tire" in (name1, name2))
    is_ground = b1 == 0 or b2 == 0
    return is_ground or is_object


class SpotBase(Task[ConfigT], Generic[ConfigT]):
    """Flexible Spot locomotion/manipulation base with policy-in-the-loop."""

    name: str = "spot_base"
    config_t: type[SpotBaseConfig] = SpotBaseConfig  # type: ignore[assignment]
    planner_collision_filter = staticmethod(_spot_planner_pairs)

    def __init__(
        self,
        model_path: str | None = None,
        use_arm: bool = True,
        use_gripper: bool = False,
        use_legs: bool = False,
        use_torso: bool = False,
        config: SpotBaseConfig | None = None,
        extra_worldbody: str = "",
    ) -> None:
        super().__init__(model_path=model_path or spot_xml_path(self.name, extra_worldbody))
        if config is not None:
            self.config = config
        self.use_arm = use_arm
        self.use_gripper = use_gripper
        self.use_legs = use_legs
        self.use_torso = use_torso
        self.policy = SpotPolicy.load()
        self._set_command_values()
        self.default_policy_command = np.array(
            [0, 0, 0, *sc.ARM_STOWED_POS, *([0.0] * 12), 0, 0, sc.STANDING_HEIGHT_CMD]
        )
        self.body_pose_idx = self.get_joint_position_start_index("base")
        self.reset()

    # --- control-space structure (spot_base.py:221-254) ---
    def _set_command_values(self) -> None:
        self.leg_selection_index: int | None = None
        self.gripper_selection_index: int | None = None
        vals: list[float]
        if not self.use_arm and not self.use_legs:
            vals = [0, 0, 0]
        elif self.use_arm and not self.use_legs:
            vals = [0, 0, 0, *sc.ARM_UNSTOWED_POS]
            if self.use_gripper:
                vals.append(0.0)
                self.gripper_selection_index = len(vals) - 1
        elif not self.use_arm and self.use_legs:
            vals = [0, 0, 0, *sc.LEGS_STANDING_POS[0:6], 0]
            self.leg_selection_index = len(vals) - 1
        else:
            vals = [0, 0, 0, *sc.ARM_UNSTOWED_POS]
            if self.use_gripper:
                vals.append(0.0)
                self.gripper_selection_index = len(vals) - 1
            vals.extend([*sc.LEGS_STANDING_POS[0:6], 0])
            self.leg_selection_index = len(vals) - 1
        if self.use_torso:
            vals.extend([0, 0, sc.STANDING_HEIGHT])
        self.default_command = np.array(vals)

    @property
    def nu(self) -> int:  # type: ignore[override]
        return len(self.default_command)

    @property
    def physics_substeps(self) -> int:  # type: ignore[override]
        return 2

    @property
    def locomotion_policy_path(self) -> str | None:
        for cand in sc.SPOT_LOCOMOTION_POLICY_CANDIDATES:
            from pathlib import Path

            if Path(cand).exists():
                return str(cand)
        return None

    @property
    def actuator_ctrlrange(self) -> np.ndarray:  # type: ignore[override]
        """Soft control bounds for the compact action space (spot_base.py:171-217)."""
        gl = sc.GRIPPER_OPEN_POS if self.use_gripper else sc.GRIPPER_CLOSED_POS
        arm_lower = np.concatenate((sc.ARM_SOFT_LOWER_JOINT_LIMITS[:-1], [gl]))
        arm_upper = np.concatenate((sc.ARM_SOFT_UPPER_JOINT_LIMITS[:-1], [sc.GRIPPER_CLOSED_POS]))
        lo: list[np.ndarray] = [-sc.BASE_SOFT_LIMITS]
        hi: list[np.ndarray] = [sc.BASE_SOFT_LIMITS]
        if self.use_arm:
            lo.append(arm_lower)
            hi.append(arm_upper)
            if self.use_gripper:
                lo.append(-np.ones(1))
                hi.append(np.ones(1))
        if self.use_legs:
            lo.extend([sc.LEG_SOFT_LOWER_JOINT_LIMITS[0:6], -np.ones(1)])
            hi.extend([sc.LEG_SOFT_UPPER_JOINT_LIMITS[0:6], np.ones(1)])
        if self.use_torso:
            lo.append(sc.TORSO_LOWER)
            hi.append(sc.TORSO_UPPER)
        return np.stack([np.concatenate(lo), np.concatenate(hi)], axis=-1)

    def task_to_sim_ctrl(self, controls: jnp.ndarray) -> jnp.ndarray:
        """Compact action -> 25-dim policy command, pure jnp (spot_base.py:325-391)."""
        controls = jnp.asarray(controls)
        dtype = controls.dtype
        base_end = 3
        arm_end = base_end + (7 if self.use_arm else 0)
        grip_sel_end = arm_end + (1 if (self.use_arm and self.use_gripper) else 0)
        legs_end = grip_sel_end + (6 if self.use_legs else 0)
        leg_sel_end = legs_end + (1 if self.use_legs else 0)
        torso_end = leg_sel_end + (3 if self.use_torso else 0)
        assert torso_end == self.nu, (torso_end, self.nu)

        out = jnp.broadcast_to(
            jnp.asarray(self.default_policy_command, dtype), controls.shape[:-1] + (25,)
        )
        out = out.at[..., 0:3].set(controls[..., 0:3])
        if self.use_arm:
            arm = controls[..., base_end:arm_end]
            if self.use_gripper:
                # gripper selection < 0 -> closed (spot_base.py:289-296)
                sel = controls[..., grip_sel_end - 1]
                grip = jnp.where(sel < 0.0, sc.GRIPPER_CLOSED_POS, arm[..., 6])
                arm = arm.at[..., 6].set(grip)
            out = out.at[..., 3:10].set(arm)
        if self.use_legs:
            leg = controls[..., grip_sel_end:legs_end]  # (..., 6) FL then FR
            sel = controls[..., leg_sel_end - 1]
            use_fl = (sel < -0.5)[..., None]
            use_fr = (sel > 0.5)[..., None]
            fl = jnp.where(use_fl, leg[..., 0:3], 0.0)
            fr = jnp.where(use_fr, leg[..., 3:6], 0.0)
            out = out.at[..., 10:13].set(fl)
            out = out.at[..., 13:16].set(fr)
        if self.use_torso:
            out = out.at[..., 22:25].set(controls[..., leg_sel_end:torso_end])
        return out

    def reward(self, states, sensors, controls, params, system_metadata=None):
        """Base reward: zeros (spot_base.py:393-413)."""
        return jnp.zeros(states.shape[0], states.dtype)

    def optimizer_warm_start(self) -> np.ndarray:
        return self.default_command.copy()

    @property
    def reset_arm_pos(self) -> np.ndarray:
        return sc.ARM_UNSTOWED_POS if self.use_arm else sc.ARM_STOWED_POS

    @property
    def reset_pose(self) -> np.ndarray:
        return np.array(
            [0, 0, sc.STANDING_HEIGHT, 1, 0, 0, 0, *sc.LEGS_STANDING_POS_RL, *self.reset_arm_pos]
        )

    def reset(self) -> None:
        self.data.qpos[:] = self.reset_pose
        self.data.qvel[:] = 0.0
        self.forward()

    def get_action_components(self) -> list[str]:
        """Names per action dim (spot_base.py:445-459)."""
        names = ["spot/base.vx", "spot/base.vy", "spot/base.vtheta"]
        if self.use_arm:
            names.extend(f"spot/{j}" for j in sc.ARM_JOINT_NAMES)
            if self.use_gripper:
                names.append("spot/gripper_selection")
        if self.use_legs:
            names.extend(f"spot/{j}" for j in sc.LEG_JOINT_NAMES[:6])
            names.append("spot/leg_selection")
        if self.use_torso:
            names.extend(["spot/torso.roll", "spot/torso.pitch", "spot/torso.height"])
        return names
