"""Policy-in-the-loop simulation backend (the 'real' Spot plant).

The equivalent of the reference's PolicyMJSimulation
(judo/simulation/policy_mj_simulation.py:84-147): each sim tick runs one
50 Hz locomotion-policy tick — observation -> MLP -> 19-dim ctrl — followed
by ``task.physics_substeps`` MuJoCo physics steps (100 Hz), carrying
``last_policy_output`` across ticks, and re-initializing on task switch.

Design note: the reference dispatches a single-rollout C++ threaded_rollout
per step. Here the *planning* rollouts run batched on the accelerator
(tasks/spot/policy.py); the plant is one environment at wall-clock rate — a
host job — so the policy tick runs as plain numpy (an 84->12 MLP is
microseconds on host, and the plant then needs no device round trip per
tick). The numpy path is parity-tested
against the jitted JAX stack (tests/test_simulation/test_policy_simulation.py).
"""

from __future__ import annotations

import numpy as np

from judo_tpu.simulation.mj_simulation import MJSimulation
from judo_tpu.tasks import Task
from judo_tpu.tasks.spot import spot_constants as sc

_NP_ACTIVATIONS = {
    "Relu": lambda x: np.maximum(x, 0.0),
    "Elu": lambda x: np.where(x > 0, x, np.expm1(x)),
    "Tanh": np.tanh,
    "Sigmoid": lambda x: 1.0 / (1.0 + np.exp(-x)),
    "LeakyRelu": lambda x: np.where(x > 0, x, 0.01 * x),
    "Softsign": lambda x: x / (1.0 + np.abs(x)),
    "Identity": lambda x: x,
}


def _np_quat_inv(q: np.ndarray) -> np.ndarray:
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def _np_quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate v by unit quaternion q (wxyz)."""
    w, x, y, z = q
    u = np.array([x, y, z])
    return 2.0 * np.dot(u, v) * u + (w * w - np.dot(u, u)) * v + 2.0 * w * np.cross(u, v)


class HostSpotPolicy:
    """Numpy evaluation of the locomotion policy for the host-side plant.

    Semantics match tasks/spot/policy.py (the jitted planning-side stack),
    which in turn matches the reference C++ System
    (mujoco_extensions/system/system_class.cpp:125-246).
    """

    def __init__(self, onnx_path: str | None = None) -> None:
        from judo_tpu.tasks.spot.policy import SpotPolicy

        jax_policy = SpotPolicy.load(onnx_path)
        self.layers = [
            (np.asarray(w, np.float64), np.asarray(b, np.float64))
            for (w, b) in jax_policy.mlp.weights
        ]
        self.activations = jax_policy.mlp.activations
        self.default_joint_pos = np.asarray(sc.DEFAULT_JOINT_POS, np.float64)
        self.mujoco_to_orbit = np.asarray(sc.MUJOCO_TO_ORBIT)
        self.orbit_to_mujoco_legs = np.asarray(sc.ORBIT_TO_MUJOCO_LEGS)

    def mlp(self, x: np.ndarray) -> np.ndarray:
        for (w, b), act in zip(self.layers, self.activations):
            x = x @ w + b
            if act:
                x = _NP_ACTIVATIONS[act](x)
        return x

    def observation(
        self, qpos: np.ndarray, qvel: np.ndarray, command: np.ndarray, last_output: np.ndarray
    ) -> np.ndarray:
        """84-dim observation (system_class.cpp:125-212; policy.py:62-90)."""
        inv_quat = _np_quat_inv(qpos[3:7])
        linvel_body = _np_quat_rotate(inv_quat, qvel[0:3])
        angvel = qvel[3:6]
        gravity = _np_quat_rotate(inv_quat, np.array([0.0, 0.0, -1.0]))
        joint_pos = (qpos[7:26] - self.default_joint_pos)[self.mujoco_to_orbit]
        joint_vel = qvel[6:25][self.mujoco_to_orbit]
        return np.concatenate(
            [linvel_body, angvel, gravity, command[0:3], command[3:10], command[10:22],
             command[22:25], joint_pos, joint_vel, last_output]
        )

    def control(self, policy_output: np.ndarray, command: np.ndarray) -> np.ndarray:
        """19-dim ctrl from policy output + command (system_class.cpp:215-246)."""
        legs = (0.2 * policy_output)[self.orbit_to_mujoco_legs] + self.default_joint_pos[:12]
        leg_cmd = command[10:22]
        for i in range(4):  # first-nonzero leg override (C++ else-if chain)
            block = leg_cmd[3 * i : 3 * i + 3]
            if np.linalg.norm(block) > 0:
                legs = legs.copy()
                legs[3 * i : 3 * i + 3] = block
                break
        return np.concatenate([legs, command[3:10]])

    def tick(
        self, qpos: np.ndarray, qvel: np.ndarray, command: np.ndarray, last_output: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """One policy tick: (ctrl (19,), policy_output (12,))."""
        obs = self.observation(qpos, qvel, command, last_output)
        out = self.mlp(obs)
        return self.control(out, command), out


class PolicySimulation(MJSimulation):
    """MuJoCo plant with the locomotion policy in the loop.

    Reference behavior parity (policy_mj_simulation.py):
    - one policy tick + physics_substeps mj_steps per Simulation.step
    - ``last_policy_output`` carried across steps, zeroed on task switch
    - falls back to plain actuator control for non-policy tasks
    """

    def __init__(self, task: Task) -> None:
        super().__init__(task)
        self._policy: HostSpotPolicy | None = None
        self._last_policy_output = np.zeros(sc.POLICY_OUTPUT_DIM)
        self._init_policy()

    def _init_policy(self) -> None:
        path = self.task.locomotion_policy_path
        self._policy = HostSpotPolicy(path) if path is not None else None
        self._last_policy_output = np.zeros(sc.POLICY_OUTPUT_DIM)

    def set_task_instance(self, task: Task) -> None:
        super().set_task_instance(task)
        self._init_policy()

    def reset_policy_state(self) -> None:
        self._last_policy_output = np.zeros(sc.POLICY_OUTPUT_DIM)

    @property
    def last_policy_output(self) -> np.ndarray:
        return self._last_policy_output.copy()

    @property
    def timestep(self) -> float:
        # one step() == one policy tick == task.dt (substeps folded in)
        if self._policy is not None:
            return float(self.task.dt)
        return super().timestep

    def step(self, command: np.ndarray) -> None:
        if self._policy is None:
            super().step(command)
            return
        if self.paused:
            return
        policy_cmd = np.asarray(self.task.task_to_sim_ctrl(command), np.float64).ravel()
        if policy_cmd.shape[0] != sc.COMMAND_DIM:
            raise ValueError(
                f"policy command has {policy_cmd.shape[0]} dims, expected {sc.COMMAND_DIM}"
            )
        d = self.data
        self.task.pre_sim_step()
        ctrl, self._last_policy_output = self._policy.tick(
            d.qpos, d.qvel, policy_cmd, self._last_policy_output
        )
        if ctrl.shape[0] != self.model.nu:
            raise ValueError(f"policy ctrl has {ctrl.shape[0]} dims, model.nu={self.model.nu}")
        d.ctrl[:] = ctrl
        import mujoco

        for _ in range(self.task.physics_substeps):
            mujoco.mj_step(self.model, d)
        self.task.post_sim_step()
