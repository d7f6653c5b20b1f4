"""Self-hosted simulation backend: the JAX engine as the plant.

Runs one environment through judo_tpu.physics.step — useful for fully
device-resident experiments and for machines without MuJoCo (exported task
models, tasks/exported.py). State is mirrored back into the task's host data
so task hooks (post_sim_step goal logic etc.) keep working unchanged.
"""

from __future__ import annotations

import jax
import numpy as np

from judo_tpu.app.structs import MujocoState
from judo_tpu.physics import make_state, step
from judo_tpu.simulation.base import Simulation
from judo_tpu.tasks import Task


class JTSimulation(Simulation):
    def __init__(self, task: Task) -> None:
        super().__init__(task)
        self._bind_task()

    def _bind_task(self) -> None:
        self.pm = self.task.planning_model
        self._state = make_state(
            self.pm, qpos=self.task.data.qpos, qvel=self.task.data.qvel, time=self.task.data.time
        )
        # compile now, not on the first paced tick
        ctrl0 = np.zeros(self.pm.nu, self.pm.qpos0.dtype)
        self._step = jax.jit(lambda s, c: step(self.pm, s, c)).lower(self._state, ctrl0).compile()

    def set_task_instance(self, task: Task) -> None:
        super().set_task_instance(task)
        self._bind_task()

    def step(self, command: np.ndarray) -> None:
        if self.paused:
            return
        d = self.task.data
        # re-sync if the task reset its MjData behind our back
        if not np.allclose(d.qpos, np.asarray(self._state.qpos), atol=1e-12):
            self._state = make_state(self.pm, qpos=d.qpos, qvel=d.qvel, time=d.time)
        ctrl = np.asarray(self.task.task_to_sim_ctrl(command), self.pm.qpos0.dtype)
        self.task.pre_sim_step()
        self._state = self._step(self._state, ctrl)
        d.qpos[:] = np.asarray(self._state.qpos)
        d.qvel[:] = np.asarray(self._state.qvel)
        d.time = float(self._state.time)
        self.task.forward()  # refresh kinematics for viz/hooks
        self.task.post_sim_step()

    @property
    def timestep(self) -> float:
        return float(self.task.model.opt.timestep)

    @property
    def sim_state(self) -> MujocoState:
        d = self.task.data
        return MujocoState(
            time=float(d.time),
            qpos=d.qpos.copy(),
            qvel=d.qvel.copy(),
            xpos=d.xpos.copy(),
            xquat=d.xquat.copy(),
            mocap_pos=d.mocap_pos.copy(),
            mocap_quat=d.mocap_quat.copy(),
            sim_metadata=self.task.get_sim_metadata(),
        )
