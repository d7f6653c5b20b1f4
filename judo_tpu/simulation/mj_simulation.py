"""CPU-MuJoCo simulation backend (reference: judo/simulation/mj_simulation.py).

The real-time "plant" runs one environment at wall-clock rate — a host-side
job, so it stays on CPU MuJoCo while all planning rollouts run on the
accelerator (the reference's dual model/sim_model fidelity split,
judo/tasks/base.py:40, generalizes here to an engine split). Needs ``mujoco``;
where it is not installed, the ``judo_tpu`` backend (jt_simulation.py) steps
the JAX engine instead.
"""

from __future__ import annotations

import numpy as np

from judo_tpu.app.structs import MujocoState
from judo_tpu.simulation.base import Simulation
from judo_tpu.tasks import Task


class MJSimulation(Simulation):
    def __init__(self, task: Task) -> None:
        super().__init__(task)
        self._bind_task()

    def _bind_task(self) -> None:
        self.model = self.task.sim_model
        self.data = self.task.data

    def set_task_instance(self, task: Task) -> None:
        super().set_task_instance(task)
        self._bind_task()

    def step(self, command: np.ndarray) -> None:
        """task ctrl -> sim ctrl -> pre_sim_step -> mj_step -> post_sim_step
        (mj_simulation.py:33-46)."""
        if self.paused:
            return
        ctrl = np.asarray(self.task.task_to_sim_ctrl(command)).ravel()
        if ctrl.shape[0] != self.model.nu:
            raise ValueError(
                f"task_to_sim_ctrl produced {ctrl.shape[0]} dims but sim model has "
                f"nu={self.model.nu}; policy tasks need the 'mujoco_policy' backend"
            )
        self.data.ctrl[:] = ctrl
        import mujoco

        self.task.pre_sim_step()
        mujoco.mj_step(self.model, self.data)
        self.task.post_sim_step()

    @property
    def timestep(self) -> float:
        return float(self.model.opt.timestep)

    @property
    def sim_state(self) -> MujocoState:
        """Snapshot for the controller/visualizer (mj_simulation.py:57-68)."""
        d = self.data
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
