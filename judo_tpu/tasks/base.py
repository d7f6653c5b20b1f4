"""Task base: host-side model ownership + pure device reward functions.

API parity with judo/tasks/base.py:24-204 (nu, dt, actuator_ctrlrange, reset,
pre/post hooks, sim metadata, index helpers), split in two:

- the *host* side compiles MJCF via MuJoCo and owns MjData for the "real"
  simulation process (judo's dual model/sim_model split, base.py:40). Where
  MuJoCo is not installed, the benchmark tasks load their lowered model from
  the package instead (tasks/exported.py) and have no host simulation;
- the *device* side gets a lowered ``PhysicsModel`` for planning rollouts and
  a pure ``reward`` function of (states, sensors, controls, params, metadata)
  that jits and vmaps — config values flow in through the ``params`` pytree
  produced by ``task_params()`` so reward changes never trigger recompiles.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Generic, TypeVar

import jax.numpy as jnp
import numpy as np

from judo_tpu.physics import PhysicsModel, put_model

try:
    import mujoco
except ModuleNotFoundError:  # planner-only install: see tasks/exported.py
    mujoco = None


@dataclass
class TaskConfig:
    """Base task configuration dataclass."""


ConfigT = TypeVar("ConfigT", bound=TaskConfig)


def config_to_params(cfg: Any, dtype=jnp.float32) -> dict[str, Any]:
    """Lower a config dataclass to a pytree of device arrays.

    Numeric and ndarray fields become jnp leaves; bools/strings stay host-side
    (read statically by the task, changing them re-specializes the solver).
    Nested dataclasses lower recursively.
    """
    out: dict[str, Any] = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            out[f.name] = config_to_params(v, dtype)
        elif isinstance(v, bool) or isinstance(v, str):
            continue
        elif isinstance(v, (int, float, np.ndarray, np.floating, np.integer)):
            out[f.name] = jnp.asarray(v, dtype)
    return out


class Task(Generic[ConfigT]):
    """Task definition (host model + device planning model + pure reward)."""

    name: str
    config_t: type[ConfigT]
    # contact-solver iterations for the *planning* model: planners trade
    # solver tightness for sequential depth (the sim side uses the model's
    # own opt.iterations)
    planning_solver_iterations: int = 25
    # optional planner-side collision pruning: None keeps every MuJoCo pair
    planner_collision_filter = None

    def __init__(
        self,
        model_path: Path | str = "",
        sim_model_path: Path | str | None = None,
        planning_dtype=jnp.float32,
    ) -> None:
        if not model_path:
            raise ValueError("Model path must be provided.")
        self.config = self.config_t()
        self.model_path = model_path
        self._planning_dtype = planning_dtype
        self._planning_model: PhysicsModel | None = None
        if mujoco is None:
            self._load_exported()
            return
        self.spec = mujoco.MjSpec.from_file(str(model_path))
        self._process_spec()
        self.model = self.spec.compile()
        self.data = mujoco.MjData(self.model)
        self.sim_model = (
            self.model if sim_model_path is None else mujoco.MjModel.from_xml_path(str(sim_model_path))
        )

    def _load_exported(self) -> None:
        """Host model/data stand-ins and the planning model from the
        package's exported file for this task (no MJCF compile)."""
        from judo_tpu.tasks.exported import load_task

        exported = load_task(self.name)
        pm = exported.planning_model
        if pm.qpos0.dtype != np.dtype(self._planning_dtype) or (
            pm.solver_iterations != self.planning_solver_iterations
        ):
            raise ValueError(
                f"exported model of '{self.name}' was lowered at {pm.qpos0.dtype} with "
                f"{pm.solver_iterations} solver iterations; regenerate it "
                "(python -m judo_tpu.tasks.exported)"
            )
        self.spec = None
        self.model = self.sim_model = exported.model
        self.data = exported.data
        self._planning_model = pm

    @property
    def planning_model(self) -> PhysicsModel:
        """Device planning model, lowered lazily on first use.

        The simulation process never touches it, so task construction on the
        sim side stays cheap; the controller pays the lowering cost once.
        """
        if self._planning_model is None:
            self._planning_model = put_model(
                self.model,
                dtype=self._planning_dtype,
                solver_iterations=self.planning_solver_iterations,
                collision_pair_filter=self.planner_collision_filter,
            )
        return self._planning_model

    def _process_spec(self) -> None:
        """Hook for subclasses to modify the spec before compile (base.py:42)."""

    # --- host-side state (the "real" sim process side) ---
    @property
    def time(self) -> float:
        return self.data.time

    @time.setter
    def time(self, value: float) -> None:
        self.data.time = value

    @property
    def nu(self) -> int:
        return self.model.nu

    @property
    def physics_substeps(self) -> int:
        return 1

    @property
    def dt(self) -> float:
        return self.model.opt.timestep * self.physics_substeps

    @property
    def locomotion_policy_path(self) -> str | None:
        return None

    @property
    def uses_locomotion_policy(self) -> bool:
        return self.locomotion_policy_path is not None

    @property
    def actuator_ctrlrange(self) -> np.ndarray:
        """Ctrl limits with unlimited actuators mapped to +-inf (base.py:99-105)."""
        limits = self.model.actuator_ctrlrange.copy()
        limited = self.model.actuator_ctrllimited.astype(bool)
        limits[~limited] = np.array([-np.inf, np.inf])
        return limits

    def forward(self) -> None:
        """Recompute the host data's derived quantities (``mj_forward``).
        An exported model has no host kinematics: its body poses keep their
        exported values."""
        if mujoco is not None:
            mujoco.mj_forward(self.model, self.data)

    def reset(self) -> None:
        """Reset host sim state (default: zeros)."""
        self.data.qpos = np.zeros_like(self.data.qpos)
        self.data.qvel = np.zeros_like(self.data.qvel)
        self.forward()

    # --- device-side pure functions ---
    def task_params(self, dtype=jnp.float32) -> dict[str, Any]:
        """Dynamic reward parameters from the live config."""
        return config_to_params(self.config, dtype)

    def reward(
        self,
        states: jnp.ndarray,
        sensors: jnp.ndarray,
        controls: jnp.ndarray,
        params: dict[str, Any],
        system_metadata: dict[str, Any] | None = None,
    ) -> jnp.ndarray:
        """Pure batched reward: (R,T,nq+nv),(R,T,nsensordata),(R,T,nu) -> (R,).

        Must only read static structure from ``self`` (indices, flags) — all
        config values come through ``params``.
        """
        raise NotImplementedError

    def pre_rollout(self, curr_state: np.ndarray) -> dict[str, Any]:
        """Host hook before a solve; returns extra metadata entries (e.g. the
        fr3 phase computation). Default: nothing."""
        return {}

    def post_rollout(self, states, sensors, controls, system_metadata=None) -> None:
        """Host hook after a solve (does nothing by default)."""

    def pre_sim_step(self) -> None: ...

    def post_sim_step(self) -> None: ...

    def get_sim_metadata(self) -> dict[str, Any]:
        """Sim-process -> controller-process metadata (base.py:152-164)."""
        return {}

    def optimizer_warm_start(self) -> np.ndarray:
        return np.zeros(self.nu)

    def task_to_sim_ctrl(self, controls: jnp.ndarray) -> jnp.ndarray:
        """Task-format -> sim-format controls; identity by default. Pure."""
        return controls

    # --- index helpers (base.py:180-204) ---
    def get_sensor_start_index(self, sensor_name: str) -> int:
        return self.model.sensor(sensor_name).adr[0]

    def get_joint_position_start_index(self, joint_name: str) -> int:
        return self.model.jnt_qposadr[self.model.joint(joint_name).id]

    def get_joint_velocity_start_index(self, joint_name: str) -> int:
        return self.model.nq + self.model.jnt_dofadr[self.model.joint(joint_name).id]
