"""Lowered task models, for machines where MuJoCo is not installed.

MuJoCo compiles a task's MJCF on the host (``Task.__init__``) and is the
reference for every physics test, but the planner itself never calls it: the
solve runs on the lowered ``PhysicsModel``. This module saves that lowered
model, plus the few ``MjModel``/``MjData`` fields the controller reads, to one
``.npz`` per task under ``judo_tpu/models/exported/``, and loads it back as
stand-ins for ``MjModel``/``MjData`` when ``mujoco`` cannot be imported.

Regenerate the files (on a machine with MuJoCo) after changing a scene, a
task's planning settings or the lowering:

    python -m judo_tpu.tasks.exported

The same command writes ``leap_cube_mj_step.npz``: a 50-step ``mj_step``
trajectory of the leap_cube scene (``mj_step_trajectory``), the reference the
on-card parity check compares against where MuJoCo is absent.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np

from judo_tpu.physics.model import PhysicsModel

EXPORT_DIR = Path(__file__).resolve().parent.parent / "models" / "exported"
# the tasks whose lowered models ship with the package (the benchmark tasks)
EXPORTED_TASKS = ("leap_cube", "spot_navigate")
PARITY_REFERENCE = EXPORT_DIR / "leap_cube_mj_step.npz"

# MjModel arrays the controller and the exported tasks read
_MODEL_ARRAYS = (
    "actuator_ctrlrange", "actuator_ctrllimited", "sensor_type", "sensor_adr",
    "jnt_qposadr", "jnt_dofadr", "qpos0",
)  # fmt: skip
# MjData arrays mirrored into the simulation's published state
_DATA_ARRAYS = ("qpos", "qvel", "ctrl", "mocap_pos", "mocap_quat", "xpos", "xquat")


class HostModel:
    """The subset of ``mujoco.MjModel`` that the controller path reads."""

    def __init__(self, sizes: dict, timestep: float, names: dict, arrays: dict) -> None:
        self.nq, self.nv, self.nu = sizes["nq"], sizes["nv"], sizes["nu"]
        self.nsensor, self.nsensordata = sizes["nsensor"], sizes["nsensordata"]
        self.opt = SimpleNamespace(timestep=timestep)
        self._names = names
        for k, v in arrays.items():
            setattr(self, k, v)

    def _lookup(self, kind: str, key: int | str) -> SimpleNamespace:
        names = self._names[kind]
        i = names.index(key) if isinstance(key, str) else int(key)
        return SimpleNamespace(id=i, name=names[i])

    def sensor(self, key: int | str) -> SimpleNamespace:
        view = self._lookup("sensor", key)
        view.adr = self.sensor_adr[view.id : view.id + 1]
        return view

    def joint(self, key: int | str) -> SimpleNamespace:
        return self._lookup("joint", key)


class ExportedTask(NamedTuple):
    model: HostModel
    data: SimpleNamespace  # MjData stand-in: qpos, qvel, ctrl, time, mocap/x poses
    planning_model: PhysicsModel


def export_path(task_name: str) -> Path:
    return EXPORT_DIR / f"{task_name}.npz"


def save_task(task, path: Path) -> None:
    """Write ``task``'s lowered planning model and host fields to ``path``."""
    pm = task.planning_model
    m, d = task.model, task.data
    meta = {
        "sizes": {k: int(getattr(m, k)) for k in ("nq", "nv", "nu", "nsensor", "nsensordata")},
        "timestep": float(m.opt.timestep),
        "names": {
            "sensor": [m.sensor(i).name for i in range(m.nsensor)],
            "joint": [m.joint(i).name for i in range(m.njnt)],
        },
        "static": {},
    }
    arrays = {}
    for f in dataclasses.fields(pm):
        v = getattr(pm, f.name)
        if f.metadata.get("static"):
            meta["static"][f.name] = v
        else:
            arrays[f"pm.{f.name}"] = np.asarray(v)
    arrays.update({f"model.{k}": np.asarray(getattr(m, k)) for k in _MODEL_ARRAYS})
    arrays.update({f"data.{k}": np.asarray(getattr(d, k)) for k in _DATA_ARRAYS})
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, meta=np.asarray(json.dumps(meta)), **arrays)


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def load_task(task_name: str) -> ExportedTask:
    """Load the exported model of ``task_name`` (see module docstring)."""
    path = export_path(task_name)
    if not path.exists():
        raise FileNotFoundError(
            f"MuJoCo is not installed and task '{task_name}' has no exported model "
            f"({path}); exported tasks: {EXPORTED_TASKS}"
        )
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        group = {
            prefix: {k.split(".", 1)[1]: z[k] for k in z.files if k.startswith(prefix + ".")}
            for prefix in ("pm", "model", "data")
        }
    static = {k: _tuples(v) for k, v in meta["static"].items()}
    pm = PhysicsModel(**static, **group["pm"])
    model = HostModel(meta["sizes"], meta["timestep"], meta["names"], group["model"])
    data = SimpleNamespace(time=0.0, **{k: v.copy() for k, v in group["data"].items()})
    return ExportedTask(model=model, data=data, planning_model=pm)


def mj_step_trajectory(task, steps: int):
    """``steps`` ``mj_step``s of ``task``'s planning scene from its reset data
    under a slow sinusoid around the optimizer warm start: the reference for
    the scene parity tests. Returns (qpos0, qvel0, ctrl, states, max ncon)."""
    import mujoco

    m = task.model
    d = mujoco.MjData(m)
    mujoco.mj_resetData(m, d)
    warm = np.asarray(task.optimizer_warm_start())
    if warm.shape[0] != m.nu:  # Spot: task actions are 25-dim commands, the
        warm = d.qpos[7 : 7 + m.nu].copy()  # plant ctrl is 19 joint targets
        amp = 0.02
    else:
        amp = 0.05
    rng = np.random.default_rng(3)
    ctrl = warm[None] + amp * np.sin(np.linspace(0, 3, steps))[:, None] * rng.standard_normal(
        (1, m.nu)
    )
    qpos0, qvel0 = d.qpos.copy(), d.qvel.copy()
    states = []
    ncon = 0
    for k in range(steps):
        d.ctrl[:] = ctrl[k]
        mujoco.mj_step(m, d)
        ncon = max(ncon, d.ncon)
        states.append(np.concatenate([d.qpos.copy(), d.qvel.copy()]))
    return qpos0, qvel0, ctrl, np.asarray(states), ncon


def save_parity_reference(path: Path, steps: int = 50) -> None:
    """Write ``mj_step_trajectory`` of leap_cube, with the model's own solver
    iteration count (the parity tests step at stock iterations)."""
    from judo_tpu.tasks.leap_cube import LeapCube

    task = LeapCube()
    qpos0, qvel0, ctrl, states, ncon = mj_step_trajectory(task, steps)
    np.savez_compressed(
        path, qpos0=qpos0, qvel0=qvel0, ctrl=ctrl, states=states, ncon=ncon,
        solver_iterations=int(task.model.opt.iterations),
    )


def rollout_parity_error(engine: str = "vmap", precision: str = "highest") -> float:
    """Max |qpos| error of the lowered leap_cube model at float32 against the
    committed ``mj_step`` reference (``PARITY_REFERENCE``), on JAX's default
    device. ``engine`` is the formulation rolled out: ``vmap``
    (physics.rollout) or ``lanes`` (lane_rollout.rollout_lanes, batch of 1);
    ``precision`` is the float32 matmul precision it is traced under."""
    import jax
    import jax.numpy as jnp

    from judo_tpu.physics import make_state, rollout
    from judo_tpu.physics.lane_rollout import rollout_lanes

    ref = np.load(PARITY_REFERENCE)
    pm = dataclasses.replace(
        load_task("leap_cube").planning_model, solver_iterations=int(ref["solver_iterations"])
    )
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    qpos0, qvel0, ctrl = f32(ref["qpos0"]), f32(ref["qvel0"]), f32(ref["ctrl"])

    def run(c):
        if engine == "vmap":
            return rollout(pm, make_state(pm, qpos=qpos0, qvel=qvel0), c).states
        return rollout_lanes(pm, qpos0[None], qvel0[None], c[None]).states[0]

    with jax.default_matmul_precision(precision):
        states = np.asarray(jax.jit(run)(ctrl))
    nq = pm.nq
    if not np.isfinite(states).all():
        return float("inf")
    return float(np.abs(states[:, :nq] - ref["states"][:, :nq]).max())


def main() -> None:
    from judo_tpu.tasks import get_registered_tasks

    tasks = get_registered_tasks()
    for name in EXPORTED_TASKS:
        save_task(tasks[name][0](), export_path(name))
        print(f"wrote {export_path(name)}")
    save_parity_reference(PARITY_REFERENCE)
    print(f"wrote {PARITY_REFERENCE}")


if __name__ == "__main__":
    main()
