"""Exported task models: what the planner uses where MuJoCo is absent.

The committed files must equal a fresh lowering (so a stale export fails
here, where mujoco is installed), the MuJoCo enum codes the engine hard-codes
must match the installed mujoco, and a controller must build and solve from
an exported model with mujoco unavailable."""

import dataclasses

import mujoco
import numpy as np
import pytest

from judo_tpu.physics import model as model_mod
from judo_tpu.tasks import base as task_base
from judo_tpu.tasks import get_registered_tasks
from judo_tpu.tasks.exported import (
    EXPORTED_TASKS,
    PARITY_REFERENCE,
    load_task,
    mj_step_trajectory,
)


@pytest.mark.parametrize("name", EXPORTED_TASKS)
def test_exported_model_matches_fresh_lowering(name):
    task = get_registered_tasks()[name][0]()
    fresh, exported = task.planning_model, load_task(name)
    for f in dataclasses.fields(fresh):
        a, b = getattr(fresh, f.name), getattr(exported.planning_model, f.name)
        if f.metadata.get("static"):
            assert a == b, f.name
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f.name)
    m = exported.model
    assert (m.nq, m.nv, m.nu, m.nsensor) == (task.model.nq, task.model.nv, task.model.nu, task.model.nsensor)
    assert m.opt.timestep == task.model.opt.timestep
    for i in range(task.model.nsensor):
        assert m.sensor(i).name == task.model.sensor(i).name
        assert m.sensor(m.sensor(i).name).adr[0] == task.model.sensor_adr[i]
    np.testing.assert_array_equal(m.actuator_ctrlrange, task.model.actuator_ctrlrange)


def test_parity_reference_matches_mj_step():
    from judo_tpu.tasks.leap_cube import LeapCube

    ref = np.load(PARITY_REFERENCE)
    task = LeapCube()
    qpos0, qvel0, ctrl, states, ncon = mj_step_trajectory(task, ref["states"].shape[0])
    np.testing.assert_array_equal(ref["ctrl"], ctrl)
    np.testing.assert_allclose(ref["states"], states, rtol=0, atol=1e-12)
    assert int(ref["ncon"]) == ncon >= 2
    assert int(ref["solver_iterations"]) == task.model.opt.iterations


def test_enum_codes_match_mujoco():
    S, O = mujoco.mjtSensor, mujoco.mjtObj
    assert model_mod.SENSOR_FRAMEPOS == S.mjSENS_FRAMEPOS
    assert model_mod.SENSOR_FRAMEQUAT == S.mjSENS_FRAMEQUAT
    assert model_mod.SENSOR_FRAMELINVEL == S.mjSENS_FRAMELINVEL
    assert model_mod.SENSOR_JOINTPOS == S.mjSENS_JOINTPOS
    assert model_mod.SENSOR_JOINTVEL == S.mjSENS_JOINTVEL
    assert model_mod.SENSOR_FRAMEXAXIS == S.mjSENS_FRAMEXAXIS
    assert model_mod.SENSOR_FRAMEYAXIS == S.mjSENS_FRAMEYAXIS
    assert model_mod.SENSOR_FRAMEZAXIS == S.mjSENS_FRAMEZAXIS
    assert model_mod.SENSOR_DISTANCE == S.mjSENS_GEOMDIST
    assert (model_mod._OBJ_BODY, model_mod._OBJ_XBODY) == (O.mjOBJ_BODY, O.mjOBJ_XBODY)
    assert (model_mod._OBJ_GEOM, model_mod._OBJ_SITE) == (O.mjOBJ_GEOM, O.mjOBJ_SITE)
    assert model_mod.EQ_JOINT == mujoco.mjtEq.mjEQ_JOINT
    assert model_mod.GEOM_BOX == mujoco.mjtGeom.mjGEOM_BOX
    assert model_mod.FREE == mujoco.mjtJoint.mjJNT_FREE


def test_controller_solves_from_exported_model_without_mujoco(monkeypatch):
    from judo_tpu.controller import Controller, ControllerConfig
    from judo_tpu.optimizers import MPPI, MPPIConfig
    from judo_tpu.tasks.leap_cube import LeapCube

    monkeypatch.setattr(task_base, "mujoco", None)
    np.random.seed(0)
    task = LeapCube()
    assert task.spec is None and not isinstance(task.model, mujoco.MjModel)
    opt = MPPI(MPPIConfig(num_rollouts=4, num_nodes=4), task.nu)
    c = Controller(ControllerConfig(horizon=0.04, spline_order="cubic"), task, opt)
    c.update_action()
    assert c.rewards.shape == (4,) and np.isfinite(c.rewards).all()
    assert c.trace_sensors == [i for i in range(task.model.nsensor) if "trace" in task.model.sensor(i).name]


def test_exported_task_refuses_other_planning_settings(monkeypatch):
    from judo_tpu.tasks.leap_cube import LeapCube

    class CoarseLeap(LeapCube):
        planning_solver_iterations = 3

    monkeypatch.setattr(task_base, "mujoco", None)
    with pytest.raises(ValueError, match="regenerate"):
        CoarseLeap()
