"""Full-scene trajectory parity vs CPU MuJoCo on the FLAGSHIP task scenes.

These step the actual leap_cube.xml (elliptic cone, impratio=100) and
fr3_pick.xml (pyramidal, jnt_actfrcrange-clamped arm) — the scenes the planner
actually plans on — with contacts active, in float64, against mj_step.

Ground truth: the reference's plant is mj_step on these models
(judo/simulation/mj_simulation.py:33-46).

Errors measured on the CPU at float64 with the Jacobi-preconditioned
CW-bounded APGD at stock model iterations: leap 0.0097 / fr3 0.0107 max
|qpos| over 50 steps. Tolerances are ~3x those. Known model deltas (bounded, accepted): box-box
manifold points come from clamped incident-face vertices rather than true
polygon clipping, and deep (>5 cm) capsule-box penetration recovers along a
different face than MuJoCo's — both below the asserted bounds on these
trajectories.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from judo_tpu.physics import make_state, put_model, rollout
from judo_tpu.tasks.exported import mj_step_trajectory


def _mj_trajectory(task, T):
    return mj_step_trajectory(task, T)


def _ours_trajectory(task, qpos0, qvel0, ctrl):
    pm = put_model(task.model, dtype=jnp.float64)
    x0 = make_state(pm, qpos=qpos0, qvel=qvel0)
    out = jax.jit(lambda c: rollout(pm, x0, c))(jnp.asarray(ctrl))
    return np.asarray(out.states)


@pytest.mark.parametrize(
    "task_name,tol",
    [
        ("leap_cube", 0.03),  # elliptic cone + impratio=100 (leap_cube.xml:4)
        ("fr3_pick", 0.05),  # pyramidal + arm actuatorfrcrange +-87
    ],
)
def test_flagship_scene_trajectory_parity(task_name, tol):
    _scene_parity(task_name, tol)


@pytest.mark.parametrize(
    "task_name",
    ["spot_box_push", "spot_tire_roll", "spot_tire_upright"],
)
def test_spot_object_scene_trajectory_parity(task_name):
    """The Spot object scenes (box-box and the capsule-ring tire
    approximation) vs mj_step — bounds the box-box
    manifold simplification on the contacts that matter. Measured 0.0189
    max |qpos| over 50 steps on all three scenes (r5, contacts active:
    box 8 / tire 6); tolerance ~2.5x that."""
    _scene_parity(task_name, 0.05)


def _scene_parity(task_name, tol):
    from judo_tpu.tasks import get_registered_tasks

    task_cls, _ = get_registered_tasks()[task_name]
    task = task_cls()
    T = 50
    qpos0, qvel0, ctrl, mj_states, ncon = _mj_trajectory(task, T)
    assert ncon >= 2, "trajectory must exercise contacts to be a meaningful test"
    ours = _ours_trajectory(task, qpos0, qvel0, ctrl)
    assert np.isfinite(ours).all()
    nq = task.model.nq
    err = np.abs(ours[:, :nq] - mj_states[:, :nq]).max()
    assert err < tol, f"{task_name} qpos trajectory error {err:.4f} >= {tol}"
