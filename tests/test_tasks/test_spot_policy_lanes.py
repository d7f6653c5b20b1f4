"""Lanes-vs-vmap parity for the Spot policy-in-the-loop path.

Layering:
- the policy MATH (observation builder, MLP, ctrl mapping) must match the
  vmap-path implementation exactly — same inputs, same outputs;
- one policy tick's PHYSICS may differ slightly between the formulations
  (exact in-kernel inverses vs the Newton-Schulz chain; APGD active-set
  boundaries at cold start — measured ~8e-3 qvel on the standing state,
  while BOTH sit ~6e-2 from MuJoCo's Newton solver), so trajectory-level
  agreement is asserted with a bound over a short horizon rather than
  elementwise equality over a long one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from judo_tpu.physics.model import make_state
from judo_tpu.physics.lane_rollout import policy_rollout_lanes
from judo_tpu.tasks.spot import policy as pv
from judo_tpu.tasks.spot import policy_lanes as pl_
from judo_tpu.tasks.spot.spot_navigate import SpotNavigate


@pytest.fixture(scope="module")
def spot():
    task = SpotNavigate()
    return task, task.planning_model, task.policy


def test_observation_mlp_ctrl_match_vmap_exactly(spot):
    task, pm, pol = spot
    rng = np.random.default_rng(0)
    qp = jnp.asarray(task.data.qpos, jnp.float32)
    qv = jnp.asarray(0.1 * rng.standard_normal(pm.nv), jnp.float32)
    cmd = jnp.asarray(0.1 * rng.standard_normal(25), jnp.float32)
    po = jnp.asarray(0.05 * rng.standard_normal(12), jnp.float32)

    obs_v = pv.build_observation(pol, qp, qv, cmd, po)
    obs_l = pl_.build_observation_l(qp[:, None], qv[:, None], cmd[:, None], po[:, None])[:, 0]
    np.testing.assert_allclose(np.asarray(obs_l), np.asarray(obs_v), rtol=0, atol=1e-6)

    pout_v = pol.mlp(obs_v)
    lp = pl_.lanes_policy_params(pol, jnp.float32)
    pout_l = pl_.mlp_aug_l(lp, obs_v[:, None])[:, 0]
    np.testing.assert_allclose(np.asarray(pout_l), np.asarray(pout_v), rtol=0, atol=1e-5)

    ctrl_v = pv.control_from_policy(pol, pout_v, cmd)
    ctrl_l = pl_.control_from_policy_l(pout_v[:, None], cmd[:, None])[:, 0]
    np.testing.assert_allclose(np.asarray(ctrl_l), np.asarray(ctrl_v), rtol=0, atol=1e-6)


def test_ctrl_first_nonzero_leg_override_matches_vmap(spot):
    """The C++ else-if chain edge cases: zero legs, one leg, several legs."""
    _, pm, pol = spot
    rng = np.random.default_rng(1)
    pout = jnp.asarray(0.1 * rng.standard_normal(12), jnp.float32)
    for active_legs in ([], [2], [1, 3], [0, 1, 2, 3]):
        cmd = np.zeros(25, np.float32)
        cmd[:3] = 0.3
        for leg in active_legs:
            cmd[10 + 3 * leg : 13 + 3 * leg] = 0.5 + leg
        cmd_j = jnp.asarray(cmd)
        ctrl_v = pv.control_from_policy(pol, pout, cmd_j)
        ctrl_l = pl_.control_from_policy_l(pout[:, None], cmd_j[:, None])[:, 0]
        np.testing.assert_allclose(np.asarray(ctrl_l), np.asarray(ctrl_v), rtol=0, atol=1e-6)


def test_policy_rollout_lanes_tracks_vmap(spot):
    task, pm, pol = spot
    R, T = 2, 2
    rng = np.random.default_rng(0)
    qp0 = jnp.asarray(np.tile(task.data.qpos, (R, 1)), jnp.float32)
    qv0 = jnp.zeros((R, pm.nv), jnp.float32)
    pout0 = jnp.zeros((R, 12), jnp.float32)
    cmds = jnp.asarray(0.1 * rng.standard_normal((R, T, 25)), jnp.float32)

    out_l = policy_rollout_lanes(pm, pol, qp0, qv0, cmds, pout0, physics_substeps=2)
    x0 = make_state(
        pm,
        qpos=jnp.asarray(task.data.qpos, jnp.float32),
        qvel=jnp.zeros(pm.nv, jnp.float32),
        time=jnp.asarray(0.0, jnp.float32),
    )
    out_v = jax.vmap(lambda c, p: pv.policy_rollout(pm, pol, x0, c, p, 2))(cmds, pout0)

    assert out_l.states.shape == out_v.states.shape
    # qpos tracks tightly; qvel carries the formulation delta at cold start
    dq = np.abs(np.asarray(out_l.states[..., : pm.nq] - out_v.states[..., : pm.nq])).max()
    dv = np.abs(np.asarray(out_l.states[..., pm.nq :] - out_v.states[..., pm.nq :])).max()
    assert dq < 5e-3, f"qpos divergence {dq}"
    assert dv < 0.2, f"qvel divergence {dv}"
    ds = np.abs(np.asarray(out_l.sensordata - out_v.sensordata)).max()
    assert ds < 5e-3, f"sensor divergence {ds}"
    dp = np.abs(np.asarray(out_l.final_policy_output - out_v.final_policy_output)).max()
    assert dp < 0.2, f"policy output divergence {dp}"
