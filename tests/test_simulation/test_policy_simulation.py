"""Policy-in-the-loop simulation backend tests.

Covers the reference PolicyMJSimulation contract
(judo/simulation/policy_mj_simulation.py:84-147, tests/test_simulation/
test_simulation.py:40-58) plus this build's guarantee that the
host-side numpy policy path matches the jitted JAX planning stack exactly.
"""

import numpy as np
import pytest

from judo_tpu.simulation import MJSimulation, PolicySimulation, get_simulation_backend
from judo_tpu.tasks import get_registered_tasks


@pytest.fixture(scope="module")
def spot_sim() -> PolicySimulation:
    task_cls, _ = get_registered_tasks()["spot_navigate"]
    return PolicySimulation(task_cls())


def test_registry_has_policy_backend():
    assert get_simulation_backend("mujoco_policy") is PolicySimulation


def test_host_policy_matches_jax_stack(spot_sim):
    """numpy obs/MLP/ctrl == the jitted planning-side policy.py stack."""
    import jax.numpy as jnp

    from judo_tpu.tasks.spot.policy import (
        SpotPolicy,
        build_observation,
        control_from_policy,
    )

    host = spot_sim._policy
    jax_policy = SpotPolicy.load(dtype=jnp.float64)
    rng = np.random.default_rng(0)
    for _ in range(5):
        qpos = np.asarray(spot_sim.task.reset_pose, np.float64)
        qpos += 0.02 * rng.standard_normal(qpos.shape)
        qpos[3:7] /= np.linalg.norm(qpos[3:7])
        qvel = 0.1 * rng.standard_normal(spot_sim.model.nv)
        cmd = rng.standard_normal(25)
        last = 0.1 * rng.standard_normal(12)

        obs_np = host.observation(qpos, qvel, cmd, last)
        obs_jx = np.asarray(
            build_observation(jax_policy, jnp.asarray(qpos), jnp.asarray(qvel),
                              jnp.asarray(cmd), jnp.asarray(last))
        )
        np.testing.assert_allclose(obs_np, obs_jx, atol=1e-12)

        out_np = host.mlp(obs_np)
        out_jx = np.asarray(jax_policy.mlp(jnp.asarray(obs_np)))
        np.testing.assert_allclose(out_np, out_jx, atol=1e-9)

        ctrl_np = host.control(out_np, cmd)
        ctrl_jx = np.asarray(control_from_policy(jax_policy, jnp.asarray(out_np), jnp.asarray(cmd)))
        np.testing.assert_allclose(ctrl_np, ctrl_jx, atol=1e-12)


def test_leg_override_first_nonzero_block(spot_sim):
    """control(): only the FIRST leg block with nonzero command overrides
    (the C++ else-if chain, system_class.cpp:215-246)."""
    host = spot_sim._policy
    out = np.zeros(12)
    cmd = np.zeros(25)
    cmd[13:16] = [0.5, 0.6, 0.7]  # leg block 1 (indices 10+3..10+5)
    cmd[19:22] = [0.1, 0.2, 0.3]  # leg block 3 also nonzero
    ctrl = host.control(out, cmd)
    default_legs = host.default_joint_pos[:12]
    np.testing.assert_allclose(ctrl[3:6], [0.5, 0.6, 0.7])  # block 1 overridden
    np.testing.assert_allclose(ctrl[9:12], default_legs[9:12])  # block 3 NOT (else-if)
    np.testing.assert_allclose(ctrl[0:3], default_legs[0:3])


def test_spot_step_runs_and_robot_stands(spot_sim):
    """Closed-loop contract: stepping a Spot task must not crash (the round-1
    failure: 25-dim ctrl into a 19-actuator model) and the policy keeps the
    robot upright under a zero command."""
    task = spot_sim.task
    task.reset()
    z0 = task.data.qpos[2]
    cmd = np.zeros(task.nu)
    for _ in range(100):  # 2 seconds at 50 Hz
        spot_sim.step(cmd)
    z = task.data.qpos[2]
    assert np.isfinite(task.data.qpos).all()
    assert z > 0.3, f"robot fell: base z={z:.3f} (started {z0:.3f})"
    assert spot_sim.last_policy_output.shape == (12,)
    assert np.any(spot_sim.last_policy_output != 0.0)


def test_step_advances_time_by_task_dt(spot_sim):
    task = spot_sim.task
    task.reset()
    t0 = task.data.time
    spot_sim.step(np.zeros(task.nu))
    assert task.data.time == pytest.approx(t0 + task.dt)
    assert spot_sim.timestep == pytest.approx(task.dt)


def test_policy_state_resets_on_task_switch(spot_sim):
    spot_sim.step(np.zeros(spot_sim.task.nu))
    assert np.any(spot_sim.last_policy_output != 0.0)
    spot_sim.set_task("spot_navigate")
    np.testing.assert_array_equal(spot_sim.last_policy_output, np.zeros(12))


def test_fallback_for_non_policy_task():
    """PolicySimulation degrades to plain MJSimulation semantics for tasks
    without a locomotion policy (reference step() routing)."""
    task_cls, _ = get_registered_tasks()["cartpole"]
    sim = PolicySimulation(task_cls())
    assert sim._policy is None
    q0 = sim.data.qpos.copy()
    sim.step(np.array([0.5]))
    assert not np.allclose(sim.data.qpos, q0) or sim.data.time > 0


def test_mj_simulation_rejects_wrong_ctrl_dim():
    """Exact-shape ctrl write: Spot's 25-dim policy command must raise a clear
    error on the plain backend instead of silently truncating."""
    task_cls, _ = get_registered_tasks()["spot_navigate"]
    sim = MJSimulation(task_cls())
    with pytest.raises(ValueError, match="mujoco_policy"):
        sim.step(np.zeros(sim.task.nu))


def test_simulation_node_auto_upgrades_backend():
    """SimulationNode picks the policy backend for locomotion tasks
    (reference judo/app/dora/simulation.py:34-43)."""
    from judo_tpu.app.bus import MessageBus
    from judo_tpu.app.nodes import SimulationNode

    node = SimulationNode(MessageBus(), "spot_navigate", backend="mujoco")
    assert isinstance(node.sim, PolicySimulation)
    node.step_once()  # must not crash

    node2 = SimulationNode(MessageBus(), "cartpole", backend="mujoco")
    assert isinstance(node2.sim, MJSimulation)
    assert not isinstance(node2.sim, PolicySimulation)
    node2._on_task("spot_navigate")
    assert isinstance(node2.sim, PolicySimulation)
    node2.step_once()
