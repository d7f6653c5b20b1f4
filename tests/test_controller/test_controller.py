"""Controller unit tests (reference: tests/test_controller/test_controller.py).

The multi-iteration threading test uses a mock optimizer that records every
nominal input, like the reference's MockOptimizerTrackNominalKnots
(test_controller.py:16-33), adapted to the pure sample/update interface.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from judo_tpu.controller import Controller, ControllerConfig, make_controller
from judo_tpu.optimizers import (
    PredictiveSampling,
    PredictiveSamplingConfig,
    get_registered_optimizers,
)
from judo_tpu.tasks import Cartpole


class TrackingPS(PredictiveSampling):
    """PS that carries the last nominal input in its state for inspection."""

    def init_state(self, dtype=jnp.float32):
        return {"last_nominal": jnp.zeros((self.num_nodes, self.nu), dtype)}

    def sample_from_noise(self, params, state, nominal, noise):
        samples, _ = super().sample_from_noise(params, (), nominal, noise)
        return samples, {"last_nominal": nominal}

    def sample(self, params, state, nominal, rng):
        noise = jax.random.normal(rng, (self.num_rollouts - 1, self.num_nodes, self.nu), nominal.dtype)
        return self.sample_from_noise(params, state, nominal, noise)

    def update(self, params, state, samples, rewards):
        new_nominal, _ = super().update(params, (), samples, rewards)
        return new_nominal, state


def _make_tracking_controller(max_opt_iters: int, seed: int) -> Controller:
    np.random.seed(seed)
    task = Cartpole()
    cfg = PredictiveSamplingConfig(num_rollouts=8, num_nodes=4)
    opt = TrackingPS(cfg, task.nu)
    cc = ControllerConfig(max_opt_iters=max_opt_iters, spline_order="zero", full_outputs=True)
    ctrl = Controller(cc, task, opt)
    # deterministic solver rng
    ctrl._carry = ctrl._carry.replace(rng=jax.random.key(seed))
    return ctrl


def test_max_opt_iters_threads_nominal_knots():
    """A 2-iter solve's second-iteration input must equal the 1-iter output.

    Mirrors the seeded-determinism check in the reference
    (test_controller.py:41-77).
    """
    c1 = _make_tracking_controller(max_opt_iters=1, seed=123)
    c2 = _make_tracking_controller(max_opt_iters=2, seed=123)
    # identical initial conditions
    state = np.array([0.5, 2.0, 0.1, -0.1])
    for c in (c1, c2):
        c.current_state = state.copy()
        c.time = 0.0
    c1.update_action()
    c2.update_action()

    one_iter_result = np.asarray(c1._carry.nominal_knots)
    two_iter_last_input = np.asarray(c2._carry.opt_state["last_nominal"])
    np.testing.assert_allclose(two_iter_last_input, one_iter_result, atol=1e-10)


@pytest.mark.parametrize("opt_name", sorted(get_registered_optimizers()))
def test_update_action_shape_contract(opt_name):
    """update_action output shapes for every registered optimizer
    (reference test_controller.py:80-112)."""
    np.random.seed(0)
    c = make_controller("cartpole", opt_name)
    c.controller_cfg.full_outputs = True  # contract test inspects the tensors
    c.update_action()
    R = c.optimizer_cfg.num_rollouts
    N = c.optimizer_cfg.num_nodes
    T = c.num_timesteps
    assert c.rewards.shape == (R,)
    assert c.nominal_knots.shape == (N, c.nu)
    assert c.times.shape == (N,)
    out = c.last_outputs
    assert out.states.shape == (R, T, c.model.nq + c.model.nv)
    assert out.rollout_controls.shape == (R, T, c.nu)
    assert np.isfinite(c.rewards).all()
    # action() evaluates the spline at arbitrary times
    a = c.action(float(c.times[0]) + 0.05)
    assert a.shape == (c.nu,)


def test_solver_respecializes_on_shape_change():
    np.random.seed(0)
    c = make_controller("cartpole", "ps")
    c.update_action()
    f1 = c._get_solve()
    c.optimizer_cfg.num_rollouts = 12
    c.update_action()
    assert c._get_solve() is not f1
    assert c.rewards.shape == (12,)
    # value-only change must NOT respecialize
    f2 = c._get_solve()
    c.optimizer_cfg.sigma = 0.3
    c.update_action()
    assert c._get_solve() is f2
    # toggling BACK to a previous shape must hit the LRU cache, not recompile
    c.optimizer_cfg.num_rollouts = 16
    assert c._get_solve() is f1


def test_horizon_bucketed_compile_cache():
    """A horizon slider drag triggers <= 1 build per 4-step bucket, and
    returning to a visited horizon reuses the cached solve."""
    np.random.seed(0)
    c = make_controller("cartpole", "ps")
    builds = 0
    orig = type(c)._build_solve

    def counting_build(self):
        nonlocal builds
        builds += 1
        return orig(self)

    type(c)._build_solve = counting_build
    try:
        # cartpole dt = 0.04 -> T = ceil(h/0.04), bucket = 4 steps = 0.16 s
        for h in np.arange(0.80, 1.12, 0.04):  # 8 drag positions, 3 buckets
            c.controller_cfg.horizon = float(h)
            c._get_solve()
        assert builds <= 3, builds
        c.controller_cfg.horizon = 0.80  # revisit: cache hit
        c._get_solve()
        assert builds <= 3, builds
    finally:
        type(c)._build_solve = orig


def test_num_nodes_change_reinterps_state():
    np.random.seed(0)
    c = make_controller("cartpole", "cem")
    c.update_action()
    c.optimizer_cfg.num_nodes = 6
    c.update_action()
    assert c.nominal_knots.shape == (6, c.nu)
    assert np.asarray(c._carry.opt_state["sigma"]).shape == (6, c.nu)


def test_cubic_forces_min_nodes():
    np.random.seed(0)
    c = make_controller("cartpole", "ps")
    c.controller_cfg.spline_order = "cubic"
    c.optimizer_cfg.num_nodes = 3
    with pytest.warns(UserWarning):
        c.update_action()
    assert c.optimizer_cfg.num_nodes == 4


def test_closed_loop_balances_cartpole():
    """Short closed loop from a near-upright start must stay balanced."""
    import mujoco

    np.random.seed(1)
    c = make_controller("cartpole", "ps")
    task = c.task
    d = task.data
    d.qpos[:] = [0.2, 0.15]
    d.qvel[:] = 0.0
    mujoco.mj_forward(task.model, d)

    from judo_tpu.app.structs import MujocoState

    for _ in range(75):
        c.update_states(
            MujocoState(d.time, d.qpos.copy(), d.qvel.copy(), None, None, None, None, {})
        )
        c.update_action()
        d.ctrl[:] = c.action(d.time)
        mujoco.mj_step(task.model, d)
    assert np.cos(d.qpos[1]) > 0.95, f"pole fell: qpos={d.qpos}"
    assert abs(d.qpos[0]) < 0.4
