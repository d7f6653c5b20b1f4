"""Contact-solver accuracy regression test.

Pins the APGD dual solver's accuracy on REAL mid-rollout leap_cube states
against a 300-iteration reference — so a future "speed up by dropping
iterations / loosening the Lipschitz bound" change cannot silently degrade
contact physics while the rest of the suite stays green.

Regimes pinned (measured values in parens, scratch r4):

- WARM-STARTED tracking — the regime the rollout actually runs in (efc
  forces carried across steps): 8 iterations from a converged warm start
  track the reference to ~2e-5 relative. This is the load-bearing bound.
- COLD start at the stock budget: convergence from f=0 is slow on these
  highly-coupled grasp states (~0.8 relative after 25 iters — forces need a
  few steps of carry to converge after contact onset; trajectory-level
  accuracy is covered by test_scene_parity.py). Only boundedness/finiteness
  is asserted.
- More iterations must only refine (CW is a valid upper bound, so APGD
  cannot diverge).

Runs the lanes formulation (lane_step.step_l, as lane_rollout.py scans it)
under jit on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from judo_tpu.physics.lane_step import step_l
from judo_tpu.physics.lane_rollout import rollout_lanes
from judo_tpu.tasks.leap_cube import LeapCube


@pytest.fixture(scope="module")
def mid_rollout_state():
    """Contact-rich states 30 steps into a leap rollout (B=8 lanes)."""
    task = LeapCube()
    pm = task.planning_model
    B = 8
    rng = np.random.default_rng(0)
    warm = np.asarray(task.optimizer_warm_start(), np.float32)
    qp0 = jnp.asarray(np.tile(task.data.qpos, (B, 1)), jnp.float32)
    qv0 = jnp.zeros((B, pm.nv), jnp.float32)
    ct = jnp.asarray(
        warm[None, None] + 0.05 * rng.standard_normal((B, 30, pm.nu)), jnp.float32
    )
    out = jax.jit(lambda a, b, c: rollout_lanes(pm, a, b, c))(qp0, qv0, ct)
    qp = out.states[:, -1, : pm.nq].T  # (nq, B)
    qv = out.states[:, -1, pm.nq :].T
    ctrl = ct[:, -1].T

    step = jax.jit(
        lambda f, it: step_l(pm, qp, qv, ctrl, f, solver_iterations=it, lipschitz="cw"),
        static_argnums=1,
    )
    ref = step(None, 300)
    return pm, np.asarray(qv), ref, step


def test_warm_started_tracking_accuracy(mid_rollout_state):
    """The shipped regime: 8 iterations from a warm start track a 300-iter
    reference to ~2e-5 (measured); assert well under 1e-3."""
    pm, qv, ref, step = mid_rollout_state
    dv_ref = np.asarray(ref.qvel) - qv
    scale = max(np.abs(dv_ref).max(), 1e-9)
    out = step(ref.efc_force, 8)
    rel = np.abs((np.asarray(out.qvel) - qv) - dv_ref).max() / scale
    assert rel < 1e-3, f"warm-started relative dv error {rel:.2e} >= 1e-3"


def test_cold_start_bounded(mid_rollout_state):
    """Cold starts at the stock budget must stay bounded and finite.

    Measured r5 (post cone fix): rel ~0.61 at 8 iterations, ~0.12 at 25 —
    the residual concentrates at newly-activated rows, where no warm start
    can help (verified: warm-starting from forces converged 5 steps earlier
    changes the bound by <1e-4). Production bounds the damage two ways:
    within a rollout the efc carry makes every step after the first warm
    (~3e-6 tracking), and ACROSS solves the controller carries step-0 forces
    (SolverState.efc_warm), so onset solves at the plant state are warm too.
    Trajectory-level accuracy is pinned by test_scene_parity.py."""
    pm, qv, ref, step = mid_rollout_state
    dv_ref = np.asarray(ref.qvel) - qv
    scale = max(np.abs(dv_ref).max(), 1e-9)
    out = step(None, max(pm.solver_iterations, 8))
    dv = np.asarray(out.qvel) - qv
    assert np.isfinite(dv).all()
    rel = np.abs(dv - dv_ref).max() / scale
    assert rel < 0.8, f"cold-start relative dv error {rel:.3f} >= 0.8 (regressed?)"


def test_cross_solve_efc_warm_carry(mid_rollout_state):
    """The rollout returns converged step-0 forces (efc0) and accepts them
    as the next solve's onset warm start (SolverState.efc_warm plumbing)."""
    from judo_tpu.physics.lane_rollout import rollout_lanes

    pm, qv, ref, step = mid_rollout_state
    task = LeapCube()
    B = 4
    rng = np.random.default_rng(1)
    warm = np.asarray(task.optimizer_warm_start(), np.float32)
    qp0 = jnp.asarray(np.tile(task.data.qpos, (B, 1)), jnp.float32)
    qv0 = jnp.zeros((B, pm.nv), jnp.float32)
    ct = jnp.asarray(warm[None, None] + 0.05 * rng.standard_normal((B, 30, pm.nu)), jnp.float32)
    out = rollout_lanes(pm, qp0, qv0, ct)
    qp1 = out.states[:, -1, : pm.nq]
    qv1 = out.states[:, -1, pm.nq :]
    out1 = rollout_lanes(pm, qp1, qv1, ct[:, :5])
    assert out1.efc0.shape == (B, out.efc0.shape[1])
    assert np.abs(np.asarray(out1.efc0)).max() > 1e-6, "grasp state must carry forces"
    out2 = rollout_lanes(pm, qp1, qv1, ct[:, :5], efc_warm=out1.efc0)
    assert np.isfinite(np.asarray(out2.states)).all()

    # step-level claim: warm-starting the ONSET solve from the carried efc0
    # (converged forces at this state) makes it track a 300-iteration
    # reference like the in-rollout warm regime, vs the cold ~0.6 relative
    qpT = qp1.T  # (nq, B) lanes layout
    qvT = qv1.T
    ctrlT = ct[:, 0].T
    ref_step = step_l(pm, qpT, qvT, ctrlT, None, solver_iterations=300)
    dv_ref = np.asarray(ref_step.qvel) - np.asarray(qvT)
    scale = max(np.abs(dv_ref).max(), 1e-9)
    cold = step_l(pm, qpT, qvT, ctrlT, None, solver_iterations=8)
    warm = step_l(pm, qpT, qvT, ctrlT, jnp.asarray(out1.efc0).T, solver_iterations=8)
    rel_cold = np.abs((np.asarray(cold.qvel) - np.asarray(qvT)) - dv_ref).max() / scale
    rel_warm = np.abs((np.asarray(warm.qvel) - np.asarray(qvT)) - dv_ref).max() / scale
    assert rel_warm < rel_cold, (rel_warm, rel_cold)
    # one carry hop reaches <0.1 (measured 0.057 vs cold 0.61 — the carried
    # forces are themselves a stock-budget solve, so successive control
    # cycles refine toward the warm-tracking regime); the "<0.1 at stock
    # iterations" onset bound is met through this carry
    assert rel_warm < 0.1, f"warm onset rel {rel_warm:.2e} (>= 0.1)"


def test_converged_forces_respect_friction_cone(mid_rollout_state):
    """Converged elliptic forces must satisfy ||f_t|| <= mu * f_n per contact.

    Advisor r4 (high): Jacobi preconditioning with per-row reg (reg_t =
    reg_n/impratio) distorts the SOC, and projecting with the ORIGINAL mu in
    the scaled space converges to forces violating the cone by ~5%. Fixed by
    projecting with mu' = mu * inv_s_n / inv_s_t; this test pins it.
    """
    from judo_tpu.physics.lane_collision import find_contacts_l
    from judo_tpu.physics.lane_engine import kinematics_l
    from judo_tpu.physics.solver import num_noncontact_rows

    pm, qv, ref, step = mid_rollout_state
    assert not pm.cone_pyramidal
    f = np.asarray(ref.efc_force)  # (nefc, B)
    n0 = num_noncontact_rows(pm)
    nc = (f.shape[0] - n0) // 3
    # static per-candidate friction, same construction as step_l
    task = LeapCube()
    kin = kinematics_l(pm, jnp.asarray(np.tile(task.data.qpos, (4, 1)).T, jnp.float32))
    mus = np.asarray(find_contacts_l(pm, kin).friction, np.float32)
    assert mus.shape[0] == nc
    fn = f[n0 : n0 + nc]
    ft = np.sqrt(f[n0 + nc : n0 + 2 * nc] ** 2 + f[n0 + 2 * nc :] ** 2)
    # relative cone violation, zero-force contacts excluded via the floor
    viol = (ft - mus[:, None] * fn) / np.maximum(mus[:, None] * np.abs(fn), 1e-6)
    assert fn.min() >= -1e-5, "normal forces must be nonnegative"
    assert viol.max() < 1e-3, f"friction-cone violation {viol.max():.2%} (>=0.1%)"


def test_more_iterations_do_not_diverge(mid_rollout_state):
    """The CW bound is a valid upper bound: doubling iterations must only
    refine the solution, never blow up."""
    pm, qv, ref, step = mid_rollout_state
    dv_ref = np.asarray(ref.qvel) - qv
    scale = max(np.abs(dv_ref).max(), 1e-9)
    e_lo = np.abs((np.asarray(step(None, 25).qvel) - qv) - dv_ref).max() / scale
    e_hi = np.abs((np.asarray(step(None, 100).qvel) - qv) - dv_ref).max() / scale
    assert np.isfinite(e_lo) and np.isfinite(e_hi)
    assert e_hi <= e_lo + 1e-6
