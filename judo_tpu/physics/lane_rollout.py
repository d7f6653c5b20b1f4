"""Batched rollouts in the lanes formulation (batch-last step_l under jit).

``rollout_lanes`` and ``policy_rollout_lanes`` scan ``step_l`` (and, for the
Spot stack, the lanes policy tick) over the horizon with the whole candidate
batch in the trailing axis of every array. XLA compiles the scan body; there
is no hand-written kernel on this path.

Replaces: the reference's threaded rollout loops
(judo/utils/mj_rollout_backend.py:84, mujoco_extensions .. system_class.cpp:272-331).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from judo_tpu.physics.lane_step import step_l
from judo_tpu.physics.model import PhysicsModel
from judo_tpu.physics.solver import num_constraint_rows


def lane_supported(m: PhysicsModel) -> bool:
    """True when every model feature is covered by the lanes step (same
    narrowphase coverage as the XLA path; unsupported pair types would be
    silently dropped there, so require exact coverage here)."""
    from judo_tpu.physics.collision import _KERNELS
    from judo_tpu.physics.model import EQ_JOINT

    for g1, g2 in m.collision_pairs:
        if (m.geom_type[g1], m.geom_type[g2]) not in _KERNELS:
            return False
    for e in range(m.neq):
        if m.eq_type[e] != EQ_JOINT:
            return False
    return True


def _xla_step_fn(m: PhysicsModel, iterations: int | None, lipschitz: str = "cw"):
    nefc = num_constraint_rows(m)
    ns = m.nsensordata

    def step_fn(qpos, qvel, ctrl, f, v):
        out = step_l(
            m, qpos, qvel, ctrl, f if nefc else None,
            solver_iterations=iterations, lipschitz=lipschitz,
            cw_v=v if nefc else None,
        )
        B = qpos.shape[-1]
        sens = out.sensordata if ns else jnp.zeros((1, B), qpos.dtype)
        fo = out.efc_force if nefc else jnp.zeros((1, B), qpos.dtype)
        vo = out.cw_v if nefc else jnp.zeros((1, B), qpos.dtype)
        return out.qpos, out.qvel, sens, fo, vo

    return step_fn


class PolicyLaneRolloutOutput(NamedTuple):
    states: jnp.ndarray  # (R, T, nq + nv)
    sensordata: jnp.ndarray  # (R, T, nsensordata)
    final_policy_output: jnp.ndarray  # (R, 12)


def policy_rollout_lanes(
    m: PhysicsModel,
    policy,
    qpos0: jnp.ndarray,  # (R, nq)
    qvel0: jnp.ndarray,  # (R, nv)
    commands: jnp.ndarray,  # (R, T, 25)
    last_policy_output: jnp.ndarray,  # (R, 12)
    physics_substeps: int = 2,
    iterations: int | None = None,
) -> PolicyLaneRolloutOutput:
    """Batched policy-in-the-loop rollout, lanes formulation (the Spot
    counterpart of rollout_lanes; semantics match vmap(policy.policy_rollout)
    with exact per-step inverses)."""
    R, T = commands.shape[0], commands.shape[1]
    nefc = num_constraint_rows(m)
    ns = m.nsensordata
    dtype = qpos0.dtype

    from judo_tpu.tasks.spot.policy_lanes import lanes_policy_params, spot_policy_step_l

    qp, qv, po = qpos0.T, qvel0.T, last_policy_output.T  # (nq|nv|12, R)
    ct = jnp.transpose(commands, (1, 2, 0))  # (T, 25, R)
    lp = lanes_policy_params(policy, dtype)
    f0 = jnp.zeros((max(nefc, 1), R), dtype)
    v0 = jnp.ones((max(nefc, 1), R), dtype)

    def body(carry, cmd_t):
        qp_, qv_, po_, f, v = carry
        out = spot_policy_step_l(
            m, lp, qp_, qv_, cmd_t, po_,
            physics_substeps=physics_substeps,
            f_warm=f if nefc else None, cw_v=v if nefc else None,
            solver_iterations=iterations,
        )
        fo = out.efc_force if nefc else f
        vo = out.cw_v if nefc else v
        return (out.qpos, out.qvel, out.policy_output, fo, vo), (
            out.qpos, out.qvel,
            out.sensordata if ns else jnp.zeros((1, R), dtype),
            out.policy_output,
        )

    _, (qps, qvs, senss, pouts) = jax.lax.scan(body, (qp, qv, po, f0, v0), ct)

    states = jnp.concatenate([qps, qvs], axis=1)  # (T, nq+nv, R)
    states = jnp.transpose(states, (2, 0, 1))
    senss = jnp.transpose(senss, (2, 0, 1))[:, :, :ns]
    final_pout = jnp.transpose(pouts[T - 1], (1, 0))  # (R, 12)
    return PolicyLaneRolloutOutput(states=states, sensordata=senss, final_policy_output=final_pout)


class LaneRolloutOutput(NamedTuple):
    states: jnp.ndarray  # (R, T, nq + nv)
    sensordata: jnp.ndarray  # (R, T, nsensordata)
    # converged step-0 constraint forces (R, nefc): carry into the NEXT
    # solve's efc_warm to warm-start contact onset (the plant state moves
    # little between control cycles) — the analogue of mjData's efc
    # warm-start persisting across the reference's per-thread rollouts
    efc0: jnp.ndarray | None = None


def rollout_lanes(
    m: PhysicsModel,
    qpos0: jnp.ndarray,  # (R, nq)
    qvel0: jnp.ndarray,  # (R, nv)
    controls: jnp.ndarray,  # (R, T, nu)
    physics_substeps: int = 1,
    iterations: int | None = None,
    lipschitz: str = "cw",
    efc_warm: jnp.ndarray | None = None,  # (R, nefc) onset warm start
) -> LaneRolloutOutput:
    """Batched rollout in the lanes formulation (states batch-first at the
    API boundary; one transpose each way per solve).

    Semantics match vmap(step.rollout) with exact per-step inverses: record
    post-step (qpos, qvel) and the final substep's pre-integration sensordata
    per command (mujoco.rollout convention).
    """
    R = controls.shape[0]
    nefc = num_constraint_rows(m)
    ns = m.nsensordata
    dtype = qpos0.dtype

    qp, qv = qpos0.T, qvel0.T  # (nq, R), (nv, R)
    ct = jnp.transpose(controls, (1, 2, 0))  # (T, nu, R)
    if efc_warm is None:
        f0 = jnp.zeros((max(nefc, 1), R), dtype)
    else:
        f0 = efc_warm.T.astype(dtype)  # (nefc, R)
    step_fn = _xla_step_fn(m, iterations, lipschitz=lipschitz)
    v0 = jnp.ones((max(nefc, 1), R), dtype)  # carried CW probe

    def body(carry, ctrl_t):
        qp, qv, f, v = carry
        sens = None
        for _ in range(physics_substeps):
            qp, qv, sens, f, v = step_fn(qp, qv, ctrl_t, f, v)
        return (qp, qv, f, v), (qp, qv, sens, f)

    (_, _, _, _), (qps, qvs, senss, fs) = jax.lax.scan(body, (qp, qv, f0, v0), ct)

    states = jnp.concatenate([qps, qvs], axis=1)  # (T, nq+nv, R)
    states = jnp.transpose(states, (2, 0, 1))  # (R, T, nq+nv)
    senss = jnp.transpose(senss, (2, 0, 1))[:, :, :ns]
    efc0 = jnp.transpose(fs[0], (1, 0))  # (R, max(nefc, 1))
    return LaneRolloutOutput(states=states, sensordata=senss, efc0=efc0)
