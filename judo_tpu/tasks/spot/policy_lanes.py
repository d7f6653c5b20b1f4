"""Spot locomotion policy in the loop, LANES formulation.

The batch-last counterpart of policy.py for the lanes rollout: the 84-dim
observation builder, the locomotion MLP, and the ctrl mapping all operate on
(..., B) columns, so one policy tick for the whole batch is a handful of wide
elementwise ops plus four matmuls ((512,85)@(85,B) etc.) — versus the
reference's per-candidate ONNX-runtime threads
(mujoco_extensions/system/system_class.cpp:125-331) and the vmap path's
per-candidate MLP calls.

The MLP weights enter as bias-augmented [W^T | b] blocks
(``lanes_weight_tensors``), the joint-order permutations are rebuilt from
iota comparisons, and small constant vectors use jnp.full-based columns
(lane_engine.const_col).

Semantics are identical to policy.py (parity-tested:
tests/test_tasks/test_spot_policy_lanes.py); the cutoff-watchdog note there
applies here too — rollout time is deterministic by construction.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from judo_tpu.physics.lane_collision import first_true_onehot
from judo_tpu.physics.lane_engine import const_col, l_quat_rotate, usum
from judo_tpu.physics.lane_step import step_l
from judo_tpu.physics.model import PhysicsModel
from judo_tpu.tasks.spot import spot_constants as sc
from judo_tpu.tasks.spot.policy import SpotPolicy
from judo_tpu.utils.onnx_loader import _ACTIVATIONS

class SpotPolicyLanes(NamedTuple):
    """Lanes-side policy parameters.

    ``waugs``: per-layer bias-augmented (out, in+1) tensors [W^T | b].
    ``acts``: static activation names (never flattened through jit)."""

    waugs: tuple
    acts: tuple


def lanes_weight_tensors(policy: SpotPolicy, dtype=np.float32) -> list:
    """Host-side [W^T | b] blocks, one per MLP layer."""
    out = []
    for w, b in policy.mlp.weights:
        wt = np.asarray(jax.device_get(w), np.float64).T  # (out, in)
        bc = np.asarray(jax.device_get(b), np.float64)[:, None]  # (out, 1)
        out.append(np.concatenate([wt, bc], axis=1).astype(dtype))
    return out


def lanes_policy_params(policy: SpotPolicy, dtype=jnp.float32) -> SpotPolicyLanes:
    """Lanes policy params as device arrays of ``dtype``."""
    return SpotPolicyLanes(
        waugs=tuple(jnp.asarray(w, dtype) for w in lanes_weight_tensors(policy)),
        acts=tuple(policy.mlp.activations),
    )


def mlp_aug_l(lp: SpotPolicyLanes, x: jnp.ndarray) -> jnp.ndarray:
    """MLP on (in_dim, B) columns with bias-augmented weights."""
    B = x.shape[-1]
    for wa, act in zip(lp.waugs, lp.acts):
        xa = jnp.concatenate([x, jnp.ones((1, B), x.dtype)], axis=0)
        x = jnp.dot(wa.astype(x.dtype), xa, preferred_element_type=x.dtype)
        if act:
            x = _ACTIVATIONS[act](x)
    return x


def _perm_matrix(indices, dtype) -> jnp.ndarray:
    """(n, n) permutation P[i, j] = [j == indices[i]] from iota comparisons
    (no literal-array constants)."""
    n = len(indices)
    io = jax.lax.broadcasted_iota(jnp.int32, (n, n), 1).astype(dtype)
    idx = const_col([float(i) for i in indices], dtype)  # (n, 1)
    return (io == idx).astype(dtype)


def build_observation_l(
    qpos: jnp.ndarray,  # (nq, B)
    qvel: jnp.ndarray,  # (nv, B)
    command: jnp.ndarray,  # (25, B)
    last_policy_output: jnp.ndarray,  # (12, B)
) -> jnp.ndarray:
    """84-dim policy observation columns (policy.build_observation in lanes)."""
    dtype = qpos.dtype
    q = qpos[3:7]
    qinv = q * const_col([1.0, -1.0, -1.0, -1.0], dtype)
    linvel_body = l_quat_rotate(qinv, qvel[0:3])
    angvel = qvel[3:6]  # free-joint angular velocity is already body-frame
    down = jnp.broadcast_to(const_col([0.0, 0.0, -1.0], dtype), qvel[0:3].shape)
    gravity = l_quat_rotate(qinv, down)

    m2o = _perm_matrix(sc.MUJOCO_TO_ORBIT, dtype)
    djp = const_col(sc.DEFAULT_JOINT_POS, dtype)  # (19, 1)
    joint_pos = jnp.dot(m2o, qpos[7:26] - djp, preferred_element_type=dtype)
    joint_vel = jnp.dot(m2o, qvel[6:25], preferred_element_type=dtype)

    return jnp.concatenate(
        [
            linvel_body,
            angvel,
            gravity,
            command[0:3],  # torso vel cmd
            command[3:10],  # arm cmd
            command[10:22],  # leg cmd
            command[22:25],  # torso pos cmd
            joint_pos,
            joint_vel,
            last_policy_output,
        ],
        axis=0,
    )


def control_from_policy_l(policy_output: jnp.ndarray, command: jnp.ndarray) -> jnp.ndarray:
    """(12, B) policy output + (25, B) command -> (19, B) mujoco ctrl
    (policy.control_from_policy in lanes; the C++ first-nonzero else-if chain
    is the same first-true one-hot blend)."""
    dtype = policy_output.dtype
    o2m = _perm_matrix(sc.ORBIT_TO_MUJOCO_LEGS, dtype)
    djp12 = const_col(list(sc.DEFAULT_JOINT_POS)[:12], dtype)
    legs = jnp.dot(o2m, 0.2 * policy_output, preferred_element_type=dtype) + djp12
    leg_cmd = command[10:22]
    sq = leg_cmd * leg_cmd
    norms2 = [usum(sq[3 * i : 3 * i + 3], 0) for i in range(4)]  # (B,) each
    active = [n > 0 for n in norms2]
    is_first = first_true_onehot(active)  # first active leg wins; none -> all false
    mask = jnp.concatenate(
        [jnp.broadcast_to(f.astype(dtype)[None], (3, f.shape[-1])) for f in is_first], axis=0
    )  # (12, B)
    legs = jnp.where(mask > 0, leg_cmd, legs)
    arm = command[3:10]
    return jnp.concatenate([legs, arm], axis=0)


class PolicyLaneStepOut(NamedTuple):
    qpos: jnp.ndarray
    qvel: jnp.ndarray
    sensordata: jnp.ndarray
    efc_force: jnp.ndarray
    cw_v: jnp.ndarray
    policy_output: jnp.ndarray  # (12, B)


def spot_policy_step_l(
    m: PhysicsModel,
    lp: SpotPolicyLanes,
    qpos: jnp.ndarray,
    qvel: jnp.ndarray,
    command: jnp.ndarray,  # (25, B)
    last_policy_output: jnp.ndarray,  # (12, B)
    physics_substeps: int = 2,
    f_warm: jnp.ndarray | None = None,
    cw_v: jnp.ndarray | None = None,
    solver_iterations: int | None = None,
) -> PolicyLaneStepOut:
    """One 50 Hz policy tick in lanes: obs -> MLP -> ctrl -> substeps x step_l
    (policy.spot_policy_step, batch-last)."""
    obs = build_observation_l(qpos, qvel, command, last_policy_output)
    pout = mlp_aug_l(lp, obs)
    ctrl = control_from_policy_l(pout, command)
    out = None
    for _ in range(physics_substeps):
        out = step_l(
            m, qpos, qvel, ctrl, f_warm,
            solver_iterations=solver_iterations, cw_v=cw_v,
        )
        qpos, qvel, f_warm, cw_v = out.qpos, out.qvel, out.efc_force, out.cw_v
    return PolicyLaneStepOut(
        qpos=out.qpos, qvel=out.qvel, sensordata=out.sensordata,
        efc_force=out.efc_force, cw_v=out.cw_v, policy_output=pout,
    )
