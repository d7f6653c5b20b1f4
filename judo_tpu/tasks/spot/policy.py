"""Spot locomotion policy in the loop, pure JAX.

Re-expresses the reference's C++ policy-in-the-loop rollout
(mujoco_extensions/system/system_class.cpp:125-331) as a jitted scan:

- 84-dim observation builder (setObservation, system_class.cpp:125-212):
  [base linvel (body frame) 3, base angvel 3, projected gravity 3,
   torso vel cmd 3, arm cmd 7, leg cmd 12, torso pos cmd 3,
   (qpos-default) orbit 19, qvel orbit 19, last policy output 12]
- MLP inference (the ONNX network lowered by native/onnx_extract)
- control mapping (policyInference, system_class.cpp:215-246): legs =
  default + orbit->mujoco(0.2 * policy_out), arm passthrough, first-nonzero
  leg-command override (the C++ else-if chain, replicated faithfully)
- per command: one policy call + ``physics_substeps`` physics steps (50 Hz
  policy over 100 Hz physics), policy output carried across steps.

The wall-clock cutoff watchdog (system_class.cpp:292-327) has no equivalent:
every rollout has a fixed horizon and fixed iteration counts, so the batch
finishes together and none is cut short (SURVEY §2.4).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from judo_tpu.ops.math import quat_inv, quat_rotate
from judo_tpu.physics import PhysicsModel, PhysicsState
from judo_tpu.physics.step import RolloutOutput, step_with_forward
from judo_tpu.tasks.spot import spot_constants as sc
from judo_tpu.utils.onnx_loader import MLPPolicy, mlp_from_onnx


class SpotPolicy(NamedTuple):
    """The locomotion MLP + static joint-ordering metadata.

    The joint-order permutations are carried as constant permutation
    MATRICES, not gather indices: a permutation applied as a matmul fuses
    into the surrounding graph, where an index-array gather inside the
    rollout scan would not."""

    mlp: MLPPolicy
    default_joint_pos: jnp.ndarray  # (19,)
    mujoco_to_orbit: jnp.ndarray  # (19, 19) permutation matrix
    orbit_to_mujoco_legs: jnp.ndarray  # (12, 12) permutation matrix

    @staticmethod
    def load(path: str | None = None, dtype=jnp.float32) -> "SpotPolicy":
        if path is None:
            for cand in sc.SPOT_LOCOMOTION_POLICY_CANDIDATES:
                if str(cand) and __import__("pathlib").Path(cand).exists():
                    path = str(cand)
                    break
        if path is None:
            raise FileNotFoundError("spot_locomotion.onnx not found")
        return SpotPolicy(
            mlp=mlp_from_onnx(path, dtype),
            default_joint_pos=jnp.asarray(sc.DEFAULT_JOINT_POS, dtype),
            mujoco_to_orbit=jnp.asarray(np.eye(19)[np.asarray(sc.MUJOCO_TO_ORBIT)], dtype),
            orbit_to_mujoco_legs=jnp.asarray(np.eye(12)[np.asarray(sc.ORBIT_TO_MUJOCO_LEGS)], dtype),
        )


def build_observation(
    policy: SpotPolicy, qpos: jnp.ndarray, qvel: jnp.ndarray, command: jnp.ndarray,
    last_policy_output: jnp.ndarray,
) -> jnp.ndarray:
    """84-dim policy observation from the current state + 25-dim command."""
    dtype = qpos.dtype
    base_quat = qpos[3:7]
    inv_quat = quat_inv(base_quat)
    linvel_body = quat_rotate(inv_quat, qvel[0:3])
    angvel = qvel[3:6]  # free-joint angular velocity is already body-frame
    gravity = quat_rotate(inv_quat, jnp.asarray([0.0, 0.0, -1.0], dtype))

    joint_pos = policy.mujoco_to_orbit @ (qpos[7:26] - policy.default_joint_pos)
    joint_vel = policy.mujoco_to_orbit @ qvel[6:25]

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
        ]
    )


def control_from_policy(
    policy: SpotPolicy, policy_output: jnp.ndarray, command: jnp.ndarray
) -> jnp.ndarray:
    """19-dim mujoco ctrl from policy output + command (system_class.cpp:215-246)."""
    legs = policy.orbit_to_mujoco_legs @ (0.2 * policy_output) + policy.default_joint_pos[:12]
    # first-nonzero leg override (C++ else-if chain), as a per-leg blend mask
    # instead of dynamic_slice/update (dynamic indexing is slow inside scans)
    leg_cmd = command[10:22]
    norms = jnp.stack([jnp.linalg.norm(leg_cmd[3 * i : 3 * i + 3]) for i in range(4)])
    active = norms > 0
    first = jnp.argmax(active)  # first True (0 if none; gated below)
    any_active = jnp.any(active)
    is_first = (jnp.arange(4) == first) & any_active  # (4,) one-hot, all-false if none
    mask = jnp.repeat(is_first, 3).astype(legs.dtype)  # (12,)
    legs = jnp.where(mask > 0, leg_cmd, legs)
    arm = command[3:10]
    return jnp.concatenate([legs, arm])


def spot_policy_step(
    m: PhysicsModel,
    policy: SpotPolicy,
    s: PhysicsState,
    command: jnp.ndarray,
    last_policy_output: jnp.ndarray,
    physics_substeps: int = 2,
    f_warm: jnp.ndarray | None = None,
    minv_warm: jnp.ndarray | None = None,
    mhinv_warm: jnp.ndarray | None = None,
):
    """One 50 Hz policy tick: observation -> MLP -> ctrl -> substeps physics.

    ``minv_warm``/``mhinv_warm`` optionally carry the previous tick's mass
    matrix inverses for Newton-Schulz temporal warm-starting (step.py).
    """
    obs = build_observation(policy, s.qpos, s.qvel, command, last_policy_output)
    policy_output = policy.mlp(obs)
    ctrl = control_from_policy(policy, policy_output, command)
    res = None
    for _ in range(physics_substeps):
        s, res, mhinv_warm = step_with_forward(m, s, ctrl, f_warm, minv_warm, mhinv_warm)
        minv_warm = res.minv
        if f_warm is None or res.efc_force.shape == f_warm.shape:
            f_warm = res.efc_force
    return s, policy_output, res, minv_warm, mhinv_warm


class PolicyRolloutOutput(NamedTuple):
    states: jnp.ndarray  # (T, nq + nv)
    sensordata: jnp.ndarray  # (T, nsensordata)
    final_policy_output: jnp.ndarray  # (12,)


def policy_rollout(
    m: PhysicsModel,
    policy: SpotPolicy,
    s0: PhysicsState,
    commands: jnp.ndarray,  # (T, 25)
    last_policy_output: jnp.ndarray,  # (12,)
    physics_substeps: int = 2,
    reseed_every: int = 10,
) -> PolicyRolloutOutput:
    """The batched equivalent of System::rollout / threadedRollout: scan over
    commands with the policy in the loop; vmap for the candidate batch.

    Like physics.step.rollout, the Newton-Schulz inverse chain is re-seeded
    exactly every ``reseed_every`` commands via the shared seed_inverses()
    helper (nested block scan), bounding NS drift to one block.
    """

    from judo_tpu.physics.solver import num_constraint_rows
    from judo_tpu.physics.step import seed_inverses

    def body(carry, cmd):
        s, pout, f, minv, mhinv = carry
        s, pout, res, minv, mhinv = spot_policy_step(
            m, policy, s, cmd, pout, physics_substeps, f, minv, mhinv
        )
        return (s, pout, res.efc_force, minv, mhinv), (
            jnp.concatenate([s.qpos, s.qvel]),
            res.sensordata,
            pout,
        )

    f0 = jnp.zeros(num_constraint_rows(m), s0.qpos.dtype)

    T = commands.shape[0]
    K = max(1, min(int(reseed_every), T))
    n_blocks = -(-T // K)
    Tp = n_blocks * K
    if Tp != T:  # pad with the last command; outputs sliced back to T
        commands = jnp.concatenate([commands, jnp.repeat(commands[-1:], Tp - T, axis=0)], axis=0)
    cmd_blocks = commands.reshape(n_blocks, K, commands.shape[-1])

    def block(carry, cmds):
        s, pout, f = carry
        minv, mhinv = seed_inverses(m, s)
        (s, pout, f, _, _), outs = jax.lax.scan(body, (s, pout, f, minv, mhinv), cmds)
        return (s, pout, f), outs

    (_, _, _), (states, sensors, pouts) = jax.lax.scan(
        block, (s0, last_policy_output, f0), cmd_blocks
    )
    states = states.reshape(Tp, *states.shape[2:])[:T]
    sensors = sensors.reshape(Tp, *sensors.shape[2:])[:T]
    # the carried-forward policy output is the one computed at command T-1
    # (recorded per step so control padding cannot leak into the carry)
    pout_final = pouts.reshape(Tp, *pouts.shape[2:])[T - 1]
    return PolicyRolloutOutput(states, sensors, pout_final)
