"""Golden tests of the Spot policy observation/control mapping against the
reference C++ spec (mujoco_extensions/system/system_class.cpp:103-246).

The reference implementation is transcribed here INDEPENDENTLY in numpy —
Eigen permutation semantics ((P x)[indices[i]] = x[i]) with the index vectors
copied verbatim from initializeSystemIndices(), and mju_* quaternion math
re-derived — so a transposed permutation or sign error in
judo_tpu/tasks/spot/policy.py cannot cancel out (both test sides would
otherwise be this repository's own code).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from judo_tpu.tasks.spot import spot_constants as sc
from judo_tpu.tasks.spot.policy import SpotPolicy, build_observation, control_from_policy

# --- verbatim from system_class.cpp:104-118 (Eigen PermutationMatrix.indices) ---
ORBIT_TO_MUJOCO_LEGS_IDX = np.array([0, 3, 6, 9, 1, 4, 7, 10, 2, 5, 8, 11])
MUJOCO_TO_ORBIT_LEGS_IDX = np.array([0, 4, 8, 1, 5, 9, 2, 6, 10, 3, 7, 11])
ORBIT_TO_MUJOCO_IDX = np.array([12, 0, 3, 6, 9, 13, 1, 4, 7, 10, 14, 2, 5, 8, 11, 15, 16, 17, 18])
MUJOCO_TO_ORBIT_IDX = np.array([1, 6, 11, 2, 7, 12, 3, 8, 13, 4, 9, 14, 0, 5, 10, 15, 16, 17, 18])
# verbatim from system_class.cpp:119-121 (mujoco joint order: 12 legs, 7 arm)
DEFAULT_JOINT_POS_CPP = np.array(
    [0.12, 0.5, -1, -0.12, 0.5, -1, 0.12, 0.5, -1, -0.12, 0.5, -1, 0, -0.9, 1.8, 0, -0.9, 0, -1.54]
)


def eigen_perm(indices: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Eigen PermutationMatrix P applied on the left: (P x)[indices[i]] = x[i]."""
    out = np.empty_like(x)
    out[indices] = x
    return out


def quat_conj(q):
    return np.array([q[0], -q[1], -q[2], -q[3]])


def quat_rot(q, v):
    """mju_rotVecQuat: rotate v by quaternion q ([w,x,y,z])."""
    w, x, y, z = q
    r = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
    return r @ v


def ref_observation(qpos, qvel, command, policy_output):
    """setObservation (system_class.cpp:125-212), transcribed."""
    inv_q = quat_conj(qpos[3:7])
    base_linvel = quat_rot(inv_q, qvel[0:3])
    base_angvel = qvel[3:6]
    proj_gravity = quat_rot(inv_q, np.array([0.0, 0.0, -1.0]))
    joint_pos = eigen_perm(MUJOCO_TO_ORBIT_IDX, qpos[7:26] - DEFAULT_JOINT_POS_CPP)
    joint_vel = eigen_perm(MUJOCO_TO_ORBIT_IDX, qvel[6:25])
    return np.concatenate(
        [
            base_linvel,
            base_angvel,
            proj_gravity,
            command[0:3],
            command[3:10],
            command[10:22],
            command[22:25],
            joint_pos,
            joint_vel,
            policy_output,
        ]
    )


def ref_control(policy_output, command):
    """policyInference control mapping (system_class.cpp:227-246), transcribed."""
    legs = eigen_perm(ORBIT_TO_MUJOCO_LEGS_IDX, 0.2 * policy_output)
    legs = DEFAULT_JOINT_POS_CPP[:12] + legs
    ctrl = np.concatenate([legs, command[3:10]])  # arm passthrough
    leg_cmd = command[10:22]
    for leg in range(4):  # the else-if chain: FIRST nonzero leg wins
        seg = leg_cmd[3 * leg : 3 * leg + 3]
        if np.linalg.norm(seg) > 0:
            ctrl[3 * leg : 3 * leg + 3] = seg
            break
    return ctrl


def _policy() -> SpotPolicy:
    """Permutation/default metadata only (no MLP needed for these paths),
    constructed exactly as SpotPolicy.load does."""
    return SpotPolicy(
        mlp=None,
        default_joint_pos=jnp.asarray(sc.DEFAULT_JOINT_POS, jnp.float64),
        mujoco_to_orbit=jnp.asarray(np.eye(19)[np.asarray(sc.MUJOCO_TO_ORBIT)], jnp.float64),
        orbit_to_mujoco_legs=jnp.asarray(
            np.eye(12)[np.asarray(sc.ORBIT_TO_MUJOCO_LEGS)], jnp.float64
        ),
    )


def test_default_joint_pos_matches_cpp():
    np.testing.assert_allclose(np.asarray(sc.DEFAULT_JOINT_POS), DEFAULT_JOINT_POS_CPP)


def test_observation_matches_cpp_random_states():
    rng = np.random.default_rng(0)
    pol = _policy()
    for _ in range(8):
        qpos = rng.standard_normal(26)
        qpos[3:7] /= np.linalg.norm(qpos[3:7])
        qvel = rng.standard_normal(25)
        cmd = rng.standard_normal(25)
        pout = rng.standard_normal(12)
        ours = np.asarray(
            build_observation(pol, jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(cmd), jnp.asarray(pout))
        )
        np.testing.assert_allclose(ours, ref_observation(qpos, qvel, cmd, pout), atol=1e-12)


def test_observation_hand_derived_static():
    """Standing still at the default pose, identity base quat: every derived
    segment is exactly known."""
    pol = _policy()
    qpos = np.concatenate([[0, 0, 0.52, 1, 0, 0, 0], DEFAULT_JOINT_POS_CPP])
    qvel = np.zeros(25)
    cmd = np.arange(25, dtype=float) / 10.0
    pout = np.full(12, 0.5)
    obs = np.asarray(
        build_observation(pol, jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(cmd), jnp.asarray(pout))
    )
    assert obs.shape == (84,)
    np.testing.assert_allclose(obs[0:3], 0.0)  # linvel
    np.testing.assert_allclose(obs[3:6], 0.0)  # angvel
    np.testing.assert_allclose(obs[6:9], [0, 0, -1.0])  # projected gravity
    np.testing.assert_allclose(obs[9:12], cmd[0:3])
    np.testing.assert_allclose(obs[12:19], cmd[3:10])
    np.testing.assert_allclose(obs[19:31], cmd[10:22])
    np.testing.assert_allclose(obs[31:34], cmd[22:25])
    np.testing.assert_allclose(obs[34:53], 0.0)  # joint pos deltas
    np.testing.assert_allclose(obs[53:72], 0.0)  # joint vels
    np.testing.assert_allclose(obs[72:84], 0.5)  # last policy output


def test_observation_hand_derived_rotated_base():
    """Base yawed +90 deg: world x-velocity reads as body -y; gravity stays
    -z under pure yaw."""
    pol = _policy()
    q = np.array([np.sqrt(0.5), 0, 0, np.sqrt(0.5)])  # +90 deg about z
    qpos = np.concatenate([[0, 0, 0.52], q, DEFAULT_JOINT_POS_CPP])
    qvel = np.zeros(25)
    qvel[0:3] = [1.0, 0, 0]
    obs = np.asarray(
        build_observation(
            pol, jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(np.zeros(25)), jnp.asarray(np.zeros(12))
        )
    )
    np.testing.assert_allclose(obs[0:3], [0, -1.0, 0], atol=1e-12)
    np.testing.assert_allclose(obs[6:9], [0, 0, -1.0], atol=1e-12)


def test_joint_pos_orbit_ordering_physical():
    """Perturb exactly one mujoco joint (FR hip = mujoco index 3) and confirm
    it lands at the orbit slot the C++ Eigen permutation sends it to."""
    pol = _policy()
    qpos = np.concatenate([[0, 0, 0.52, 1, 0, 0, 0], DEFAULT_JOINT_POS_CPP])
    qpos[7 + 3] += 0.25  # FR hip
    obs = np.asarray(
        build_observation(
            pol, jnp.asarray(qpos), jnp.asarray(np.zeros(25)), jnp.asarray(np.zeros(25)), jnp.asarray(np.zeros(12))
        )
    )
    jp = obs[34:53]
    expected = eigen_perm(MUJOCO_TO_ORBIT_IDX, qpos[7:26] - DEFAULT_JOINT_POS_CPP)
    np.testing.assert_allclose(jp, expected, atol=1e-12)
    # exactly one nonzero, at orbit slot MUJOCO_TO_ORBIT_IDX[3]
    (nz,) = np.nonzero(jp)
    assert list(nz) == [MUJOCO_TO_ORBIT_IDX[3]]
    assert jp[nz[0]] == pytest.approx(0.25)


def test_control_matches_cpp_random():
    rng = np.random.default_rng(1)
    pol = _policy()
    for _ in range(8):
        pout = rng.standard_normal(12)
        cmd = rng.standard_normal(25)
        ours = np.asarray(control_from_policy(pol, jnp.asarray(pout), jnp.asarray(cmd)))
        np.testing.assert_allclose(ours, ref_control(pout, cmd), atol=1e-12)


@pytest.mark.parametrize(
    "legs_commanded,expect_overridden",
    [
        ([], None),  # 0 legs -> pure policy control
        ([0], 0),  # FL only
        ([1], 1),  # FR only
        ([3], 3),  # HR only
        ([0, 2], 0),  # FL and HL commanded -> else-if chain: only FL applies
        ([1, 3], 1),  # FR and HR -> only FR
        ([2, 3], 2),  # HL and HR -> only HL
        ([0, 1, 2, 3], 0),  # all -> only FL
    ],
)
def test_control_leg_override_else_if_chain(legs_commanded, expect_overridden):
    """The C++ else-if chain (system_class.cpp:233-243): the FIRST leg with a
    nonzero 3-segment wins; all later commanded legs are IGNORED."""
    pol = _policy()
    pout = np.linspace(-1, 1, 12)
    cmd = np.zeros(25)
    for leg in legs_commanded:
        cmd[10 + 3 * leg : 13 + 3 * leg] = [1.0 + leg, 2.0 + leg, 3.0 + leg]
    ours = np.asarray(control_from_policy(pol, jnp.asarray(pout), jnp.asarray(cmd)))
    expected = ref_control(pout, cmd)
    np.testing.assert_allclose(ours, expected, atol=1e-12)

    base = ref_control(pout, np.zeros(25))  # no override
    for leg in range(4):
        seg = slice(3 * leg, 3 * leg + 3)
        if leg == expect_overridden:
            np.testing.assert_allclose(ours[seg], cmd[10 + 3 * leg : 13 + 3 * leg])
        else:
            np.testing.assert_allclose(ours[seg], base[seg])
