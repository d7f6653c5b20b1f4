"""Smooth (constraint-free) dynamics pipeline in JAX.

Implements the MuJoCo computation stages — kinematics, CoM-centered quantities,
composite-rigid-body mass matrix, recursive Newton-Euler bias forces, passive
spring/damper forces, and actuation — from first principles for a single state;
batching is vmap, time is lax.scan (see step.py).

Tree loops run over bodies at *trace* time (nbody is tens at most), so the
compiled program is a flat fused graph with no dynamic control flow — the
XLA-friendly formulation.

**No gathers or scatters anywhere in the hot path.** Gathers and scatters
inside a scan are slow next to fused elementwise ops, and scatters blow up
XLA compile time by orders of magnitude. Every indexed read of a *computed*
tensor is therefore expressed as a constant one-hot matmul (selection
matrices built in numpy at trace time), every indexed write as a stack /
concatenate over a static layout, and tree accumulations as mask matmuls.

This replaces the reference's CPU-threaded `mujoco.rollout` / C++
`System::rollout` hot loops (judo/utils/mj_rollout_backend.py:84,
mujoco_extensions/system/system_class.cpp:272-331).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from judo_tpu.ops.math import quat_mul, quat_rotate, quat_to_mat
from judo_tpu.physics.model import BALL, FREE, HINGE, SLIDE, PhysicsModel, PhysicsState
from judo_tpu.physics.spatial import motion_cross, motion_cross_force, spatial_inertia


class Kinematics(NamedTuple):
    xpos: jnp.ndarray  # (nbody, 3) body frame origins
    xquat: jnp.ndarray  # (nbody, 4)
    xmat: jnp.ndarray  # (nbody, 3, 3)
    xipos: jnp.ndarray  # (nbody, 3) body CoM positions
    ximat: jnp.ndarray  # (nbody, 3, 3) inertial frame orientation
    xanchor: jnp.ndarray  # (njnt, 3)
    xaxis: jnp.ndarray  # (njnt, 3)
    geom_xpos: jnp.ndarray  # (ngeom, 3)
    geom_xmat: jnp.ndarray  # (ngeom, 3, 3)
    site_xpos: jnp.ndarray  # (nsite, 3)
    site_xmat: jnp.ndarray  # (nsite, 3, 3)


class ComQuants(NamedTuple):
    subtree_com: jnp.ndarray  # (nbody, 3)
    cinert: jnp.ndarray  # (nbody, 6, 6) spatial inertia about tree-root CoM
    cdof: jnp.ndarray  # (nv, 6) dof motion axes [ang; lin] about tree-root CoM


class Velocity(NamedTuple):
    cvel: jnp.ndarray  # (nbody, 6)
    cdof_dot: jnp.ndarray  # (nv, 6)


def _axis_angle_quat(axis: jnp.ndarray, angle: jnp.ndarray) -> jnp.ndarray:
    half = 0.5 * angle
    return jnp.concatenate([jnp.cos(half)[None], axis * jnp.sin(half)], axis=0)


def _onehot(rows: int, cols: int, col_of_row, dtype) -> jnp.ndarray:
    """Constant selection matrix S with S[r, col_of_row[r]] = 1 (numpy-built,
    embedded as a literal): ``S @ X`` replaces the gather ``X[col_of_row]``."""
    s = np.zeros((rows, cols), np.float64)
    for r, c in enumerate(col_of_row):
        s[r, int(c)] = 1.0
    return jnp.asarray(s, dtype)


def kinematics(m: PhysicsModel, s: PhysicsState) -> Kinematics:
    """Forward kinematics (the semantics of mj_kinematics)."""
    dtype = s.qpos.dtype
    xpos = [jnp.zeros(3, dtype)]
    xquat = [jnp.array([1.0, 0, 0, 0], dtype)]
    xanchor = [None] * m.njnt
    xaxis = [None] * m.njnt

    for b in range(1, m.nbody):
        p = m.body_parentid[b]
        pos = xpos[p] + quat_rotate(xquat[p], m.body_pos[b])
        quat = quat_mul(xquat[p], m.body_quat[b])
        for k in range(m.body_jntnum[b]):
            j = m.body_jntadr[b] + k
            jt = m.jnt_type[j]
            qadr = m.jnt_qposadr[j]
            anchor = quat_rotate(quat, m.jnt_pos[j]) + pos
            axis = quat_rotate(quat, m.jnt_axis[j])
            if jt == FREE:
                pos = s.qpos[qadr : qadr + 3]
                quat = s.qpos[qadr + 3 : qadr + 7]
                quat = quat / jnp.linalg.norm(quat)
                anchor = pos
            elif jt == BALL:
                qloc = s.qpos[qadr : qadr + 4]
                qloc = qloc / jnp.linalg.norm(qloc)
                quat = quat_mul(quat, qloc)
                pos = anchor - quat_rotate(quat, m.jnt_pos[j])
            elif jt == SLIDE:
                pos = pos + axis * (s.qpos[qadr] - m.qpos0[qadr])
            elif jt == HINGE:
                angle = s.qpos[qadr] - m.qpos0[qadr]
                qloc = _axis_angle_quat(m.jnt_axis[j], angle)
                quat = quat_mul(quat, qloc)
                pos = anchor - quat_rotate(quat, m.jnt_pos[j])
            # axis must be recomputed after orientation updates for anchor use
            xanchor[j] = anchor
            xaxis[j] = quat_rotate(quat, m.jnt_axis[j]) if jt in (BALL, HINGE) else axis
        xpos.append(pos)
        xquat.append(quat)

    # per-geom/site frames composed directly from the per-body python values
    # (no gather: geom_bodyid is static, the lists hold the traced tensors)
    geom_xpos = [xpos[m.geom_bodyid[g]] for g in range(m.ngeom)]
    geom_xquat = [xquat[m.geom_bodyid[g]] for g in range(m.ngeom)]
    site_xpos = [xpos[m.site_bodyid[t]] for t in range(m.nsite)]
    site_xquat = [xquat[m.site_bodyid[t]] for t in range(m.nsite)]

    xpos = jnp.stack(xpos)
    xquat = jnp.stack(xquat)
    xmat = quat_to_mat(xquat)
    if m.njnt:
        xanchor = jnp.stack(xanchor)
        xaxis = jnp.stack(xaxis)
    else:  # pragma: no cover - degenerate static scene
        xanchor = jnp.zeros((0, 3), dtype)
        xaxis = jnp.zeros((0, 3), dtype)

    iquat = quat_mul(xquat, m.body_iquat)
    xipos = xpos + quat_rotate(xquat, m.body_ipos)
    ximat = quat_to_mat(iquat)

    if m.ngeom:
        gp = jnp.stack(geom_xpos)
        gq = jnp.stack(geom_xquat)
        gm = quat_to_mat(gq)
        geom_xpos_a = gp + jnp.einsum("gij,gj->gi", gm, m.geom_pos)
        geom_xmat_a = gm @ quat_to_mat(m.geom_quat)
    else:  # pragma: no cover
        geom_xpos_a = jnp.zeros((0, 3), dtype)
        geom_xmat_a = jnp.zeros((0, 3, 3), dtype)
    if m.nsite:
        sp = jnp.stack(site_xpos)
        sq = jnp.stack(site_xquat)
        sm = quat_to_mat(sq)
        site_xpos_a = sp + jnp.einsum("gij,gj->gi", sm, m.site_pos)
        site_xmat_a = sm @ quat_to_mat(m.site_quat)
    else:
        site_xpos_a = jnp.zeros((0, 3), dtype)
        site_xmat_a = jnp.zeros((0, 3, 3), dtype)

    return Kinematics(
        xpos, xquat, xmat, xipos, ximat, xanchor, xaxis,
        geom_xpos_a, geom_xmat_a, site_xpos_a, site_xmat_a,
    )


def _static_joint_groups(m: PhysicsModel):
    """Static per-type joint index groups (hashable inputs only)."""
    hinge, slide, ball, free = [], [], [], []
    for j in range(m.njnt):
        {HINGE: hinge, SLIDE: slide, BALL: ball, FREE: free}[m.jnt_type[j]].append(j)
    return hinge, slide, ball, free


def com_quantities(m: PhysicsModel, kin: Kinematics) -> ComQuants:
    """CoM-centered inertias and dof axes (the semantics of mj_comPos).

    All spatial quantities are expressed with world orientation about the
    subtree CoM of each kinematic tree's root body. Tree accumulations are
    mask matmuls; the (nv, 6) dof-axis matrix is built as one stack over the
    static dof layout instead of per-row scatter writes.
    """
    dtype = kin.xpos.dtype
    mass = m.body_mass
    mpos = mass[:, None] * kin.xipos
    sub_mass = m.subtree_mask @ mass
    subtree_com = (m.subtree_mask @ mpos) / jnp.maximum(sub_mass, 1e-12)[:, None]
    # root CoM per body: constant one-hot (nbody, nbody) selection matmul
    root_sel = _onehot(m.nbody, m.nbody, m.body_rootid, dtype)
    root_com = root_sel @ subtree_com  # (nbody, 3)

    inertia_world = kin.ximat @ (m.body_inertia[:, :, None] * kin.ximat.swapaxes(-1, -2))
    cinert = spatial_inertia(mass, inertia_world, kin.xipos - root_com)  # (nbody, 6, 6)

    # cdof rows in static dof order, one stack at the end (scatter-free)
    rows: list = [None] * m.nv
    eye = jnp.eye(3, dtype=dtype)
    zeros3 = jnp.zeros(3, dtype)
    for j in range(m.njnt):
        jt = m.jnt_type[j]
        b = m.jnt_bodyid[j]
        d = m.jnt_dofadr[j]
        off = kin.xanchor[j] - root_com[b]
        if jt == HINGE:
            ax = kin.xaxis[j]
            rows[d] = jnp.concatenate([ax, jnp.cross(ax, -off)])
        elif jt == SLIDE:
            rows[d] = jnp.concatenate([zeros3, kin.xaxis[j]])
        elif jt == BALL:
            rot = quat_to_mat(kin.xquat[b])
            for i in range(3):
                axv = rot[:, i]
                rows[d + i] = jnp.concatenate([axv, jnp.cross(axv, -off)])
        elif jt == FREE:
            for i in range(3):
                rows[d + i] = jnp.concatenate([zeros3, eye[i]])
            rot = quat_to_mat(kin.xquat[b])
            for i in range(3):
                axv = rot[:, i]
                rows[d + 3 + i] = jnp.concatenate([axv, jnp.cross(axv, -off)])
    cdof = jnp.stack(rows) if rows else jnp.zeros((0, 6), dtype)
    return ComQuants(subtree_com, cinert, cdof)


def velocity(m: PhysicsModel, com: ComQuants, qvel: jnp.ndarray) -> Velocity:
    """Body spatial velocities and cdof time-derivatives (mj_comVel semantics),
    as two mask matmuls: cvel = ancestor-dof sums, cdof_dot[i] = cross of the
    velocity accumulated before dof i (static dofdot mask) with cdof[i]."""
    dof_vel = com.cdof * qvel[:, None]  # (nv, 6)
    cvel = m.body_dof_mask @ dof_vel  # (nbody, 6)
    vel_before = m.dofdot_mask @ dof_vel  # (nv, 6)
    cdof_dot = motion_cross(vel_before, com.cdof)
    return Velocity(cvel, cdof_dot)


def _dof_body_sel(m: PhysicsModel, dtype) -> jnp.ndarray:
    """Constant (nv, nbody) one-hot: row i selects body(dof i)."""
    return _onehot(m.nv, m.nbody, m.dof_bodyid, dtype)


def crb_mass_matrix(m: PhysicsModel, com: ComQuants) -> jnp.ndarray:
    """Dense joint-space mass matrix via composite-rigid-body (mj_crb semantics).

    M[i, j] = cdof_i . (CRB[body(i)] cdof_j) on the dof-ancestor sparsity
    pattern, assembled as masked dense matmuls (no gathers: the per-dof CRB
    selection is a constant one-hot matmul)."""
    dtype = com.cdof.dtype
    crb = m.subtree_mask @ com.cinert.reshape(m.nbody, 36)  # (nbody, 36)
    dof_crb = (_dof_body_sel(m, dtype) @ crb).reshape(m.nv, 6, 6)  # (nv, 6, 6)
    f = jnp.einsum("vab,vb->va", dof_crb, com.cdof)  # (nv, 6)
    dense = f @ com.cdof.T  # (nv, nv)
    mask = m.dof_ancestor_mask  # lower-triangular-ish ancestry mask
    lower = dense * mask
    mm = lower + lower.T - jnp.diag(jnp.diag(lower))
    return mm + jnp.diag(m.dof_armature)


def rne_bias(m: PhysicsModel, com: ComQuants, vel: Velocity, qvel: jnp.ndarray) -> jnp.ndarray:
    """Bias force C(q, qvel) via recursive Newton-Euler (mj_rne, flg_acc=0),
    with the forward/backward recursions as ancestor/subtree mask matmuls."""
    dtype = qvel.dtype
    grav = jnp.where(m.gravity_enabled, 1.0, 0.0).astype(dtype) * m.gravity
    base_acc = jnp.concatenate([jnp.zeros(3, dtype), -grav])
    # forward: cacc[b] = base + sum over ancestor dofs of cdof_dot * qvel
    cacc = base_acc[None] + m.body_dof_mask @ (vel.cdof_dot * qvel[:, None])  # (nbody, 6)
    # body-local forces, batched
    iv = jnp.einsum("bij,bj->bi", com.cinert, vel.cvel)
    cfrc = jnp.einsum("bij,bj->bi", com.cinert, cacc) + motion_cross_force(vel.cvel, iv)
    # backward: subtree sums, then project per dof (one-hot body selection)
    cfrc_sub = m.subtree_mask @ cfrc  # (nbody, 6)
    dof_cfrc = _dof_body_sel(m, dtype) @ cfrc_sub  # (nv, 6)
    return jnp.einsum("vk,vk->v", com.cdof, dof_cfrc)


def passive_force(m: PhysicsModel, s: PhysicsState) -> jnp.ndarray:
    """Joint springs and dof dampers (mj_passive semantics, no tendons/fluids).

    Spring forces are assembled per-dof in static layout (concatenate), not
    scattered."""
    dtype = s.qvel.dtype
    qfrc = -m.dof_damping * s.qvel
    segs: list = []
    cursor = 0
    any_spring = False
    for j in range(m.njnt):
        jt = m.jnt_type[j]
        qadr, dadr = m.jnt_qposadr[j], m.jnt_dofadr[j]
        assert dadr == cursor, "dof layout must be joint-contiguous"
        stiff = m.jnt_stiffness[j]
        if jt in (SLIDE, HINGE):
            segs.append((-stiff * (s.qpos[qadr : qadr + 1] - m.qpos_spring[qadr : qadr + 1])))
            cursor += 1
        elif jt == BALL:
            q = s.qpos[qadr : qadr + 4]
            qs = m.qpos_spring[qadr : qadr + 4]
            dq = quat_mul(qs * jnp.array([1, -1, -1, -1], dtype), q)
            segs.append(-stiff * 2.0 * dq[1:])
            cursor += 3
        else:  # FREE
            segs.append(-stiff * (s.qpos[qadr : qadr + 3] - m.qpos_spring[qadr : qadr + 3]))
            q = s.qpos[qadr + 3 : qadr + 7]
            qs = m.qpos_spring[qadr + 3 : qadr + 7]
            dq = quat_mul(qs * jnp.array([1, -1, -1, -1], dtype), q)
            segs.append(-stiff * 2.0 * dq[1:])
            cursor += 6
        any_spring = True
    if any_spring and cursor == m.nv:
        qfrc = qfrc + jnp.concatenate(segs)
    return qfrc


def actuation(m: PhysicsModel, s: PhysicsState, ctrl: jnp.ndarray) -> jnp.ndarray:
    """Actuator forces for joint-transmission gain/bias actuators.

    Covers MuJoCo <motor>, <position>, <velocity> (fixed gain + affine bias) on
    scalar joints, which is everything the reference task suite uses
    (position actuators throughout — e.g. judo/models/xml/cartpole.xml).

    The qpos/qvel reads and the per-dof force write are constant one-hot
    matmuls (gather/scatter-free)."""
    dtype = s.qvel.dtype
    ctrl = jnp.where(
        m.actuator_ctrllimited,
        jnp.clip(ctrl, m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]),
        ctrl,
    )
    if m.nu == 0:
        return jnp.zeros(m.nv, dtype)
    qadrs = [m.jnt_qposadr[j] for j in m.actuator_trnid]
    dadrs = [m.jnt_dofadr[j] for j in m.actuator_trnid]
    sel_q = _onehot(m.nu, m.nq, qadrs, dtype)  # (nu, nq)
    sel_v = _onehot(m.nu, m.nv, dadrs, dtype)  # (nu, nv)
    gear = m.actuator_gear[:, 0]
    length = (sel_q @ s.qpos) * gear
    vel = (sel_v @ s.qvel) * gear
    force = (
        m.actuator_gainprm[:, 0] * ctrl
        + m.actuator_biasprm[:, 0]
        + m.actuator_biasprm[:, 1] * length
        + m.actuator_biasprm[:, 2] * vel
    )
    force = jnp.where(
        m.actuator_forcelimited,
        jnp.clip(force, m.actuator_forcerange[:, 0], m.actuator_forcerange[:, 1]),
        force,
    )
    qfrc = sel_v.T @ (gear * force)
    # per-JOINT clamp of the total actuator force (MuJoCo 3.x
    # jnt_actfrcrange / actuatorfrcrange — the fr3 arm's +-87 Nm limits)
    if any(m.jnt_actfrclimited):
        limited = np.zeros(m.nv)
        sel_j = np.zeros((m.njnt, m.nv))
        for j in range(m.njnt):
            if m.jnt_actfrclimited[j]:
                # MuJoCo clamps EVERY dof of an actfrclimited joint, not just
                # scalar joints (advisor r4) — ball: 3 dofs, free: 6
                ndof = {FREE: 6, BALL: 3}.get(m.jnt_type[j], 1)
                for d in range(ndof):
                    limited[m.jnt_dofadr[j] + d] = 1.0
                    sel_j[j, m.jnt_dofadr[j] + d] = 1.0
        sel_j = jnp.asarray(sel_j, dtype)
        lo = sel_j.T @ m.jnt_actfrcrange[:, 0]
        hi = sel_j.T @ m.jnt_actfrcrange[:, 1]
        qfrc = jnp.where(jnp.asarray(limited > 0), jnp.clip(qfrc, lo, hi), qfrc)
    return qfrc