"""Batch-in-lanes physics engine: the step with the batch in the last axis.

This is the second formulation of the engine in smooth.py/collision.py/
solver.py/step.py, re-laid-out batch-last:

- Every dynamic quantity is an array whose LAST axis is the rollout batch:
  a per-lane scalar is (B,), a 3-vector is (3, B), the mass matrix is
  (nv, nv, B), the constraint Jacobian is (nefc, nv, B). One elementwise op
  then advances all B rollouts at once.
- Tree loops (bodies, joints, contacts) run at *trace* time over the static
  model topology, emitting straight-line code — the same strategy as
  smooth.py; lane_rollout.py scans the whole step over the horizon.
- Mass-matrix factorizations are EXACT every step (Gauss-Jordan in lanes),
  so the Newton-Schulz temporal-warm-start machinery of step.py is
  unnecessary on this path; the only carried state is (qpos, qvel, efc force
  warm-start).

The functions are pure jnp on (…, B) arrays and run under plain jit on any
JAX backend; parity with the reference formulation (step.py) is tested on
the CPU.

Semantics replaced: the rollout hot loops of the reference
(judo/utils/mj_rollout_backend.py:84 — R CPU threads x T x mj_step;
mujoco_extensions/system/system_class.cpp:272-331).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from judo_tpu.physics.model import (
    BALL,
    EQ_JOINT,
    FREE,
    GEOM_BOX,
    GEOM_CAPSULE,
    GEOM_CYLINDER,
    GEOM_PLANE,
    GEOM_SPHERE,
    HINGE,
    INT_IMPLICITFAST,
    SLIDE,
    PhysicsModel,
)

_MINVAL = 1e-15
_MINIMP, _MAXIMP = 1e-4, 0.9999


# ---------------------------------------------------------------------------
# lane-layout math helpers: vectors are (3, B), quats (4, B), mats (3, 3, B)
# ---------------------------------------------------------------------------


def v3(x, y, z) -> jnp.ndarray:
    """Stack three (B,) lanes scalars into a (3, B) vector."""
    return jnp.stack([x, y, z])


def const_rows(vals, B: int, dtype) -> jnp.ndarray:
    """(n, B) constant from host scalars.

    Built from scalar broadcasts (jnp.full) rather than a literal array.
    """
    flat = np.asarray(vals, np.float64).reshape(-1)
    return jnp.stack([jnp.full(B, float(v), dtype) for v in flat])


def const_col(vals, dtype) -> jnp.ndarray:
    """(n, 1) constant column from host scalars (broadcasts against (n, B))."""
    return const_rows(vals, 1, dtype)


def eye_mask(n: int, dtype) -> jnp.ndarray:
    """(n, n, 1) identity mask from iota comparisons (no literal-array constant)."""
    io_r = jax.lax.broadcasted_iota(jnp.int32, (n, n, 1), 0)
    io_c = jax.lax.broadcasted_iota(jnp.int32, (n, n, 1), 1)
    return (io_r == io_c).astype(dtype)


def onehot_row(n: int, idx: int, dtype) -> jnp.ndarray:
    """(n, 1) one-hot from an iota comparison (no literal-array constant)."""
    io = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)
    return (io == idx).astype(dtype)


def usum(x: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Sum over a SMALL static axis, unrolled into an explicit BALANCED TREE
    of adds.

    The tree (depth log2 n) matters because these reductions sit on the
    step's dependency chains — a linear chain of n adds serializes at per-op
    latency.
    """
    n = x.shape[axis]
    axis = axis % x.ndim
    sl: list = [slice(None)] * x.ndim
    terms = []
    for k in range(n):
        sl[axis] = k
        terms.append(x[tuple(sl)])
    while len(terms) > 1:
        nxt = [terms[i] + terms[i + 1] for i in range(0, len(terms) - 1, 2)]
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


def l_cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Cross product of (..., 3, B) x (..., 3, B) along the 3-axis (-2)."""
    a0, a1, a2 = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    b0, b1, b2 = b[..., 0, :], b[..., 1, :], b[..., 2, :]
    return jnp.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], axis=-2)


def l_dot3(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Dot product over the 3-axis: (..., 3, B) -> (..., B)."""
    return usum(a * b, -2)


def l_norm3(a: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    return jnp.sqrt(jnp.maximum(l_dot3(a, a), eps))


def l_quat_mul(u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product on (4, B) quats (wxyz)."""
    uw, ux, uy, uz = u[0], u[1], u[2], u[3]
    vw, vx, vy, vz = v[0], v[1], v[2], v[3]
    return jnp.stack(
        [
            uw * vw - ux * vx - uy * vy - uz * vz,
            uw * vx + ux * vw + uy * vz - uz * vy,
            uw * vy - ux * vz + uy * vw + uz * vx,
            uw * vz + ux * vy - uy * vx + uz * vw,
        ]
    )


def l_quat_rotate(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate (3, B) vectors by (4, B) quats."""
    u = q[1:4]
    w = q[0:1]
    uv = l_cross(u, v)
    uuv = l_cross(u, uv)
    return v + 2.0 * (w * uv + uuv)


def l_quat_to_mat(q: jnp.ndarray) -> jnp.ndarray:
    """(4, B) quat -> (3, 3, B) rotation matrix."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    r0 = jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)])
    r1 = jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)])
    r2 = jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)])
    return jnp.stack([r0, r1, r2])


def l_mat_vec(m: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """(3, 3, B) @ (3, B) -> (3, B) (unrolled: see usum)."""
    return usum(m * v[None, :, :], 1)


def l_mat_t_vec(m: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """(3, 3, B)^T @ (3, B) -> (3, B) (unrolled: see usum)."""
    return usum(m * v[:, None, :], 0)


def p_mat_vec(m: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3, B) @ (..., 3, B) -> (..., 3, B): l_mat_vec with leading
    batch axes (the stacked-pairs narrowphase layout)."""
    return usum(m * v[..., None, :, :], -2)


def p_mat_t_vec(m: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3, B)^T @ (..., 3, B) -> (..., 3, B) with leading axes."""
    return usum(m * v[..., :, None, :], -3)


def l_mat_mul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(3, 3, B) @ (3, 3, B) -> (3, 3, B) (unrolled: see usum)."""
    return usum(a[:, :, None, :] * b[None, :, :, :], 1)


def l_quat_integrate(q: jnp.ndarray, omega: jnp.ndarray, h) -> jnp.ndarray:
    """mju_quatIntegrate on (4, B) quat / (3, B) body-frame angular velocity."""
    speed = jnp.sqrt(jnp.maximum(l_dot3(omega, omega), 1e-24))
    angle = speed * h
    axis = omega / speed  # near-zero omega: angle ~ 0, sin(half) ~ 0 kills it
    half = 0.5 * angle
    dq = jnp.concatenate([jnp.cos(half)[None], axis * jnp.sin(half)[None]], axis=0)
    out = l_quat_mul(q, dq)
    return out / jnp.sqrt(jnp.maximum(usum(out * out, 0), _MINVAL))[None]


def _c(m: PhysicsModel, arr, dtype) -> np.ndarray:
    """Host constant from a model leaf (trace-time literal)."""
    del m
    return np.asarray(jax.device_get(arr), dtype)


# ---------------------------------------------------------------------------
# tuple domain: quats as (w, x, y, z) and vectors as (x, y, z) PYTHON TUPLES
# of (B,) arrays or plain floats.
#
# Why this exists: the kinematics tree recursion is a long SEQUENTIAL chain,
# and in the stacked (4, B)/(3, B) representation every link goes
# stack -> row-slice -> stack, a relayout on the critical path. In the tuple
# domain the chain is pure elementwise arithmetic on (B,) arrays; constants stay python floats so
# constant x constant subexpressions fold at trace time. Values are stacked
# into (3, B)/(4, B)/(3, 3, B) arrays ONCE at stage boundaries.
# ---------------------------------------------------------------------------


def tq_mul(u: tuple, v: tuple) -> tuple:
    uw, ux, uy, uz = u
    vw, vx, vy, vz = v
    return (
        uw * vw - ux * vx - uy * vy - uz * vz,
        uw * vx + ux * vw + uy * vz - uz * vy,
        uw * vy - ux * vz + uy * vw + uz * vx,
        uw * vz + ux * vy - uy * vx + uz * vw,
    )


def tv_cross(a: tuple, b: tuple) -> tuple:
    ax, ay, az = a
    bx, by, bz = b
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def tv_add(a: tuple, b: tuple) -> tuple:
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def tv_sub(a: tuple, b: tuple) -> tuple:
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def tv_scale(s, v: tuple) -> tuple:
    return (s * v[0], s * v[1], s * v[2])


def tq_rotate(q: tuple, v: tuple) -> tuple:
    """Rotate vector v by quat q: v + 2*(w*(u x v) + u x (u x v))."""
    u = (q[1], q[2], q[3])
    w = q[0]
    uv = tv_cross(u, v)
    uuv = tv_cross(u, uv)
    return (
        v[0] + 2.0 * (w * uv[0] + uuv[0]),
        v[1] + 2.0 * (w * uv[1] + uuv[1]),
        v[2] + 2.0 * (w * uv[2] + uuv[2]),
    )


def tq_normalize(q: tuple) -> tuple:
    n = jax.lax.rsqrt(jnp.maximum(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3], _MINVAL))
    return (q[0] * n, q[1] * n, q[2] * n, q[3] * n)


def tq_to_mat9(q: tuple) -> tuple:
    """Quat -> row-major 9-tuple of the rotation matrix."""
    w, x, y, z = q
    return (
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    )


def _t_arr(c, B: int, dtype) -> jnp.ndarray:
    """One tuple component -> (B,) array (floats become full-splats)."""
    if isinstance(c, (int, float)):
        return jnp.full(B, float(c), dtype)
    return c


def t_stackn(t: tuple, B: int, dtype) -> jnp.ndarray:
    """(n-tuple of components) -> (n, B) array — a stage-boundary stack."""
    return jnp.stack([_t_arr(c, B, dtype) for c in t])


def t_stack33(t9: tuple, B: int, dtype) -> jnp.ndarray:
    """(9-tuple, row-major) -> (3, 3, B) rotation matrix."""
    return t_stackn(t9, B, dtype).reshape(3, 3, -1)


# ---------------------------------------------------------------------------
# kinematics
# ---------------------------------------------------------------------------


class LaneKin(NamedTuple):
    xpos: list  # nbody x (3, B)
    xquat: list  # nbody x (4, B)
    xmat: list  # nbody x (3, 3, B)
    xipos: list  # nbody x (3, B)
    ximat: list  # nbody x (3, 3, B)
    xanchor: list  # njnt x (3, B)
    xaxis: list  # njnt x (3, B)
    geom_xpos: list  # ngeom x (3, B)
    geom_xmat: list  # ngeom x (3, 3, B)
    site_xpos: list  # nsite x (3, B)
    site_xmat: list  # nsite x (3, 3, B)


def kinematics_l(m: PhysicsModel, qpos: jnp.ndarray) -> LaneKin:
    """Forward kinematics, batch-last. Mirrors smooth.kinematics exactly.

    Internals run in the TUPLE domain (see the tq_*/tv_* helpers above): the
    sequential parent->child chain is pure (B,)-register arithmetic with
    python-float constants, no stacked-array relayouts; results are stacked
    into the LaneKin layout once at the end."""
    dtype = qpos.dtype
    B = qpos.shape[-1]
    np_ = lambda a: np.asarray(jax.device_get(a), np.float64)  # noqa: E731
    body_pos = np_(m.body_pos)
    body_quat = np_(m.body_quat)
    jnt_pos = np_(m.jnt_pos)
    jnt_axis = np_(m.jnt_axis)
    qpos0 = np_(m.qpos0)
    body_ipos = np_(m.body_ipos)
    body_iquat = np_(m.body_iquat)
    geom_pos = np_(m.geom_pos)
    geom_quat = np_(m.geom_quat)
    site_pos = np_(m.site_pos)
    site_quat = np_(m.site_quat)

    def f3(v) -> tuple:
        return (float(v[0]), float(v[1]), float(v[2]))

    def f4(v) -> tuple:
        return (float(v[0]), float(v[1]), float(v[2]), float(v[3]))

    xpos_t: list = [(0.0, 0.0, 0.0)]
    xquat_t: list = [(1.0, 0.0, 0.0, 0.0)]
    xanchor_t: list = [None] * m.njnt
    xaxis_t: list = [None] * m.njnt

    for b in range(1, m.nbody):
        p = m.body_parentid[b]
        pos = tv_add(xpos_t[p], tq_rotate(xquat_t[p], f3(body_pos[b])))
        quat = tq_mul(xquat_t[p], f4(body_quat[b]))
        for k in range(m.body_jntnum[b]):
            j = m.body_jntadr[b] + k
            jt = m.jnt_type[j]
            qadr = m.jnt_qposadr[j]
            anchor = tv_add(tq_rotate(quat, f3(jnt_pos[j])), pos)
            axis = tq_rotate(quat, f3(jnt_axis[j]))
            if jt == FREE:
                pos = (qpos[qadr], qpos[qadr + 1], qpos[qadr + 2])
                quat = tq_normalize(
                    (qpos[qadr + 3], qpos[qadr + 4], qpos[qadr + 5], qpos[qadr + 6])
                )
                anchor = pos
            elif jt == BALL:
                qloc = tq_normalize(
                    (qpos[qadr], qpos[qadr + 1], qpos[qadr + 2], qpos[qadr + 3])
                )
                quat = tq_mul(quat, qloc)
                pos = tv_sub(anchor, tq_rotate(quat, f3(jnt_pos[j])))
            elif jt == SLIDE:
                pos = tv_add(pos, tv_scale(qpos[qadr] - float(qpos0[qadr]), axis))
            elif jt == HINGE:
                half = 0.5 * (qpos[qadr] - float(qpos0[qadr]))
                s = jnp.sin(half)
                ax = f3(jnt_axis[j])
                qloc = (jnp.cos(half), ax[0] * s, ax[1] * s, ax[2] * s)
                quat = tq_mul(quat, qloc)
                pos = tv_sub(anchor, tq_rotate(quat, f3(jnt_pos[j])))
            xanchor_t[j] = anchor
            xaxis_t[j] = tq_rotate(quat, f3(jnt_axis[j])) if jt in (BALL, HINGE) else axis
        xpos_t.append(pos)
        xquat_t.append(quat)

    # --- STACKED epilogue: the per-geom/site/inertial frame products have no
    # tree dependencies, so they run as ONE set of ops on (n, B) components
    # instead of per-object tuple loops (the loops dominated the kinematics
    # op count ~3:1). The serial parent->child WALK above stays in the tuple
    # domain — per-link stack/slice relayouts on the critical path are what
    # the tuple domain exists to avoid (see module docstring); the epilogue
    # stacks each quantity once and slices once, off any serial chain. ---
    def stack_comp(ts: list) -> tuple:
        """List of tuples (scalar or (B,) comps) -> tuple of (n, B) arrays."""
        return tuple(
            jnp.stack([_t_arr(t[k], B, dtype) for t in ts]) for k in range(len(ts[0]))
        )

    def cvec(arr: np.ndarray) -> tuple:
        """(n, k) host constants -> k-tuple of (n, 1) jnp.full columns
        (no literal-array constants)."""
        a = np.asarray(arr, np.float64)
        return tuple(const_col(a[:, k], dtype) for k in range(a.shape[1]))

    def pack3(t: tuple) -> jnp.ndarray:  # 3 comps (n, B) -> (n, 3, B)
        return jnp.stack(t, axis=1)

    def pack33(t9: tuple) -> jnp.ndarray:  # 9 comps (n, B) -> (n, 3, 3, B)
        return jnp.stack([jnp.stack(t9[3 * i : 3 * i + 3], axis=1) for i in range(3)], axis=1)

    bpos = stack_comp(xpos_t)  # 3 x (nbody, B)
    bquat = stack_comp(xquat_t)  # 4 x (nbody, B)
    xpos_s = pack3(bpos)
    xquat_s = pack3((bquat[0], bquat[1], bquat[2]))  # placeholder; replaced below
    xquat_s = jnp.stack(bquat, axis=1)  # (nbody, 4, B)
    xmat_s = pack33(tq_to_mat9(bquat))
    xipos_s = pack3(tv_add(bpos, tq_rotate(bquat, cvec(body_ipos))))
    ximat_s = pack33(tq_to_mat9(tq_mul(bquat, cvec(body_iquat))))

    xpos = [xpos_s[b] for b in range(m.nbody)]
    xquat = [xquat_s[b] for b in range(m.nbody)]
    xmat = [xmat_s[b] for b in range(m.nbody)]
    xipos = [xipos_s[b] for b in range(m.nbody)]
    ximat = [ximat_s[b] for b in range(m.nbody)]

    if m.njnt:
        xanchor_s = pack3(stack_comp(xanchor_t))
        xaxis_s = pack3(stack_comp(xaxis_t))
        xanchor = [xanchor_s[j] for j in range(m.njnt)]
        xaxis = [xaxis_s[j] for j in range(m.njnt)]
    else:
        xanchor, xaxis = [], []

    geom_xpos, geom_xmat = [], []
    if m.ngeom:
        gb = [int(m.geom_bodyid[g]) for g in range(m.ngeom)]
        gp = stack_comp([xpos_t[b] for b in gb])
        gq = stack_comp([xquat_t[b] for b in gb])
        geom_xpos_s = pack3(tv_add(gp, tq_rotate(gq, cvec(geom_pos))))
        geom_xmat_s = pack33(tq_to_mat9(tq_mul(gq, cvec(geom_quat))))
        geom_xpos = [geom_xpos_s[g] for g in range(m.ngeom)]
        geom_xmat = [geom_xmat_s[g] for g in range(m.ngeom)]
    site_xpos, site_xmat = [], []
    if m.nsite:
        sb = [int(m.site_bodyid[t]) for t in range(m.nsite)]
        sp = stack_comp([xpos_t[b] for b in sb])
        sq = stack_comp([xquat_t[b] for b in sb])
        site_xpos_s = pack3(tv_add(sp, tq_rotate(sq, cvec(site_pos))))
        site_xmat_s = pack33(tq_to_mat9(tq_mul(sq, cvec(site_quat))))
        site_xpos = [site_xpos_s[t] for t in range(m.nsite)]
        site_xmat = [site_xmat_s[t] for t in range(m.nsite)]

    return LaneKin(xpos, xquat, xmat, xipos, ximat, xanchor, xaxis, geom_xpos, geom_xmat, site_xpos, site_xmat)


# ---------------------------------------------------------------------------
# CoM quantities, CRB mass matrix, RNE bias — direct tree recursion
# ---------------------------------------------------------------------------


class LaneCom(NamedTuple):
    subtree_com: list  # nbody x (3, B)
    root_com: list  # nbody x (3, B) (per-body tree-root subtree CoM)
    cinert: list  # nbody x (6, 6, B)
    cdof: list  # nv x (6, B)


def com_l(m: PhysicsModel, kin: LaneKin) -> LaneCom:
    """mj_comPos semantics (see smooth.com_quantities), tree-recursed."""
    dtype = kin.xpos[0].dtype
    B = kin.xpos[0].shape[-1]
    mass = np.asarray(jax.device_get(m.body_mass), np.float64)
    inertia = np.asarray(jax.device_get(m.body_inertia), np.float64)

    # subtree mass (static scalars) and subtree mass-weighted CoM (reverse topo)
    sub_mass = mass.copy()
    mpos = [float(mass[b]) * kin.xipos[b] for b in range(m.nbody)]
    acc = list(mpos)
    for b in range(m.nbody - 1, 0, -1):
        p = m.body_parentid[b]
        sub_mass[p] += sub_mass[b]
        acc[p] = acc[p] + acc[b]
    subtree_com = [acc[b] / max(float(sub_mass[b]), 1e-12) for b in range(m.nbody)]
    root_com = [subtree_com[m.body_rootid[b]] for b in range(m.nbody)]

    # spatial inertia about the root CoM, world axes (spatial.spatial_inertia)
    cinert = []
    for b in range(m.nbody):
        R = kin.ximat[b]  # (3,3,B)
        # inertia_world = R diag(I) R^T = sum_k I_k outer(R[:,k], R[:,k])
        # (scalar-weighted outer products of static SLICES, not int+None
        # mixed indexing, which lowers to a gather)
        iw = sum(
            float(inertia[b, k]) * R[:, k : k + 1, :] * jnp.swapaxes(R[:, k : k + 1, :], 0, 1)
            for k in range(3)
        )
        c = kin.xipos[b] - root_com[b]  # (3,B)
        mb = float(mass[b])
        zero = jnp.zeros(B, dtype)
        cx = jnp.stack(
            [
                jnp.stack([zero, -c[2], c[1]]),
                jnp.stack([c[2], zero, -c[0]]),
                jnp.stack([-c[1], c[0], zero]),
            ]
        )  # (3,3,B)
        cxT = jnp.swapaxes(cx, 0, 1)
        tl = iw + mb * l_mat_mul(cx, cxT)
        tr = mb * cx
        bl = mb * cxT
        br = mb * jnp.broadcast_to(eye_mask(3, dtype), (3, 3, B))
        top = jnp.concatenate([tl, tr], axis=1)
        bot = jnp.concatenate([bl, br], axis=1)
        cinert.append(jnp.concatenate([top, bot], axis=0))  # (6,6,B)

    # cdof rows (per dof): [angular; linear] about the root CoM
    cdof: list = [None] * m.nv
    B_ = B
    zero3 = jnp.zeros((3, B_), dtype)
    for j in range(m.njnt):
        jt = m.jnt_type[j]
        b = m.jnt_bodyid[j]
        d = m.jnt_dofadr[j]
        off = kin.xanchor[j] - root_com[b]
        if jt == HINGE:
            ax = kin.xaxis[j]
            cdof[d] = jnp.concatenate([ax, l_cross(ax, -off)], axis=0)
        elif jt == SLIDE:
            cdof[d] = jnp.concatenate([zero3, kin.xaxis[j]], axis=0)
        elif jt == BALL:
            rot = l_quat_to_mat(kin.xquat[b])
            for i in range(3):
                axv = rot[:, i, :]
                cdof[d + i] = jnp.concatenate([axv, l_cross(axv, -off)], axis=0)
        elif jt == FREE:
            for i in range(3):
                e = jnp.broadcast_to(onehot_row(3, i, dtype), (3, B_))
                cdof[d + i] = jnp.concatenate([zero3, e], axis=0)
            rot = l_quat_to_mat(kin.xquat[b])
            for i in range(3):
                axv = rot[:, i, :]
                cdof[d + 3 + i] = jnp.concatenate([axv, l_cross(axv, -off)], axis=0)
    return LaneCom(subtree_com, root_com, cinert, cdof)


def _dof_ancestors(m: PhysicsModel) -> list:
    """Static ancestor dof lists (self included), from dof_parentid chains."""
    anc = []
    for i in range(m.nv):
        chain = []
        j = i
        while j >= 0:
            chain.append(j)
            j = m.dof_parentid[j]
        anc.append(chain)
    return anc


def _spatial6_mv(i66: jnp.ndarray, v6: jnp.ndarray) -> jnp.ndarray:
    """(6, 6, B) @ (6, B) -> (6, B) (unrolled: see usum)."""
    return usum(i66 * v6[None, :, :], 1)


def crb_mass_matrix_l(m: PhysicsModel, com: LaneCom) -> jnp.ndarray:
    """Dense (nv, nv, B) joint-space mass matrix via CRB (mj_crb semantics)."""
    dtype = com.cdof[0].dtype
    B = com.cdof[0].shape[-1]
    armature = np.asarray(jax.device_get(m.dof_armature), np.float64)

    # composite inertias: reverse-topological accumulation
    crb = list(com.cinert)
    for b in range(m.nbody - 1, 0, -1):
        p = m.body_parentid[b]
        crb[p] = crb[p] + crb[b]

    anc = _dof_ancestors(m)
    zero = jnp.zeros(B, dtype)
    rows: list = [[zero] * m.nv for _ in range(m.nv)]
    for i in range(m.nv):
        bi = m.dof_bodyid[i]
        f_i = _spatial6_mv(crb[bi], com.cdof[i])  # (6, B)
        for j in anc[i]:  # j <= i in tree order
            mij = usum(f_i * com.cdof[j], 0)
            if i == j:
                mij = mij + float(armature[i])
            rows[i][j] = mij
            rows[j][i] = mij
    # assemble (nv, nv, B)
    return jnp.stack([jnp.stack(r) for r in rows])


class LaneVel(NamedTuple):
    cvel: list  # nbody x (6, B)
    cdof_dot: list  # nv x (6, B)


def velocity_l(m: PhysicsModel, com: LaneCom, qvel: jnp.ndarray) -> LaneVel:
    """mj_comVel semantics by forward tree recursion (see smooth.velocity and
    the dofdot_mask construction in model.py for which velocity each
    cdof_dot row sees)."""
    dtype = qvel.dtype
    B = qvel.shape[-1]
    zero6 = jnp.zeros((6, B), dtype)
    cvel: list = [zero6] * m.nbody
    cdof_dot: list = [zero6] * m.nv

    def mcross(v, mv):
        ang = l_cross(v[:3], mv[:3])
        lin = l_cross(v[:3], mv[3:]) + l_cross(v[3:], mv[:3])
        return jnp.concatenate([ang, lin], axis=0)

    for b in range(1, m.nbody):
        p = m.body_parentid[b]
        v = cvel[p]
        for k in range(m.body_jntnum[b]):
            j = m.body_jntadr[b] + k
            jt = m.jnt_type[j]
            d = m.jnt_dofadr[j]
            if jt in (HINGE, SLIDE):
                cdof_dot[d] = mcross(v, com.cdof[d])
                v = v + com.cdof[d] * qvel[d][None]
            elif jt == BALL:
                # all three rotate simultaneously: each sees the pre-joint velocity
                for i in range(3):
                    cdof_dot[d + i] = mcross(v, com.cdof[d + i])
                for i in range(3):
                    v = v + com.cdof[d + i] * qvel[d + i][None]
            elif jt == FREE:
                # translations: cdof_dot = 0; rotations see translations' velocity
                for i in range(3):
                    v = v + com.cdof[d + i] * qvel[d + i][None]
                for i in range(3):
                    cdof_dot[d + 3 + i] = mcross(v, com.cdof[d + 3 + i])
                for i in range(3):
                    v = v + com.cdof[d + 3 + i] * qvel[d + 3 + i][None]
        cvel[b] = v
    return LaneVel(cvel, cdof_dot)


def rne_bias_l(m: PhysicsModel, com: LaneCom, vel: LaneVel, qvel: jnp.ndarray) -> jnp.ndarray:
    """Bias force C(q, v) (mj_rne, flg_acc=0) -> (nv, B)."""
    dtype = qvel.dtype
    B = qvel.shape[-1]
    grav = np.asarray(jax.device_get(m.gravity), np.float64)
    if not m.gravity_enabled:
        grav = grav * 0.0

    base_acc = jnp.broadcast_to(const_col(np.concatenate([np.zeros(3), -grav]), dtype), (6, B))

    def mcross_force(v, f):
        ang = l_cross(v[:3], f[:3]) + l_cross(v[3:], f[3:])
        lin = l_cross(v[:3], f[3:])
        return jnp.concatenate([ang, lin], axis=0)

    # forward: cacc[b] = base + sum over ancestor dofs of cdof_dot * qvel
    cacc: list = [base_acc] * m.nbody
    for b in range(1, m.nbody):
        p = m.body_parentid[b]
        a = cacc[p]
        for k in range(m.body_jntnum[b]):
            j = m.body_jntadr[b] + k
            d = m.jnt_dofadr[j]
            for i in range(_jnt_ndof(m.jnt_type[j])):
                a = a + vel.cdof_dot[d + i] * qvel[d + i][None]
        cacc[b] = a

    cfrc = []
    for b in range(m.nbody):
        iv = _spatial6_mv(com.cinert[b], vel.cvel[b])
        cfrc.append(_spatial6_mv(com.cinert[b], cacc[b]) + mcross_force(vel.cvel[b], iv))

    # backward: subtree force sums
    for b in range(m.nbody - 1, 0, -1):
        p = m.body_parentid[b]
        cfrc[p] = cfrc[p] + cfrc[b]

    return jnp.stack([usum(com.cdof[i] * cfrc[m.dof_bodyid[i]], 0) for i in range(m.nv)])


def _jnt_ndof(jt: int) -> int:
    return {FREE: 6, BALL: 3, SLIDE: 1, HINGE: 1}[jt]


def _jnt_nq(jt: int) -> int:
    return {FREE: 7, BALL: 4, SLIDE: 1, HINGE: 1}[jt]


# ---------------------------------------------------------------------------
# passive + actuation forces
# ---------------------------------------------------------------------------


def passive_force_l(m: PhysicsModel, qpos: jnp.ndarray, qvel: jnp.ndarray) -> jnp.ndarray:
    """Joint springs + dof dampers -> (nv, B) (smooth.passive_force)."""
    dtype = qvel.dtype
    damping = np.asarray(jax.device_get(m.dof_damping), np.float64)
    stiff = np.asarray(jax.device_get(m.jnt_stiffness), np.float64)
    qspring = np.asarray(jax.device_get(m.qpos_spring), np.float64)

    qfrc = -const_col(damping, dtype) * qvel
    if not np.any(stiff):
        return qfrc
    rows: list = [qfrc[i] for i in range(m.nv)]
    for j in range(m.njnt):
        jt = m.jnt_type[j]
        k = float(stiff[j])
        if k == 0.0:
            continue
        qadr, dadr = m.jnt_qposadr[j], m.jnt_dofadr[j]
        if jt in (SLIDE, HINGE):
            rows[dadr] = rows[dadr] - k * (qpos[qadr] - float(qspring[qadr]))
        elif jt == BALL:
            q = qpos[qadr : qadr + 4]
            qs = const_col(qspring[qadr : qadr + 4] * np.array([1, -1, -1, -1]), dtype)
            dq = l_quat_mul(jnp.broadcast_to(qs, q.shape), q)
            for i in range(3):
                rows[dadr + i] = rows[dadr + i] - k * 2.0 * dq[1 + i]
        else:  # FREE
            for i in range(3):
                rows[dadr + i] = rows[dadr + i] - k * (qpos[qadr + i] - float(qspring[qadr + i]))
            q = qpos[qadr + 3 : qadr + 7]
            qs = const_col(qspring[qadr + 3 : qadr + 7] * np.array([1, -1, -1, -1]), dtype)
            dq = l_quat_mul(jnp.broadcast_to(qs, q.shape), q)
            for i in range(3):
                rows[dadr + 3 + i] = rows[dadr + 3 + i] - k * 2.0 * dq[1 + i]
    return jnp.stack(rows)


def actuation_l(m: PhysicsModel, qpos: jnp.ndarray, qvel: jnp.ndarray, ctrl: jnp.ndarray) -> jnp.ndarray:
    """Actuator joint-space force -> (nv, B) (smooth.actuation semantics:
    fixed-gain + affine-bias actuators on scalar joints)."""
    dtype = qvel.dtype
    B = qvel.shape[-1]
    if m.nu == 0:
        return jnp.zeros((m.nv, B), dtype)
    gear = np.asarray(jax.device_get(m.actuator_gear), np.float64)[:, 0]
    gain = np.asarray(jax.device_get(m.actuator_gainprm), np.float64)[:, 0]
    bias = np.asarray(jax.device_get(m.actuator_biasprm), np.float64)[:, :3]
    crange = np.asarray(jax.device_get(m.actuator_ctrlrange), np.float64)
    frange = np.asarray(jax.device_get(m.actuator_forcerange), np.float64)
    climited = np.asarray(jax.device_get(m.actuator_ctrllimited), bool)
    flimited = np.asarray(jax.device_get(m.actuator_forcelimited), bool)

    zero = jnp.zeros(B, dtype)
    rows: list = [zero] * m.nv
    for u in range(m.nu):
        j = m.actuator_trnid[u]
        qadr, dadr = m.jnt_qposadr[j], m.jnt_dofadr[j]
        c = ctrl[u]
        if climited[u]:
            c = jnp.clip(c, float(crange[u, 0]), float(crange[u, 1]))
        g = float(gear[u])
        length = qpos[qadr] * g
        vel = qvel[dadr] * g
        force = float(gain[u]) * c + float(bias[u, 0]) + float(bias[u, 1]) * length + float(bias[u, 2]) * vel
        if flimited[u]:
            force = jnp.clip(force, float(frange[u, 0]), float(frange[u, 1]))
        rows[dadr] = rows[dadr] + g * force
    # per-JOINT clamp of the total actuator force (MuJoCo 3.x
    # jnt_actfrcrange / actuatorfrcrange — matches smooth.actuation)
    if any(m.jnt_actfrclimited):
        afr = np.asarray(jax.device_get(m.jnt_actfrcrange), np.float64)
        for j in range(m.njnt):
            if m.jnt_actfrclimited[j]:
                # every dof of a limited joint is clamped (ball: 3, free: 6)
                # — MuJoCo semantics, advisor r4; matches smooth.actuation
                ndof = {FREE: 6, BALL: 3}.get(m.jnt_type[j], 1)
                for d in range(ndof):
                    dadr = m.jnt_dofadr[j] + d
                    rows[dadr] = jnp.clip(rows[dadr], float(afr[j, 0]), float(afr[j, 1]))
    return jnp.stack(rows)


# ---------------------------------------------------------------------------
# lanes linear algebra: Gauss-Jordan SPD inverse on (n, n, B)
# ---------------------------------------------------------------------------


def dof_islands(m: PhysicsModel) -> list:
    """Contiguous [start, end) dof ranges of independent kinematic subtrees.

    Two dofs couple in the mass matrix only when one is an ancestor of the
    other, so each weakly-connected component of the dof forest
    (dof_parentid) is an independent SPD block. MuJoCo orders dofs
    depth-first, so components are contiguous ranges. On leap_cube (palm
    fixed to the world) this yields cube(6) + 4 x finger(4): inverting the
    blocks costs ~45x fewer MACs than the dense 22x22 elimination, and
    block mat-vecs ~5x fewer.
    """
    comp = [0] * m.nv
    n_comp = 0
    for i in range(m.nv):
        p = m.dof_parentid[i]
        if p < 0:
            comp[i] = n_comp
            n_comp += 1
        else:
            comp[i] = comp[p]
    ranges: list = []
    start = 0
    for i in range(1, m.nv + 1):
        if i == m.nv or comp[i] != comp[start]:
            ranges.append((start, i))
            start = i
    # a component split across multiple ranges means dofs are out of
    # depth-first order — fall back to one dense block
    if len({comp[s] for s, _ in ranges}) != len(ranges):
        return [(0, m.nv)]
    return ranges


def spd_inverse_blocks(m: PhysicsModel, a: jnp.ndarray) -> list:
    """Blockwise SPD inverse over dof_islands: [(start, (k, k, B) inverse)].

    The input (nv, nv, B) matrix must be block-diagonal over the islands
    (true for the CRB mass matrix and its damping-shifted variant)."""
    return [(s, spd_inverse_l(a[s:e, s:e, :])) for s, e in dof_islands(m)]


def bd_mat_vec(blocks: list, v: jnp.ndarray) -> jnp.ndarray:
    """Block-diagonal (nv, nv, B) @ (nv, B) -> (nv, B)."""
    return jnp.concatenate(
        [mat_vec_l(blk, v[s : s + blk.shape[0]]) for s, blk in blocks], axis=0
    )


def bd_abs(blocks: list) -> list:
    return [(s, jnp.abs(blk)) for s, blk in blocks]


def spd_inverse_l(a: jnp.ndarray) -> jnp.ndarray:
    """Explicit SPD inverse of (n, n, B) via Gauss-Jordan (no pivoting).

    The lanes analogue of linalg.spd_inverse — per column two rank-1 updates
    over the full (n, n, B) block."""
    n = a.shape[0]
    dtype = a.dtype
    x = jnp.broadcast_to(eye_mask(n, dtype), a.shape)
    io = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)
    for j in range(n):
        d = a[j, j]  # (B,)
        notj = (io != j).astype(dtype)  # (n, 1)
        f = a[:, j, :] * notj / d[None, :]  # (n, B)
        # pivot rows as static slices — a[j, None] (int+None indexing) lowers
        # to a gather
        a = a - f[:, None, :] * a[j : j + 1, :, :]
        x = x - f[:, None, :] * x[j : j + 1, :, :]
    diag = jnp.stack([a[j, j] for j in range(n)])  # (n, B)
    x = x / diag[:, None, :]
    return 0.5 * (x + jnp.swapaxes(x, 0, 1))


def mat_vec_l(a: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """(n, n, B) @ (n, B) -> (n, B)."""
    return usum(a * v[None, :, :], 1)
