"""Constraint assembly, APGD dual solve, sensors and integration — lanes.

The lanes counterpart of solver.py + sensors.py + step.py's integrator: one
pure function ``step_l`` advancing a whole batch of rollouts one physics step
with every array batch-last (see lane_engine.py docstring). Constraint row
ORDER matches solver.assemble_constraints exactly (equalities, joint limits,
contact pyramids in group order), so efc warm-starts and parity tests line up
across the two formulations.

Differences vs the XLA-path solver (both intentional):
- mass-matrix inverses are exact every step (cheap in-kernel), so there is no
  Newton-Schulz chain and no divergence-guard machinery;
- all contractions over the constraint-row axis are CHUNKED to bound the
  size of their intermediates.

Both paths share the same APGD formulation: Jacobi preconditioning by
MuJoCo's invweight diagApprox + regularizer, and the Collatz-Wielandt
Lipschitz upper bound (see solver.solve_dual_qp_matfree) — measured ~20x
more effective step per iteration than the earlier Hoelder bound, which is
what lets stock iteration budgets match MuJoCo's Newton solver on the
flagship scenes (tests/test_physics/test_scene_parity.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from judo_tpu.physics import lane_engine as le
from judo_tpu.physics.lane_collision import LaneContacts, find_contacts_l
from judo_tpu.physics.lane_engine import (
    LaneCom,
    LaneKin,
    l_cross,
    l_dot3,
    l_quat_integrate,
    l_quat_mul,
    mat_vec_l,
    spd_inverse_l,
    usum,
)
from judo_tpu.physics.model import (
    BALL,
    EQ_JOINT,
    FREE,
    HINGE,
    INT_IMPLICITFAST,
    SENSOR_DISTANCE,
    SENSOR_FRAMEPOS,
    SENSOR_FRAMEQUAT,
    SENSOR_FRAMEXAXIS,
    SENSOR_FRAMEYAXIS,
    SENSOR_FRAMEZAXIS,
    SENSOR_JOINTPOS,
    SENSOR_JOINTVEL,
    SLIDE,
    _OBJ_BODY,
    _OBJ_SITE,
    _OBJ_XBODY,
    PhysicsModel,
)

_MINVAL = 1e-15
_MINIMP, _MAXIMP = 1e-4, 0.9999


def _np(a) -> np.ndarray:
    return np.asarray(jax.device_get(a), np.float64)


def impedance_l(solimp: np.ndarray, pos: jnp.ndarray) -> jnp.ndarray:
    """MuJoCo constraint impedance d(r) with host-constant solimp, (B,) pos."""
    dmin, dmax, width, mid, power = (float(solimp[i]) for i in range(5))
    x = jnp.clip(jnp.abs(pos) / max(width, _MINVAL), 0.0, 1.0)
    mid = min(max(mid, _MINIMP), _MAXIMP)
    power = max(power, 1.0)
    if power == 1.0:
        y = x
    else:
        lo = (mid ** (1.0 - power)) * x**power
        hi = 1.0 - ((1.0 - mid) ** (1.0 - power)) * (1.0 - x) ** power
        y = jnp.where(x <= mid, lo, hi)
    return jnp.clip(dmin + y * (dmax - dmin), _MINIMP, _MAXIMP)


def impedance_lc(solimp: np.ndarray, pos: jnp.ndarray) -> jnp.ndarray:
    """impedance_l over STACKED contacts: solimp (C, 5) host constants,
    pos (C, B). Contacts sharing a solimp row (the overwhelmingly common
    case — one pair-type parameterization per scene) are computed by one
    scalar-constant curve; distinct rows are blended with one-hot constant
    masks, so no per-lane transcendental pow with a varying exponent is ever
    emitted."""
    rows = [tuple(float(v) for v in r) for r in np.asarray(solimp)]
    uniq: dict = {}
    for i, r in enumerate(rows):
        uniq.setdefault(r, []).append(i)
    if len(uniq) == 1:
        return impedance_l(np.asarray(rows[0]), pos)
    from judo_tpu.physics.lane_engine import const_col

    out = jnp.zeros_like(pos)
    for r, idxs in uniq.items():
        ind = np.zeros(len(rows))
        ind[idxs] = 1.0
        w = const_col(ind, pos.dtype)  # (C, 1) jnp.full-based
        out = out + w * impedance_l(np.asarray(r), pos)
    return out


def kb_from_solref_np(solref: np.ndarray, solimp: np.ndarray, timestep: float) -> tuple:
    """Host-side stiffness/damping from solref (solver.kb_from_solref)."""
    dmax = min(max(float(solimp[1]), _MINIMP), _MAXIMP)
    timeconst = max(float(solref[0]), 2.0 * timestep)
    dampratio = float(solref[1])
    if solref[0] > 0:
        k = 1.0 / max(dmax * dmax * timeconst * timeconst * dampratio * dampratio, _MINVAL)
        b = 2.0 / max(dmax * timeconst, _MINVAL)
    else:
        k, b = -float(solref[0]), -float(solref[1])
    return k, b


def jt_vec_chunked(J: jnp.ndarray, f: jnp.ndarray, C: int = 32) -> jnp.ndarray:
    """J^T f: (nefc, nv, B), (nefc, B) -> (nv, B).

    One full-product reduction (jnp.sum) when nv >= 8; smaller products
    (e.g. cylinder_push's nv=4) use the tree-unrolled sum. ``C`` kept for
    signature compatibility."""
    del C
    if J.shape[1] >= 8:
        return jnp.sum(J * f[:, None, :], axis=0)
    return usum(J * f[:, None, :], 0)


def j_vec_chunked(J: jnp.ndarray, v: jnp.ndarray, C: int = 32) -> jnp.ndarray:
    """J v: (nefc, nv, B), (nv, B) -> (nefc, B) (see jt_vec_chunked).

    Products with nv < 8 (e.g. cylinder_push's nv=4) use the tree-unrolled
    sum."""
    del C
    if J.shape[1] >= 8:
        return jnp.sum(J * v[None, :, :], axis=1)
    return usum(J * v[None, :, :], 1)


class LaneRows(NamedTuple):
    J: jnp.ndarray  # (nefc, nv, B)
    aref: jnp.ndarray  # (nefc, B)
    reg: jnp.ndarray  # (nefc, B)
    active: jnp.ndarray  # (nefc, B)
    diag: jnp.ndarray  # (nefc, B) invweight0 diag(J M^-1 J^T) approximation
    # (MuJoCo's diagApprox — the APGD Jacobi preconditioner; see solver.py)


def assemble_constraints_l(
    m: PhysicsModel,
    com: LaneCom,
    contacts: LaneContacts | None,
    qpos: jnp.ndarray,
    qvel: jnp.ndarray,
) -> LaneRows | None:
    """Equalities + joint limits + contact rows, batch-last, pair-stacked."""
    dtype = qvel.dtype
    B = qvel.shape[-1]
    ts = float(_np(m.timestep))
    qpos0 = _np(m.qpos0)
    eq_data = _np(m.eq_data) if m.neq else np.zeros((0, 11))
    eq_solref = _np(m.eq_solref) if m.neq else np.zeros((0, 2))
    eq_solimp = _np(m.eq_solimp) if m.neq else np.zeros((0, 5))
    dof_invweight0 = _np(m.dof_invweight0)
    jnt_range = _np(m.jnt_range)
    jnt_margin = _np(m.jnt_margin)
    jnt_solref = _np(m.jnt_solref)
    jnt_solimp = _np(m.jnt_solimp)
    body_invweight0 = _np(m.body_invweight0)
    body_dof_mask = _np(m.body_dof_mask)

    rows_J: list = []
    rows_aref: list = []
    rows_reg: list = []
    rows_active: list = []
    rows_diag: list = []
    ones = jnp.ones(B, dtype)

    from judo_tpu.physics.lane_engine import const_col

    def const_row(v: np.ndarray) -> jnp.ndarray:
        return jnp.broadcast_to(const_col(v, dtype), (m.nv, B))

    # --- joint equality couplings (solver.assemble_constraints order) ---
    for e in range(m.neq):
        if m.eq_type[e] != EQ_JOINT:
            continue
        j1, j2 = m.eq_obj1id[e], m.eq_obj2id[e]
        q1adr, d1 = m.jnt_qposadr[j1], m.jnt_dofadr[j1]
        coef = [float(v) for v in eq_data[e]]  # python floats: no x64 promotion
        e1 = np.eye(m.nv)[d1]
        if j2 >= 0:
            q2adr, d2 = m.jnt_qposadr[j2], m.jnt_dofadr[j2]
            dq2 = qpos[q2adr] - float(qpos0[q2adr])
            poly = coef[0] + dq2 * (coef[1] + dq2 * (coef[2] + dq2 * (coef[3] + dq2 * coef[4])))
            dpoly = coef[1] + dq2 * (2 * coef[2] + dq2 * (3 * coef[3] + dq2 * 4 * coef[4]))
            pos = (qpos[q1adr] - float(qpos0[q1adr])) - poly
            e2 = np.eye(m.nv)[d2]
            row = const_row(e1) - dpoly[None] * const_row(e2)
            inv_w = float(dof_invweight0[d1] + dof_invweight0[d2])
        else:
            pos = (qpos[q1adr] - float(qpos0[q1adr])) - float(coef[0])
            row = const_row(e1)
            inv_w = float(dof_invweight0[d1])
        imp = impedance_l(eq_solimp[e], pos)
        k, b = kb_from_solref_np(eq_solref[e], eq_solimp[e], ts)
        vel = usum(row * qvel, 0)
        reg_val = (1.0 - imp) / jnp.maximum(imp, _MINIMP) * inv_w
        for sgn in (1.0, -1.0):
            rows_J.append(sgn * row)
            rows_aref.append(sgn * (-b * vel - k * imp * pos))
            rows_reg.append(reg_val)
            rows_active.append(ones)
            rows_diag.append(inv_w * ones)

    # --- joint limits (solver._limit_meta order) ---
    for j in range(m.njnt if m.limit_enabled else 0):
        if not m.jnt_limited[j] or m.jnt_type[j] not in (SLIDE, HINGE):
            continue
        qadr, dadr = m.jnt_qposadr[j], m.jnt_dofadr[j]
        for sgn in (1.0, -1.0):
            q = qpos[qadr]
            dist = (q - float(jnt_range[j, 0])) if sgn > 0 else (float(jnt_range[j, 1]) - q)
            pos = dist - float(jnt_margin[j])
            imp = impedance_l(jnt_solimp[j], pos)
            k, b = kb_from_solref_np(jnt_solref[j], jnt_solimp[j], ts)
            vel = sgn * qvel[dadr]
            rows_J.append(const_row(sgn * np.eye(m.nv)[dadr]))
            rows_aref.append(-b * vel - k * imp * pos)
            rows_reg.append((1.0 - imp) / jnp.maximum(imp, _MINIMP) * float(dof_invweight0[dadr]))
            rows_active.append((dist < float(jnt_margin[j])).astype(dtype))
            rows_diag.append(float(dof_invweight0[dadr]) * ones)

    # --- contacts (STACKED): pyramidal facets, or elliptic rows in GROUPED
    # layout ([all normals | all t1 | all t2] — contiguous blocks so the
    # in-kernel SOC projection is three static slices; mirrors
    # solver.assemble_constraints). All C slots are assembled by ONE set of
    # (C, nv, B)-shaped ops instead of a per-contact Python loop: the row
    # contraction uses the triple-product identity
    # (ANG_v x arm)·d = ANG_v·(arm x d), so the (C, nv, 3, B) world Jacobian
    # is never materialized (see lane_collision module docstring for the
    # stacking rationale).
    c_parts: list | None = None
    if contacts is not None and contacts.ncon:
        CC = contacts.ncon
        # per-component (nv, B) rows of the dof spatial axes: contractions
        # over the 3-axis run as component-sliced (C, nv, B) products — a
        # (C, nv, 3, B) tensor would put the 3-axis in sublanes (3/8-utilized
        # granules, C*nv of them per op; see lane_collision's layout note)
        ANGk = [jnp.stack([cd[k] for cd in com.cdof]) for k in range(3)]  # (nv, B)
        LINk = [jnp.stack([cd[3 + k] for cd in com.cdof]) for k in range(3)]
        # everything below runs on per-COMPONENT (C, B) slices — (C, 3, B)
        # tensors put the 3-axis in sublanes (3/8-utilized granules; see
        # lane_collision's layout note), so vectors live as 3-tuples here
        posk = [contacts.pos[:, k, :] for k in range(3)]
        nk = [contacts.normal[:, k, :] for k in range(3)]
        rc1k = [jnp.stack([com.root_com[b][k] for b in contacts.body1]) for k in range(3)]
        rc2k = [jnp.stack([com.root_com[b][k] for b in contacts.body2]) for k in range(3)]
        arm1k = [posk[k] - rc1k[k] for k in range(3)]
        arm2k = [posk[k] - rc2k[k] for k in range(3)]

        # tangent frame (tangent_frame_l, component form): ref = ex where
        # |n_x| < 0.5 else ey; t1 = n x ref normalized; t2 = n x t1
        use_x = jnp.abs(nk[0]) < 0.5
        zero = jnp.zeros_like(nk[0])
        t1r = [
            jnp.where(use_x, zero, -nk[2]),
            jnp.where(use_x, nk[2], zero),
            jnp.where(use_x, -nk[1], nk[0]),
        ]
        nrm = jnp.sqrt(jnp.maximum(t1r[0] ** 2 + t1r[1] ** 2 + t1r[2] ** 2, 1e-24))
        inv = 1.0 / jnp.maximum(nrm, 1e-12)
        t1k = [c * inv for c in t1r]
        t2k = [
            nk[1] * t1k[2] - nk[2] * t1k[1],
            nk[2] * t1k[0] - nk[0] * t1k[2],
            nk[0] * t1k[1] - nk[1] * t1k[0],
        ]
        # jnp.full-based constant columns (lane_engine.const_col)
        cc1 = lambda v: const_col(np.asarray(v, np.float64), dtype)  # noqa: E731
        cmask = lambda bs: jnp.stack(  # noqa: E731 — (C, nv, 1) dof masks
            [const_col(body_dof_mask[b], dtype) for b in bs]
        )
        m1c = cmask(contacts.body1)
        m2c = cmask(contacts.body2)

        def rows_for(dk: list) -> jnp.ndarray:
            """J·d rows for all contacts: component list [(C, B)]*3 -> (C, nv, B)."""
            w1k = [
                arm1k[1] * dk[2] - arm1k[2] * dk[1],
                arm1k[2] * dk[0] - arm1k[0] * dk[2],
                arm1k[0] * dk[1] - arm1k[1] * dk[0],
            ]
            w2k = [
                arm2k[1] * dk[2] - arm2k[2] * dk[1],
                arm2k[2] * dk[0] - arm2k[0] * dk[2],
                arm2k[0] * dk[1] - arm2k[1] * dk[0],
            ]
            lin_d = sum(LINk[k][None] * dk[k][:, None] for k in range(3))
            ang1 = sum(ANGk[k][None] * w1k[k][:, None] for k in range(3))
            ang2 = sum(ANGk[k][None] * w2k[k][:, None] for k in range(3))
            return m2c * (lin_d + ang2) - m1c * (lin_d + ang1)

        row_n = rows_for(nk)
        row_t1 = rows_for(t1k)
        row_t2 = rows_for(t2k)

        margin_c = cc1(contacts.includemargin)
        pos = contacts.dist - margin_c  # (C, B)
        imp = impedance_lc(contacts.solimp, pos)
        k_np = np.empty(CC)
        b_np = np.empty(CC)
        for i in range(CC):
            k_np[i], b_np[i] = kb_from_solref_np(contacts.solref[i], contacts.solimp[i], ts)
        k_c, b_c = cc1(k_np), cc1(b_np)
        mu_np = np.asarray(contacts.friction, np.float64)
        inv_w_np = np.maximum(
            np.asarray(
                [
                    body_invweight0[b1, 0] + body_invweight0[b2, 0]
                    for b1, b2 in zip(contacts.body1, contacts.body2)
                ]
            ),
            _MINVAL,
        )
        active = (contacts.dist < margin_c).astype(dtype)  # (C, B)

        def contract_vel(row: jnp.ndarray) -> jnp.ndarray:
            prod = row * qvel[None]
            return jnp.sum(prod, axis=1) if m.nv >= 8 else usum(prod, 1)

        if m.cone_pyramidal:
            mu_c = cc1(mu_np)
            diag_np = np.maximum(2.0 * inv_w_np * mu_np**2 * (1.0 + mu_np**2), _MINVAL)
            reg = (1.0 - imp) / jnp.maximum(imp, _MINIMP) * cc1(diag_np)
            facets = jnp.stack(
                [
                    row_n + mu_c[..., None] * row_t1,
                    row_n - mu_c[..., None] * row_t1,
                    row_n + mu_c[..., None] * row_t2,
                    row_n - mu_c[..., None] * row_t2,
                ],
                axis=1,
            )  # (C, 4, nv, B) -> contact-major facet rows
            J_c = facets.reshape(CC * 4, m.nv, B)
            vel = contract_vel(J_c)
            rep4 = lambda a: jnp.repeat(a, 4, axis=0)  # noqa: E731 (C,B)->(4C,B)
            aref_c = -rep4(b_c * jnp.ones_like(pos)) * vel - rep4(k_c * imp * pos)
            c_parts = [J_c, aref_c, rep4(reg), rep4(active), rep4(cc1(diag_np) * jnp.ones_like(active))]
        else:
            # elliptic: friction rows have pos=0 / K=0, share the normal
            # row's impedance, and R is divided by impratio (semantics
            # verified vs CPU MuJoCo efc_*; see solver.py docstring)
            reg_n = (1.0 - imp) / jnp.maximum(imp, _MINIMP) * cc1(inv_w_np)
            reg_t = reg_n / float(_np(m.impratio))
            vel_n = contract_vel(row_n)
            vel_t1 = contract_vel(row_t1)
            vel_t2 = contract_vel(row_t2)
            J_c = jnp.concatenate([row_n, row_t1, row_t2], axis=0)  # grouped
            aref_c = jnp.concatenate(
                [-b_c * vel_n - k_c * imp * pos, -b_c * vel_t1, -b_c * vel_t2], axis=0
            )
            reg_c = jnp.concatenate([reg_n, reg_t, reg_t], axis=0)
            act3 = jnp.concatenate([active, active, active], axis=0)
            diag_c = jnp.broadcast_to(cc1(np.tile(inv_w_np, 3)), (3 * CC, B))
            c_parts = [J_c, aref_c, reg_c, act3, diag_c]

    if not rows_J and c_parts is None:
        return None
    if rows_J:
        lim = [
            jnp.stack(rows_J),
            jnp.stack(rows_aref),
            jnp.stack(rows_reg),
            jnp.stack(rows_active),
            jnp.stack(rows_diag),
        ]
        parts = lim if c_parts is None else [
            jnp.concatenate([a, b], axis=0) for a, b in zip(lim, c_parts)
        ]
    else:
        parts = c_parts
    return LaneRows(J=parts[0], aref=parts[1], reg=parts[2], active=parts[3], diag=parts[4])


def solve_dual_qp_l(
    J: jnp.ndarray,  # (nefc, nv, B)
    minv,  # (nv, nv, B) dense, or dof-island blocks [(start, (k,k,B))]
    reg: jnp.ndarray,  # (nefc, B)
    b: jnp.ndarray,  # (nefc, B)
    iterations: int,
    f_warm: jnp.ndarray | None,
    lipschitz: str = "cw",
    ncon_start: int = 0,
    mus: list | None = None,
    diag: jnp.ndarray | None = None,
    cw_v: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """min_{f in K} 0.5 f^T (J M^-1 J^T + diag(reg)) f + f^T b, APGD in lanes.

    Returns ``(f, cw_v_out)`` where ``cw_v_out`` is the (positive) CW probe
    vector to carry into the next step (see the "cw" branch); callers that
    don't carry it may discard it.

    K is the nonnegative orthant (pyramidal cone / no contacts) or, when
    ``mus`` (static per-contact friction list) is given, the product of
    per-contact second-order cones {||f_t|| <= mu f_n} over the GROUPED
    elliptic rows [normals | t1s | t2s] starting at ``ncon_start`` — the
    projection is three static slices + elementwise math.
    """
    dtype = b.dtype
    nefc, nv = J.shape[0], J.shape[1]
    C = 32

    # minv may be a block-diagonal dof-island decomposition (lane_engine
    # .spd_inverse_blocks) — block mat-vecs skip the zero cross-island work
    from judo_tpu.physics.lane_engine import bd_abs, bd_mat_vec

    dense_minv = not isinstance(minv, list)
    minv_mv = (lambda x: mat_vec_l(minv, x)) if dense_minv else (lambda x: bd_mat_vec(minv, x))
    if dense_minv:
        a_minv = jnp.abs(minv)
        aminv_mv = lambda x: mat_vec_l(a_minv, x)  # noqa: E731
    else:
        a_blocks = bd_abs(minv)
        aminv_mv = lambda x: bd_mat_vec(a_blocks, x)  # noqa: E731

    # Jacobi preconditioning (matches solver.solve_dual_qp_matfree): fold
    # D^-1/2 into J once — Js rows are scaled copies, so apply_A / Lipschitz
    # run on the scaled operator with zero extra per-iteration cost. ``diag``
    # is the static invweight diagApprox from assembly.
    if diag is not None:
        inv_s = jax.lax.rsqrt(jnp.maximum(diag + reg, _MINVAL))  # (nefc, B)
    else:
        inv_s = jnp.ones_like(reg)
    J = J * inv_s[:, None, :]
    reg = reg * inv_s * inv_s
    b = b * inv_s

    if mus:
        from judo_tpu.physics.lane_engine import const_col

        nc = len(mus)
        # Per-row scaling distorts the SOC: f = inv_s * g maps
        # {||f_t|| <= mu f_n} to {||g_t|| <= mu' g_n} with
        # mu' = mu * inv_s_n / inv_s_t (reg_t = reg_n / impratio makes inv_s
        # non-uniform within a triplet even though diag is uniform; both
        # tangent rows share reg_t, so one per-contact-per-lane mu' is
        # exact — matches solver.solve_dual_qp_matfree).
        s_n = inv_s[ncon_start : ncon_start + nc]
        s_t = inv_s[ncon_start + nc : ncon_start + 2 * nc]
        mu_c = const_col(mus, dtype) * s_n / jnp.maximum(s_t, _MINVAL)  # (nc, B)

        def project(z):
            zn = jnp.maximum(z[:ncon_start], 0.0)
            n = z[ncon_start : ncon_start + nc]
            t1 = z[ncon_start + nc : ncon_start + 2 * nc]
            t2 = z[ncon_start + 2 * nc :]
            s = jnp.sqrt(t1 * t1 + t2 * t2)
            inside = s <= mu_c * n
            polar = mu_c * s <= -n  # projection is the origin
            a = (mu_c * s + n) / (1.0 + mu_c * mu_c)
            coef = mu_c * a / jnp.maximum(s, _MINVAL)
            n_out = jnp.where(inside, n, jnp.where(polar, 0.0, a))
            t_scale = jnp.where(inside, 1.0, jnp.where(polar, 0.0, coef))
            return jnp.concatenate([zn, n_out, t1 * t_scale, t2 * t_scale], axis=0)
    else:

        def project(z):
            return jnp.maximum(z, 0.0)

    def apply_A(f):
        return j_vec_chunked(J, minv_mv(jt_vec_chunked(J, f, C)), C) + reg * f

    cw_v_out = jnp.ones_like(b) if cw_v is None else cw_v
    if lipschitz == "cw":
        # Collatz-Wielandt upper bound: with B := |J| |M^-1| |J|^T +
        # diag(reg) (entrywise abs; J/reg already Jacobi-scaled above),
        # |A| <= B entrywise so lambda_max(A) <= rho(B) <= max_i
        # (Bv)_i/v_i for any positive v — a GUARANTEED bound, measured
        # 1.5-2.6x lambda_max vs 31-74x for the Hoelder norms.
        #
        # With ``cw_v`` carried across physics steps (the rollout paths),
        # ONE apply refines it per step — a power iteration distributed
        # over time, converging to B's Perron vector while every
        # intermediate still yields a valid bound (CW holds for ANY
        # positive v). Cold calls (cw_v=None) pay 3 warmup applies.
        def apply_B(v):
            aJ = jnp.abs(J)
            return j_vec_chunked(aJ, aminv_mv(jt_vec_chunked(aJ, v, C)), C) + reg * v

        if cw_v is None:
            v = jnp.ones_like(b)
            for _ in range(3):
                bv = apply_B(v)
                nrm = jax.lax.rsqrt(jnp.maximum(usum(bv * bv, 0), _MINVAL))
                v = bv * nrm[None]
        else:
            # carried probe: keep it positive and normalized (guards
            # against accumulated underflow in long rollouts)
            nrm = jax.lax.rsqrt(jnp.maximum(usum(cw_v * cw_v, 0), _MINVAL))
            v = jnp.maximum(cw_v * nrm[None], 1e-7)
        bv = apply_B(v)
        L = jnp.max(bv / jnp.maximum(v, 1e-12), axis=0)  # (B,)
        nrm = jax.lax.rsqrt(jnp.maximum(usum(bv * bv, 0), _MINVAL))
        cw_v_out = bv * nrm[None]
    elif lipschitz == "power":
        # from-below norm-ratio estimate x1.25 — NOT a valid bound;
        # diverges on stiff scenes (measured). Experiments only.
        v = jnp.maximum(jnp.abs(b), 1e-3)
        lam = jnp.ones(b.shape[-1], dtype)
        for _ in range(4):
            av = apply_A(v)
            nrm_av = jnp.sqrt(jnp.maximum(usum(av * av, 0), _MINVAL))
            nrm_v = jnp.sqrt(jnp.maximum(usum(v * v, 0), _MINVAL))
            lam = nrm_av / nrm_v  # ||Av||/||v|| <= lambda_max for PSD A
            v = av / nrm_av[None]
        L = 1.25 * jnp.maximum(lam, _MINVAL) + jnp.max(reg, axis=0)
    else:  # "holder": the reference two-factor bound (always valid)
        assert dense_minv, "holder Lipschitz needs a dense minv (use lipschitz='cw' for blocks)"
        Jh = J

        def ob(mat, row_axis, col_axis):
            l1 = jnp.max(usum(jnp.abs(mat), row_axis), axis=0)  # (B,)
            linf = jnp.max(usum(jnp.abs(mat), col_axis), axis=0)
            return jnp.sqrt(jnp.maximum(l1 * linf, _MINVAL))

        B_ = b.shape[-1]
        row_abs_sum = jnp.zeros((nv, B_), dtype)  # sum_r |K[k, r]| per k
        col_max = jnp.zeros(B_, dtype)  # max_r sum_k |K[k, r]|
        for r0 in range(0, nefc, C):
            Jc = Jh[r0 : r0 + C]  # (c, nv, B)
            Kc = None  # (nv, c, B) = M^-1 J[r0:r0+C]^T
            for k in range(nv):
                t = minv[:, k, :][:, None, :] * Jc[:, k, :][None, :, :]
                Kc = t if Kc is None else Kc + t
            aK = jnp.abs(Kc)
            row_abs_sum = row_abs_sum + usum(aK, 1)
            col_max = jnp.maximum(col_max, jnp.max(usum(aK, 0), axis=0))
        obK = jnp.sqrt(jnp.maximum(jnp.max(row_abs_sum, axis=0) * col_max, _MINVAL))

        L = ob(Jh, 0, 1) * obK + jnp.max(reg, axis=0)
    step = 1.0 / jnp.maximum(L, _MINVAL)  # (B,)

    f0 = jnp.zeros_like(b) if f_warm is None else project(f_warm / jnp.maximum(inv_s, _MINVAL))

    def body(_, carry):
        f, y, t = carry
        grad = apply_A(y) + b
        f_new = project(y - step[None] * grad)
        t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        y_new = f_new + ((t - 1.0) / t_new)[None] * (f_new - f)
        restart = usum(grad * (f_new - f), 0) > 0  # (B,)
        y_new = jnp.where(restart[None], f_new, y_new)
        t_new = jnp.where(restart, jnp.ones_like(t_new), t_new)
        return (f_new, y_new, t_new)

    t0 = jnp.ones(b.shape[-1], dtype)
    f, _, _ = jax.lax.fori_loop(0, iterations, body, (f0, f0, t0))
    return f * inv_s, cw_v_out  # un-scale: g -> f


def implicit_damping_np(m: PhysicsModel) -> np.ndarray:
    """Host-side per-dof implicit damping diagonal (step.implicit_damping)."""
    damp = _np(m.dof_damping).copy()
    if m.integrator == INT_IMPLICITFAST:
        gear = _np(m.actuator_gear)[:, 0] if m.nu else np.zeros(0)
        bias = _np(m.actuator_biasprm) if m.nu else np.zeros((0, 10))
        for u in range(m.nu):
            dadr = m.jnt_dofadr[m.actuator_trnid[u]]
            damp[dadr] += -bias[u, 2] * gear[u] * gear[u]
    return damp


def integrate_pos_l(m: PhysicsModel, qpos: jnp.ndarray, qvel: jnp.ndarray, h: float) -> jnp.ndarray:
    """mj_integratePos in lanes: per-joint static slices, one final stack."""
    segs: list = []
    cursor = 0
    for j in range(m.njnt):
        jt = m.jnt_type[j]
        qadr, dadr = m.jnt_qposadr[j], m.jnt_dofadr[j]
        assert qadr == cursor, "qpos layout must be joint-contiguous"
        if jt in (SLIDE, HINGE):
            segs.append(qpos[qadr : qadr + 1] + h * qvel[dadr : dadr + 1])
            cursor += 1
        elif jt == BALL:
            segs.append(l_quat_integrate(qpos[qadr : qadr + 4], qvel[dadr : dadr + 3], h))
            cursor += 4
        elif jt == FREE:
            segs.append(qpos[qadr : qadr + 3] + h * qvel[dadr : dadr + 3])
            segs.append(l_quat_integrate(qpos[qadr + 3 : qadr + 7], qvel[dadr + 3 : dadr + 6], h))
            cursor += 7
    if cursor < m.nq:
        segs.append(qpos[cursor:])
    if not segs:
        return qpos
    return jnp.concatenate(segs, axis=0)


# ---------------------------------------------------------------------------
# sensors
# ---------------------------------------------------------------------------


def _distance_sensor_l(m: PhysicsModel, kin: LaneKin, body1: int, body2: int, cutoff: float) -> jnp.ndarray:
    """mjSENS_GEOMDIST in lanes (sensors._distance_sensor semantics)."""
    from judo_tpu.physics.lane_collision import _L_KERNELS

    # python-float rows to avoid np.float64 promotion under x64 (see
    # lane_collision.find_contacts_l)
    geom_size = [[float(v) for v in row] for row in _np(m.geom_size)]
    dists = [jnp.full(kin.xpos[0].shape[-1], float(cutoff), kin.xpos[0].dtype)]
    for g1 in range(m.ngeom):
        if m.geom_bodyid[g1] != body1 and m.geom_bodyid[g1] != body2:
            continue
        for g2 in range(m.ngeom):
            if m.geom_bodyid[g1] == body1 and m.geom_bodyid[g2] != body2:
                continue
            if m.geom_bodyid[g1] == body2 and m.geom_bodyid[g2] != body1:
                continue
            if m.geom_bodyid[g1] == m.geom_bodyid[g2]:
                continue
            a, b = (g1, g2) if m.geom_type[g1] <= m.geom_type[g2] else (g2, g1)
            if a != g1:
                continue
            kernel = _L_KERNELS.get((m.geom_type[a], m.geom_type[b]))
            if kernel is None:
                continue
            slots = kernel(
                kin.geom_xpos[a], kin.geom_xmat[a], geom_size[a],
                kin.geom_xpos[b], kin.geom_xmat[b], geom_size[b],
            )
            for d, _, _ in slots:
                dists.append(d)
    out = dists[0]
    for d in dists[1:]:
        out = jnp.minimum(out, d)
    return out


def evaluate_sensors_l(
    m: PhysicsModel, kin: LaneKin, qpos: jnp.ndarray, qvel: jnp.ndarray
) -> jnp.ndarray:
    """Flat (nsensordata, B) sensordata (sensors.evaluate_sensors semantics)."""
    dtype = qpos.dtype
    B = qpos.shape[-1]
    site_quat = _np(m.site_quat) if m.nsite else np.zeros((0, 4))
    body_iquat = _np(m.body_iquat)
    sensor_cutoff = _np(m.sensor_cutoff) if m.nsensor else np.zeros(0)

    segs: list = []
    cursor = 0

    def emit(adr: int, dim: int, val: jnp.ndarray | None) -> None:
        nonlocal cursor
        assert adr >= cursor
        if adr > cursor:
            segs.append(jnp.zeros((adr - cursor, B), dtype))
        if val is None:
            segs.append(jnp.zeros((dim, B), dtype))
        else:
            segs.append(val if val.ndim == 2 else val[None])
        cursor = adr + dim

    from judo_tpu.physics.lane_engine import const_col as _cc

    def const4(v) -> jnp.ndarray:
        return jnp.broadcast_to(_cc(v, dtype), (4, B))

    for i in range(m.nsensor):
        stype = m.sensor_type[i]
        objtype = m.sensor_objtype[i]
        objid = m.sensor_objid[i]
        adr, dim = m.sensor_adr[i], m.sensor_dim[i]
        val = None
        if stype == SENSOR_JOINTPOS:
            val = qpos[m.jnt_qposadr[objid]]
        elif stype == SENSOR_JOINTVEL:
            val = qvel[m.jnt_dofadr[objid]]
        elif stype == SENSOR_FRAMEPOS:
            if objtype == _OBJ_SITE:
                val = kin.site_xpos[objid]
            elif objtype in (_OBJ_BODY, _OBJ_XBODY):
                val = kin.xipos[objid] if objtype == _OBJ_BODY else kin.xpos[objid]
            if val is not None:
                refid = m.sensor_refid[i]
                if refid >= 0 and m.sensor_reftype[i] == _OBJ_SITE:
                    rel = val - kin.site_xpos[refid]
                    val = usum(kin.site_xmat[refid] * rel[:, None, :], 0)
        elif stype == SENSOR_DISTANCE and objtype == _OBJ_BODY:
            val = _distance_sensor_l(m, kin, objid, m.sensor_refid[i], float(sensor_cutoff[i]))
        elif stype in (SENSOR_FRAMEXAXIS, SENSOR_FRAMEYAXIS, SENSOR_FRAMEZAXIS):
            col = {SENSOR_FRAMEXAXIS: 0, SENSOR_FRAMEYAXIS: 1, SENSOR_FRAMEZAXIS: 2}[stype]
            if objtype == _OBJ_SITE:
                val = kin.site_xmat[objid][:, col, :]
            elif objtype in (_OBJ_BODY, _OBJ_XBODY):
                val = kin.xmat[objid][:, col, :]
        elif stype == SENSOR_FRAMEQUAT:
            if objtype == _OBJ_SITE:
                b = m.site_bodyid[objid]
                val = l_quat_mul(kin.xquat[b], const4(site_quat[objid]))
            elif objtype in (_OBJ_BODY, _OBJ_XBODY):
                val = (
                    l_quat_mul(kin.xquat[objid], const4(body_iquat[objid]))
                    if objtype == _OBJ_BODY
                    else kin.xquat[objid]
                )
        emit(adr, dim, val)

    if cursor < m.nsensordata:
        segs.append(jnp.zeros((m.nsensordata - cursor, B), dtype))
    if not segs:
        return jnp.zeros((m.nsensordata, B), dtype)
    return jnp.concatenate(segs, axis=0).astype(dtype)


# ---------------------------------------------------------------------------
# the full step
# ---------------------------------------------------------------------------


class LaneStepOut(NamedTuple):
    qpos: jnp.ndarray  # (nq, B)
    qvel: jnp.ndarray  # (nv, B)
    sensordata: jnp.ndarray  # (nsensordata, B)
    efc_force: jnp.ndarray  # (nefc, B) warm-start carry
    cw_v: jnp.ndarray  # (nefc, B) carried CW probe vector (see solve_dual_qp_l)


def num_constraint_rows(m: PhysicsModel) -> int:
    from judo_tpu.physics.solver import num_constraint_rows as _n

    return _n(m)


def step_l(
    m: PhysicsModel,
    qpos: jnp.ndarray,  # (nq, B)
    qvel: jnp.ndarray,  # (nv, B)
    ctrl: jnp.ndarray,  # (nu, B)
    f_warm: jnp.ndarray | None = None,  # (nefc, B)
    solver_iterations: int | None = None,
    lipschitz: str = "cw",
    cw_v: jnp.ndarray | None = None,  # (nefc, B) carried CW probe
) -> LaneStepOut:
    """One mj_step, batch-last — semantics of step.step_with_forward with
    exact per-step inverses (cold path)."""
    h = float(_np(m.timestep))
    kin = le.kinematics_l(m, qpos)
    com = le.com_l(m, kin)
    vel = le.velocity_l(m, com, qvel)
    mm = le.crb_mass_matrix_l(m, com)
    qfrc_bias = le.rne_bias_l(m, com, vel, qvel)
    qfrc_smooth = le.actuation_l(m, qpos, qvel, ctrl) + le.passive_force_l(m, qpos, qvel) - qfrc_bias

    # exact inverses via independent dof-island blocks (lane_engine
    # .dof_islands: ~45x fewer elimination MACs on leap); the legacy holder
    # Lipschitz needs the dense form
    from judo_tpu.physics.lane_engine import bd_mat_vec, spd_inverse_blocks

    if lipschitz == "holder":
        minv = spd_inverse_l(mm)
        minv_mv = lambda x: mat_vec_l(minv, x)  # noqa: E731
    else:
        minv = spd_inverse_blocks(m, mm)
        minv_mv = lambda x: bd_mat_vec(minv, x)  # noqa: E731
    qacc_smooth = minv_mv(qfrc_smooth)

    from judo_tpu.physics.collision import num_contact_slots

    has_contacts = m.contact_enabled and num_contact_slots(m) > 0
    nefc = num_constraint_rows(m)

    # sensors BEFORE the solver: they only need kinematics + (qpos, qvel), and
    # evaluating them here ends the live ranges of the per-body/geom frames
    # before the APGD loop
    sens = evaluate_sensors_l(m, kin, qpos, qvel)

    if nefc > 0:
        contacts = find_contacts_l(m, kin) if has_contacts else None
        rows = assemble_constraints_l(m, com, contacts, qpos, qvel)
        J = rows.J * rows.active[:, None, :]
        aref = rows.aref * rows.active
        reg = jnp.where(rows.active > 0, rows.reg, 1.0)
        b = j_vec_chunked(J, qacc_smooth) - aref
        iters = max(m.solver_iterations if solver_iterations is None else solver_iterations, 8)
        from judo_tpu.physics.solver import num_noncontact_rows

        mus = None
        if not m.cone_pyramidal and contacts is not None:
            mus = [float(v) for v in contacts.friction]
        diag = jnp.where(rows.active > 0, rows.diag, 1.0)
        f, cw_v_out = solve_dual_qp_l(
            J, minv, reg, b, iters, f_warm, lipschitz,
            ncon_start=num_noncontact_rows(m), mus=mus, diag=diag, cw_v=cw_v,
        )
        qacc = qacc_smooth + minv_mv(jt_vec_chunked(J, f))
    else:
        f = jnp.zeros((0, qpos.shape[-1]), qpos.dtype)
        cw_v_out = jnp.zeros((0, qpos.shape[-1]), qpos.dtype)
        qacc = qacc_smooth

    # implicit-in-velocity damping integration (step.step_with_forward)
    from judo_tpu.physics.lane_engine import const_col, eye_mask

    damp = implicit_damping_np(m)
    mh = mm + h * eye_mask(m.nv, qpos.dtype) * const_col(damp, qpos.dtype)[:, :, None]
    if lipschitz == "holder":
        mhinv_mv = lambda x: mat_vec_l(spd_inverse_l(mh), x)  # noqa: E731
    else:
        mh_blocks = spd_inverse_blocks(m, mh)
        mhinv_mv = lambda x: bd_mat_vec(mh_blocks, x)  # noqa: E731
    # mm is block-diagonal over the same islands; full mat_vec keeps parity
    dv = mhinv_mv(h * mat_vec_l(mm, qacc))
    qvel_new = qvel + dv
    qpos_new = integrate_pos_l(m, qpos, qvel_new, h)
    return LaneStepOut(qpos=qpos_new, qvel=qvel_new, sensordata=sens, efc_force=f, cw_v=cw_v_out)
