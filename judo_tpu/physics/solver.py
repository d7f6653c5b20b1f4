"""Constraint assembly and the contact/limit solver.

Implements MuJoCo's soft-constraint model (impedance d(r), reference
acceleration aref = -b*vel - k*d*pos, regularizer R = (1-d)/d * diagA) with
BOTH friction-cone formulations, selected by the model's ``cone`` option:

- pyramidal (MuJoCo default): 4 facet rows per condim-3 contact, dual
  constraint f >= 0 elementwise;
- elliptic (leap/fr3 scenes declare ``cone="elliptic" impratio="100"``):
  3 rows per contact (normal, t1, t2), dual constraint ||f_t|| <= mu * f_n
  (second-order cone). Row semantics verified against CPU MuJoCo's efc_*
  arrays: the friction rows carry pos=0 and K=0 (aref = -B*vel only), share
  the normal row's impedance, diag_approx is the bodies' invweight0 sum, and
  the friction rows' regularizer is divided by impratio (which stiffens
  friction without changing the slip threshold mu*N — verified empirically).

Either way the dual cone-projected QP

    min_{f in K}  0.5 f^T (A + R) f + f^T (J qacc_smooth - aref),
    A = J M^-1 J^T

is solved with fixed-iteration accelerated projected gradient descent (APGD);
the SOC projection per elliptic triplet costs a handful of elementwise ops.
Unlike sequential Gauss-Seidel sweeps, every APGD iteration is a dense
matvec — the formulation that vectorizes across the rollout batch.
Elliptic is also the cheaper formulation: 3 rows/contact instead of 4
(25% less APGD matvec work on the leap scene).

Assembly is fully vectorized over the (static-size) contact set: the per-row
Jacobians, impedances and regularizers are computed as batched tensor ops, so
the HLO graph size is independent of the number of contacts — which keeps
both compile time and sequential-op overhead flat as scenes grow
(leap_cube has ~70 contact slots; a per-contact Python loop was ~10x the ops).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from judo_tpu.physics.collision import Contacts
from judo_tpu.physics.model import EQ_JOINT, HINGE, SLIDE, PhysicsModel
from judo_tpu.physics.smooth import ComQuants, Kinematics

_MINIMP, _MAXIMP = 1e-4, 0.9999
_MINVAL = 1e-15
_PRECONDITION = True  # Jacobi-precondition the dual APGD (A/B hatch)


class ConstraintRows(NamedTuple):
    J: jnp.ndarray  # (nefc, nv)
    aref: jnp.ndarray  # (nefc,)
    reg: jnp.ndarray  # (nefc,) regularizer R diagonal
    active: jnp.ndarray  # (nefc,) 0/1 mask
    diag: jnp.ndarray  # (nefc,) invweight0 diag(J M^-1 J^T) approximation
    # (MuJoCo's diagApprox — used as the APGD Jacobi preconditioner)


def impedance(solimp: jnp.ndarray, pos: jnp.ndarray) -> jnp.ndarray:
    """MuJoCo's constraint impedance d(r), batched over leading dims."""
    dmin, dmax, width, mid, power = (
        solimp[..., 0], solimp[..., 1], solimp[..., 2], solimp[..., 3], solimp[..., 4],
    )
    x = jnp.clip(jnp.abs(pos) / jnp.maximum(width, _MINVAL), 0.0, 1.0)
    mid = jnp.clip(mid, _MINIMP, _MAXIMP)
    power = jnp.maximum(power, 1.0)
    lo = (mid ** (1.0 - power)) * x**power
    hi = 1.0 - ((1.0 - mid) ** (1.0 - power)) * (1.0 - x) ** power
    y = jnp.where(x <= mid, lo, hi)
    y = jnp.where(power == 1.0, x, y)
    return jnp.clip(dmin + y * (dmax - dmin), _MINIMP, _MAXIMP)


def kb_from_solref(
    solref: jnp.ndarray, solimp: jnp.ndarray, timestep: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Stiffness/damping from solref (standard positive / direct negative).

    MuJoCo clamps the effective timeconst to >= 2*timestep (verified against
    efc_KBIP), which matters for coarse-timestep models like cylinder_push.
    """
    dmax = jnp.clip(solimp[..., 1], _MINIMP, _MAXIMP)
    timeconst = jnp.maximum(solref[..., 0], 2.0 * timestep)
    dampratio = solref[..., 1]
    k_std = 1.0 / jnp.maximum(dmax * dmax * timeconst * timeconst * dampratio * dampratio, _MINVAL)
    b_std = 2.0 / jnp.maximum(dmax * timeconst, _MINVAL)
    k = jnp.where(solref[..., 0] > 0, k_std, -solref[..., 0])
    b = jnp.where(solref[..., 0] > 0, b_std, -solref[..., 1])
    return k, b


def _limit_meta(m: PhysicsModel):
    """Static per-limit metadata (dof index, side) as numpy arrays."""
    dofs, sides, jids = [], [], []
    for j in range(m.njnt if m.limit_enabled else 0):
        if not m.jnt_limited[j] or m.jnt_type[j] not in (SLIDE, HINGE):
            continue
        for sgn in (1.0, -1.0):
            jids.append(j)
            dofs.append(m.jnt_dofadr[j])
            sides.append(sgn)
    return np.asarray(jids, np.int32), np.asarray(dofs, np.int32), np.asarray(sides)


def assemble_constraints(
    m: PhysicsModel,
    com: ComQuants,
    contacts: Contacts,
    qpos: jnp.ndarray,
    qvel: jnp.ndarray,
) -> ConstraintRows:
    """Build efc rows (equalities, joint limits, pyramidal contact facets)."""
    dtype = qvel.dtype
    blocks_J, blocks_aref, blocks_reg, blocks_active = [], [], [], []
    blocks_diag = []

    # --- joint equality couplings (mjEQ_JOINT), as +/- one-sided row pairs ---
    # rows are built from constant one-hot basis vectors scaled by computed
    # scalars — never with .at[] scatter writes inside the scan
    for e in range(m.neq):
        if m.eq_type[e] != EQ_JOINT:
            continue  # connect/weld equalities: not yet supported
        j1, j2 = m.eq_obj1id[e], m.eq_obj2id[e]
        q1adr, d1 = m.jnt_qposadr[j1], m.jnt_dofadr[j1]
        coef = m.eq_data[e]
        e1 = jnp.asarray(np.eye(m.nv)[d1], dtype)
        if j2 >= 0:
            q2adr, d2 = m.jnt_qposadr[j2], m.jnt_dofadr[j2]
            dq2 = qpos[q2adr] - m.qpos0[q2adr]
            poly = coef[0] + dq2 * (coef[1] + dq2 * (coef[2] + dq2 * (coef[3] + dq2 * coef[4])))
            dpoly = coef[1] + dq2 * (2 * coef[2] + dq2 * (3 * coef[3] + dq2 * 4 * coef[4]))
            pos = (qpos[q1adr] - m.qpos0[q1adr]) - poly
            e2 = jnp.asarray(np.eye(m.nv)[d2], dtype)
            row = e1 - dpoly * e2
            inv_w = m.dof_invweight0[d1] + m.dof_invweight0[d2]
        else:
            pos = (qpos[q1adr] - m.qpos0[q1adr]) - coef[0]
            row = e1
            inv_w = m.dof_invweight0[d1]
        imp = impedance(m.eq_solimp[e], pos)
        k, b = kb_from_solref(m.eq_solref[e], m.eq_solimp[e], m.timestep)
        vel = row @ qvel
        reg_val = (1.0 - imp) / jnp.maximum(imp, _MINIMP) * inv_w
        for sgn in (1.0, -1.0):
            blocks_J.append((sgn * row)[None])
            blocks_aref.append(jnp.asarray(sgn * (-b * vel - k * imp * pos), dtype)[None])
            blocks_reg.append(jnp.asarray(reg_val, dtype)[None])
            blocks_active.append(jnp.ones(1, dtype))
            blocks_diag.append(jnp.full(1, inv_w, dtype))

    # --- joint limits (vectorized over the static limited-joint list) ---
    jids, dofs, sides = _limit_meta(m)
    if len(jids):
        nl = len(jids)
        jids_np = np.asarray(jids, np.int64)
        jids_a = jnp.asarray(jids)
        sides_a = jnp.asarray(sides, dtype)
        jr = np.asarray(m.jnt_range)
        lo = jnp.asarray(jr[jids_np, 0])
        hi = jnp.asarray(jr[jids_np, 1])
        margin = jnp.asarray(np.asarray(m.jnt_margin)[jids_np])
        # qpos/qvel reads as constant one-hot matmuls; J is fully constant
        sel_q = np.zeros((nl, m.nq))
        sel_v = np.zeros((nl, m.nv))
        for r in range(nl):
            sel_q[r, m.jnt_qposadr[jids[r]]] = 1.0
            sel_v[r, dofs[r]] = sides[r]
        q = jnp.asarray(sel_q, dtype) @ qpos
        dist = jnp.where(sides_a > 0, q - lo, hi - q)
        pos = dist - margin
        imp = impedance(jnp.asarray(np.asarray(m.jnt_solimp)[jids_np]), pos)
        k, b = kb_from_solref(jnp.asarray(np.asarray(m.jnt_solref)[jids_np]), jnp.asarray(np.asarray(m.jnt_solimp)[jids_np]), m.timestep)
        J = jnp.asarray(sel_v, dtype)  # (nl, nv) constant
        vel = J @ qvel
        blocks_J.append(J)
        blocks_aref.append(-b * vel - k * imp * pos)
        blocks_reg.append(
            (1.0 - imp) / jnp.maximum(imp, _MINIMP) * (jnp.abs(J) @ m.dof_invweight0)
        )
        blocks_active.append((dist < margin).astype(dtype))
        blocks_diag.append(jnp.abs(J) @ m.dof_invweight0)

    # --- contacts: pyramidal facets or elliptic triplets, vectorized ---
    ncon = contacts.dist.shape[0]
    if ncon:
        b1 = np.asarray(contacts.body1, np.int32)
        b2 = np.asarray(contacts.body2, np.int32)
        root1 = np.asarray([m.body_rootid[b] for b in b1], np.int32)
        root2 = np.asarray([m.body_rootid[b] for b in b2], np.int32)

        # root-CoM reads on the computed subtree_com: one-hot const matmuls
        # (instead of index-array gathers inside the scan)
        def _sel(rows: np.ndarray) -> jnp.ndarray:
            s = np.zeros((len(rows), m.nbody))
            s[np.arange(len(rows)), rows] = 1.0
            return jnp.asarray(s, dtype)

        arm1 = contacts.pos - _sel(root1) @ com.subtree_com  # (C, 3)
        arm2 = contacts.pos - _sel(root2) @ com.subtree_com
        cdof_ang = com.cdof[:, :3]  # (nv, 3)
        cdof_lin = com.cdof[:, 3:]
        # point jacobian per contact: (C, nv, 3)
        lin1 = cdof_lin[None] + jnp.cross(cdof_ang[None], arm1[:, None, :])
        lin2 = cdof_lin[None] + jnp.cross(cdof_ang[None], arm2[:, None, :])
        # constant masks (body_dof_mask is a model constant, b1/b2 static)
        mask1 = jnp.asarray(np.asarray(m.body_dof_mask)[np.asarray(b1)])[:, :, None]  # (C, nv, 1)
        mask2 = jnp.asarray(np.asarray(m.body_dof_mask)[np.asarray(b2)])[:, :, None]
        jac = mask2 * lin2 - mask1 * lin1  # (C, nv, 3)

        # frame rows: (C, 3, nv) = frame (C,3,3) @ jac^T
        rows3 = jnp.einsum("cfk,cvk->cfv", contacts.frame, jac)
        n_row, t1_row, t2_row = rows3[:, 0], rows3[:, 1], rows3[:, 2]

        pos = contacts.dist - contacts.includemargin  # (C,)
        imp = impedance(contacts.solimp, pos)
        k, b = kb_from_solref(contacts.solref, contacts.solimp, m.timestep)
        _biw = np.asarray(m.body_invweight0)
        inv_w = jnp.asarray(_biw[np.asarray(b1), 0] + _biw[np.asarray(b2), 0])
        mu = contacts.friction[:, None]  # (C, 1)
        mu_s = contacts.friction
        active1 = (contacts.dist < contacts.includemargin).astype(dtype)

        if m.cone_pyramidal:
            # pyramid: [n+mu t1, n-mu t1, n+mu t2, n-mu t2] -> (C, 4, nv)
            rows = jnp.stack(
                [
                    n_row + mu * t1_row,
                    n_row - mu * t1_row,
                    n_row + mu * t2_row,
                    n_row - mu * t2_row,
                ],
                axis=1,
            )
            vel = jnp.einsum("crv,v->cr", rows, qvel)  # (C, 4)
            aref = -b[:, None] * vel - (k * imp * pos)[:, None]
            diag_approx = jnp.maximum(2.0 * inv_w * mu_s * mu_s * (1.0 + mu_s * mu_s), _MINVAL)
            reg = ((1.0 - imp) / jnp.maximum(imp, _MINIMP) * diag_approx)[:, None].repeat(4, 1)
            active = active1[:, None].repeat(4, 1)
            blocks_J.append(rows.reshape(ncon * 4, m.nv))
            blocks_aref.append(aref.reshape(-1))
            blocks_reg.append(reg.reshape(-1))
            blocks_active.append(active.reshape(-1))
            blocks_diag.append(diag_approx[:, None].repeat(4, 1).reshape(-1))
        else:
            # elliptic rows in GROUPED layout: [all normals | all t1 | all t2]
            # (contiguous blocks make the SOC projection static slices; the
            # lanes solver in lane_step.py uses the same layout).
            # Friction rows carry pos=0 / K=0 (aref = -B*vel) and R divided by
            # impratio; all three share the normal row's impedance (verified
            # against CPU MuJoCo efc_* arrays, see module docstring).
            vel = jnp.einsum("crv,v->cr", rows3, qvel)  # (C, 3)
            aref_n = -b * vel[:, 0] - k * imp * pos
            aref_t = -b[:, None] * vel[:, 1:]  # (C, 2)
            reg_n = (1.0 - imp) / jnp.maximum(imp, _MINIMP) * jnp.maximum(inv_w, _MINVAL)
            reg_t = reg_n / m.impratio
            blocks_J.append(jnp.concatenate([n_row, t1_row, t2_row], axis=0))
            blocks_aref.append(jnp.concatenate([aref_n, aref_t[:, 0], aref_t[:, 1]]))
            blocks_reg.append(jnp.concatenate([reg_n, reg_t, reg_t]))
            blocks_active.append(jnp.concatenate([active1, active1, active1]))
            iw = jnp.maximum(inv_w, _MINVAL)
            blocks_diag.append(jnp.concatenate([iw, iw, iw]))

    if not blocks_J:
        return ConstraintRows(
            jnp.zeros((0, m.nv), dtype), jnp.zeros(0, dtype), jnp.ones(0, dtype),
            jnp.zeros(0, dtype), jnp.ones(0, dtype),
        )
    return ConstraintRows(
        jnp.concatenate(blocks_J, axis=0),
        jnp.concatenate(blocks_aref),
        jnp.concatenate(blocks_reg),
        jnp.concatenate(blocks_active),
        jnp.concatenate(blocks_diag),
    )


def contact_rows_per(m: PhysicsModel) -> int:
    """Rows per condim-3 contact: 4 pyramid facets or 3 elliptic rows."""
    return 4 if m.cone_pyramidal else 3


def num_noncontact_rows(m: PhysicsModel) -> int:
    """Static count of rows BEFORE the contact block (equalities + limits) —
    the rows whose dual projection is plain max(f, 0) in both cone modes."""
    neq_joint = sum(1 for e in range(m.neq) if m.eq_type[e] == EQ_JOINT)
    return 2 * neq_joint + len(_limit_meta(m)[0])


def num_constraint_rows(m: PhysicsModel) -> int:
    """Static efc row count produced by assemble_constraints (for warm-start
    buffers carried across scan steps)."""
    from judo_tpu.physics.collision import num_contact_slots

    ncon = num_contact_slots(m) if m.contact_enabled else 0
    return num_noncontact_rows(m) + contact_rows_per(m) * ncon


def project_dual(
    z: jnp.ndarray,  # (nefc,)
    ncon_start: int,
    mus: jnp.ndarray | None,  # (C,) friction coefficients, None for pyramidal
) -> jnp.ndarray:
    """Project a dual iterate onto the feasible cone.

    Pyramidal (``mus is None``): elementwise max(z, 0). Elliptic: non-contact
    rows are clamped at 0; each contact's (n, t1, t2) — stored GROUPED as
    [normals | t1s | t2s] after ``ncon_start`` — is projected onto the
    second-order cone {||t|| <= mu n} (exact Euclidean projection).
    """
    if mus is None:
        return jnp.maximum(z, 0.0)
    mus = mus.astype(z.dtype)  # don't let f64 friction promote an f32 iterate
    zn = jnp.maximum(z[:ncon_start], 0.0)
    C = mus.shape[0]
    n = z[ncon_start : ncon_start + C]
    t1 = z[ncon_start + C : ncon_start + 2 * C]
    t2 = z[ncon_start + 2 * C :]
    s = jnp.sqrt(t1 * t1 + t2 * t2)
    inside = s <= mus * n
    polar = mus * s <= -n  # projection is the origin
    a = (mus * s + n) / (1.0 + mus * mus)
    coef = mus * a / jnp.maximum(s, _MINVAL)
    n_out = jnp.where(inside, n, jnp.where(polar, 0.0, a))
    t_scale = jnp.where(inside, 1.0, jnp.where(polar, 0.0, coef))
    return jnp.concatenate([zn, n_out, t1 * t_scale, t2 * t_scale])


def solve_dual_qp_matfree(
    J: jnp.ndarray,  # (nefc, nv)
    minv_jt: jnp.ndarray,  # (nv, nefc)
    reg: jnp.ndarray,  # (nefc,)
    b: jnp.ndarray,  # (nefc,)
    iterations: int,
    f_warm: jnp.ndarray | None = None,
    ncon_start: int = 0,
    mus: jnp.ndarray | None = None,
    diag: jnp.ndarray | None = None,
    lipschitz: str = "cw",
) -> jnp.ndarray:
    """min_{f in K} 0.5 f^T (J M^-1 J^T + diag(reg)) f + f^T b via APGD,
    K = nonnegative orthant (pyramidal) or per-contact SOC (elliptic; see
    project_dual).

    Matrix-free: the dual operator is applied as two (nefc, nv) matvecs
    instead of materializing the (nefc, nefc) Delassus matrix — for
    contact-rich scenes (nefc ~ 300, nv ~ 25) this cuts FLOPs and HBM
    traffic by ~nefc/(2 nv).
    The Lipschitz constant comes from a short power iteration.
    """
    dtype = J.dtype
    nefc = b.shape[0]
    if nefc == 0:
        return b
    # mixed-precision inputs (f32 carry vs f64 model constants under x64)
    # must not flip the scan carry dtype between iterations
    b = b.astype(dtype)
    reg = reg.astype(dtype)
    if f_warm is not None:
        f_warm = f_warm.astype(dtype)
    if mus is not None:
        mus = mus.astype(dtype)

    # Jacobi preconditioning: solve in g = D^1/2 f with D ~ diag(A) + reg.
    # Contact-rich scenes mix near-rigid limit/equality rows (tiny reg, huge
    # aref stiffness) with soft contact rows — condition numbers >1e4 — and
    # fixed-step APGD needs hundreds of iterations unpreconditioned (measured
    # on fr3_pick: qacc error ~1e3 at 25 iters). Diagonal scaling clusters
    # the spectrum; the orthant is invariant under any positive row scaling.
    # When no diag is supplied, the exact diag(A) is computed (one
    # elementwise pass).
    if diag is None:
        diag = jnp.sum(J * minv_jt.T, axis=1)
        if mus is not None:
            C = mus.shape[0]
            d_n = diag[ncon_start : ncon_start + C]
            diag = jnp.concatenate([diag[:ncon_start], d_n, d_n, d_n])
    diagA = diag.astype(dtype) + reg
    if not _PRECONDITION:  # A/B escape hatch (scratch benchmarking only)
        diagA = jnp.ones_like(diagA)
    inv_s = jax.lax.rsqrt(jnp.maximum(diagA, _MINVAL))  # D^-1/2
    # Elliptic cone under per-row scaling: substituting f = inv_s * g maps
    # {||f_t|| <= mu f_n} to {||g_t|| <= mu' g_n} with
    # mu' = mu * inv_s_n / inv_s_t. Although the diag approximation is
    # uniform per contact triplet, reg is NOT (reg_t = reg_n / impratio), so
    # inv_s differs between normal and tangent rows; both tangent rows share
    # reg_t, so one per-contact mu' transforms the cone exactly. Projecting
    # with the original mu in g-space would solve a QP with an inflated,
    # impedance-dependent friction mu*sqrt((d+reg_n)/(d+reg_t)).
    if mus is not None:
        C = mus.shape[0]
        s_n = inv_s[ncon_start : ncon_start + C]
        s_t = inv_s[ncon_start + C : ncon_start + 2 * C]
        mus = mus * s_n / jnp.maximum(s_t, _MINVAL)

    Js = J * inv_s[:, None]
    minv_jts = minv_jt * inv_s[None, :]
    regs = reg * inv_s * inv_s
    bs = b * inv_s

    def apply_A(g):
        return Js @ (minv_jts @ g) + regs * g

    # Lipschitz constant (APGD step = 1/L). Estimators, all valid upper
    # bounds of lambda_max(A_s) except "power":
    # - "cw" (default): Collatz-Wielandt. With B := |Js| |Ks| + diag(regs)
    #   (entrywise abs), |A_s| <= B entrywise, so lambda_max(A_s) <= rho(B)
    #   <= max_i (B v)_i / v_i for ANY positive v. Three power iterations on
    #   B sharpen v, then the CW max gives a GUARANTEED bound measured at
    #   1.5-2.6x lambda_max on the contact scenes — versus 31-74x for the
    #   Hoelder bound, i.e. ~20x more effective APGD step per iteration.
    # - "holder": sqrt(||J||_1 ||J||_inf) * sqrt(||K||_1 ||K||_inf) — valid
    #   but loose (kept for A/B).
    # - "power": from-below norm-ratio estimate x1.25 — NOT a valid bound;
    #   diverges on stiff scenes (measured); kept only for experiments.
    if lipschitz == "cw":
        aJ = jnp.abs(Js)
        aK = jnp.abs(minv_jts)

        def apply_B(v):
            return aJ @ (aK @ v) + regs * v

        v = jnp.ones(nefc, dtype)
        for _ in range(3):
            bv = apply_B(v)
            v = bv / jnp.sqrt(jnp.maximum(jnp.dot(bv, bv), _MINVAL))
        bv = apply_B(v)
        L = jnp.max(bv / jnp.maximum(v, 1e-12))
    elif lipschitz == "power":
        v = jnp.maximum(jnp.abs(bs), 1e-3)
        lam = jnp.asarray(1.0, dtype)
        for _ in range(4):
            av = apply_A(v)
            n_av = jnp.sqrt(jnp.maximum(jnp.dot(av, av), _MINVAL))
            n_v = jnp.sqrt(jnp.maximum(jnp.dot(v, v), _MINVAL))
            lam = n_av / n_v
            v = av / n_av
        L = 1.25 * lam + jnp.max(regs)
    else:

        def op_bound(mat):
            l1 = jnp.max(jnp.sum(jnp.abs(mat), axis=0))
            linf = jnp.max(jnp.sum(jnp.abs(mat), axis=1))
            return jnp.sqrt(jnp.maximum(l1 * linf, _MINVAL))

        L = op_bound(Js) * op_bound(minv_jts) + jnp.max(regs)
    L = jnp.maximum(L, _MINVAL)
    step = 1.0 / L

    def body(carry, _):
        f, y, t = carry
        grad = apply_A(y) + bs
        f_new = project_dual(y - step * grad, ncon_start, mus)
        t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        y_new = f_new + ((t - 1.0) / t_new) * (f_new - f)
        restart = jnp.dot(grad, f_new - f) > 0
        y_new = jnp.where(restart, f_new, y_new)
        t_new = jnp.where(restart, jnp.asarray(1.0, dtype), t_new)
        return (f_new, y_new, t_new), None

    g0 = (
        jnp.zeros(nefc, dtype)
        if f_warm is None
        else project_dual(f_warm / jnp.maximum(inv_s, _MINVAL), ncon_start, mus)
    )
    (g, _, _), _ = jax.lax.scan(body, (g0, g0, jnp.asarray(1.0, dtype)), None, length=iterations)
    return g * inv_s


def solve_contacts(
    m: PhysicsModel,
    com: ComQuants,
    kin: Kinematics,
    contacts: Contacts,
    mm: jnp.ndarray,
    minv: jnp.ndarray,
    qpos: jnp.ndarray,
    qvel: jnp.ndarray,
    qacc_smooth: jnp.ndarray,
    f_warm: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Full constrained acceleration given smooth dynamics + contacts.

    ``minv`` is the explicit inverse mass matrix (see linalg.cho_inverse).
    ``f_warm`` warm-starts the dual iteration from the previous physics step's
    constraint forces (carried through the rollout scan) — the batched
    stand-in for MuJoCo's per-MjData warm-start (efc_force persistence), which
    lets the fixed APGD iteration count stay small.

    Returns (qacc, efc_force).
    """
    rows = assemble_constraints(m, com, contacts, qpos, qvel)
    nefc = rows.J.shape[0]
    if nefc == 0:
        return qacc_smooth, jnp.zeros(0, qacc_smooth.dtype)

    J = rows.J * rows.active[:, None]
    aref = rows.aref * rows.active
    reg = jnp.where(rows.active > 0, rows.reg, 1.0)
    diag = jnp.where(rows.active > 0, rows.diag, 1.0)

    minv_jt = minv @ J.T  # (nv, nefc) one batched matmul instead of nefc substitutions
    b = J @ qacc_smooth - aref
    mus = None if m.cone_pyramidal else contacts.friction
    f = solve_dual_qp_matfree(
        J, minv_jt, reg, b, iterations=max(m.solver_iterations, 8), f_warm=f_warm,
        ncon_start=num_noncontact_rows(m), mus=mus, diag=diag,
    )
    return qacc_smooth + minv_jt @ f, f
