"""Box-box and capsule-box narrowphase in pure JAX (static shapes).

Box-box uses separating-axis minimization over the 15 candidate axes (6 face
normals + 9 edge-edge cross products) and, for face-dominant contacts, a fixed
Sutherland-Hodgman-style clamp of the incident face against the reference
face's rectangle — producing a 4-point manifold. Edge-edge contacts collapse
to a single point (slot 0).

Everything is branch-free AND gather-free: dynamic selections (best SAT axis,
face axis indices, deepest-k points) are expressed as one-hot vectors built
from comparisons (``iota == argmax`` / rank-counting), applied with small
matmuls — the one-hot form fuses into the surrounding elementwise graph
where a dynamic-index gather inside the rollout scan would not. This is the workhorse of the leap_cube / fr3 /
spot contact scenes, replacing MuJoCo's dynamic-count mjc_BoxBox.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class PairContacts(NamedTuple):
    dist: jnp.ndarray  # (k,)
    pos: jnp.ndarray  # (k, 3)
    normal: jnp.ndarray  # (k, 3) from geom1 toward geom2


def _onehot_eq(n: int, idx: jnp.ndarray, dtype) -> jnp.ndarray:
    """One-hot (n,) vector (iota == idx) without any gather."""
    iota = jnp.arange(n)
    return (iota == idx).astype(dtype)


def _rank_select(keys: jnp.ndarray, k: int) -> jnp.ndarray:
    """Constant-shape selection matrix S (k, n): S @ x picks the k smallest
    entries of ``keys`` in ascending order (stable; index tiebreak), built
    from a comparison matrix instead of argsort+gather."""
    n = keys.shape[0]
    lt = keys[:, None] > keys[None, :]  # [i, j]: key_j < key_i
    eq = keys[:, None] == keys[None, :]
    idx_lt = jnp.tril(jnp.ones((n, n), bool), -1)  # [i, j]: j < i
    rank = (lt | (eq & idx_lt)).sum(axis=1)  # (n,) rank of each entry
    slots = jnp.arange(k)
    return (rank[None, :] == slots[:, None]).astype(keys.dtype)  # (k, n)


def box_box(pos1, mat1, size1, pos2, mat2, size2) -> PairContacts:
    """4-slot contact manifold between two oriented boxes (world frame)."""
    dtype = pos1.dtype
    d = pos2 - pos1

    # --- candidate axes (world frame) ---
    axes = [mat1[:, i] for i in range(3)] + [mat2[:, j] for j in range(3)]
    edge_axes = []
    for i in range(3):
        for j in range(3):
            edge_axes.append(jnp.cross(mat1[:, i], mat2[:, j]))
    axes = axes + edge_axes  # 15
    axes = jnp.stack(axes)  # (15, 3)
    norms = jnp.linalg.norm(axes, axis=1)
    valid = norms > 1e-6
    axes_n = axes / jnp.maximum(norms, 1e-12)[:, None]

    proj1 = jnp.sum(size1 * jnp.abs(axes_n @ mat1), axis=1)  # (15,)
    proj2 = jnp.sum(size2 * jnp.abs(axes_n @ mat2), axis=1)
    sep = jnp.abs(axes_n @ d) - proj1 - proj2  # (15,) negative = overlapping
    # Edge axes get a tiny penalty so face axes win ties (standard SAT
    # practice). The selection is argmax (LEAST penetration wins), so the
    # penalty must be SUBTRACTED from the edge axes' score — with a bonus
    # instead, an edge-edge cross product parallel to a face normal (exactly
    # the axis-aligned resting-contact case) would beat the face axis and
    # collapse the 4-point manifold to a single edge point.
    bias = jnp.concatenate([jnp.zeros(6, dtype), jnp.full((9,), 1e-6, dtype)])
    score = jnp.where(valid, sep - bias, -jnp.inf)
    best = jnp.argmax(score)  # axis with LEAST penetration (max of negatives)
    dist = jnp.max(jnp.where(valid, sep, -jnp.inf))  # true max separation
    oh_best = _onehot_eq(15, best, dtype)  # (15,)
    axis = oh_best @ axes_n  # selected axis, gather-free
    # orient the normal from box1 toward box2
    sign = jnp.where(jnp.dot(axis, d) >= 0, 1.0, -1.0)
    normal = sign * axis

    is_face = best < 6
    ref_is_1 = best < 3

    # --- face-face manifold ---
    # reference box (owns the reference face) and incident box
    ref_mat = jnp.where(ref_is_1, mat1, mat2)
    ref_size = jnp.where(ref_is_1, size1, size2)
    ref_pos = jnp.where(ref_is_1, pos1, pos2)
    inc_mat = jnp.where(ref_is_1, mat2, mat1)
    inc_size = jnp.where(ref_is_1, size2, size1)
    inc_pos = jnp.where(ref_is_1, pos2, pos1)
    # outward normal of the reference face (toward the incident box)
    ref_n = jnp.where(ref_is_1, normal, -normal)

    # local axis index of the reference face -> one-hot basis vectors
    ref_align_v = ref_mat.T @ ref_n  # (3,) signed alignment
    ref_align = jnp.abs(ref_align_v)
    ref_ax = jnp.argmax(ref_align)
    e_ref = _onehot_eq(3, ref_ax, dtype)  # == eye[ref_ax]
    ref_sign = jnp.sign(jnp.sum(ref_align_v * e_ref) + 1e-12)

    # incident face: the face of the incident box most anti-parallel to ref_n
    inc_align = inc_mat.T @ ref_n  # (3,)
    inc_ax = jnp.argmax(jnp.abs(inc_align))
    e_ax = _onehot_eq(3, inc_ax, dtype)
    inc_sign = -jnp.sign(jnp.sum(inc_align * e_ax) + 1e-12)  # against ref_n
    e_u = _onehot_eq(3, (inc_ax + 1) % 3, dtype)
    e_v = _onehot_eq(3, (inc_ax + 2) % 3, dtype)

    # incident face vertices (4) in world
    c_local = inc_sign * inc_size * e_ax
    u_local = inc_size * e_u
    v_local = inc_size * e_v
    signs = jnp.asarray([[1, 1], [1, -1], [-1, 1], [-1, -1]], dtype)
    verts_local = c_local + signs[:, 0:1] * u_local + signs[:, 1:2] * v_local  # (4,3)
    verts = inc_pos + verts_local @ inc_mat.T  # (4, 3) world

    # clip against the 4 side planes of the reference face (in ref local frame)
    vl = (verts - ref_pos) @ ref_mat  # (4, 3) in ref frame
    r_u = _onehot_eq(3, (ref_ax + 1) % 3, dtype)
    r_v = _onehot_eq(3, (ref_ax + 2) % 3, dtype)
    hu = jnp.sum(ref_size * r_u)
    hv = jnp.sum(ref_size * r_v)
    u = vl @ r_u  # (4,)
    v = vl @ r_v

    # Instead of true polygon clipping (dynamic vertex count), take the 4
    # incident vertices clamped into the reference face rectangle, plus depth
    # measured at the clamped point via the plane of the incident face.
    u_c = jnp.clip(u, -hu, hu)
    v_c = jnp.clip(v, -hv, hv)
    # reconstruct world points on the incident face at the clamped (u, v):
    # solve for the incident-face plane height along ref face normal
    w = vl @ e_ref  # heights of incident verts in ref frame (4,)
    # The 4 verts lie exactly on the incident-face plane, so w is affine in
    # (u, v): w = w0 + gu*(u-u0) + gv*(v-v0). The plane normal (in ref-local
    # coords) comes from a single cross product of two in-plane edge vectors
    # (closed form; an lstsq here lowers to an SVD while-loop).
    n_pl = jnp.cross(vl[1] - vl[0], vl[2] - vl[0])
    n_u = jnp.dot(n_pl, r_u)
    n_v = jnp.dot(n_pl, r_v)
    n_w = jnp.dot(n_pl, e_ref)
    # |n_w| >= |n_pl|/sqrt(3) by construction (incident face is the most
    # anti-parallel one); the guard only protects degenerate zero-size boxes.
    n_w = jnp.sign(n_w + 1e-30) * jnp.maximum(jnp.abs(n_w), 1e-12)
    w_c = w[0] - (n_u * (u_c - u[0]) + n_v * (v_c - v[0])) / n_w
    h_ref = jnp.sum(ref_size * e_ref) * ref_sign
    depth = ref_sign * w_c - jnp.sum(ref_size * e_ref)  # negative = below face

    # midpoint between face surface and incident point along ref axis
    mid_w = 0.5 * (w_c + h_ref)
    pts_ref_frame = u_c[:, None] * r_u[None, :] + v_c[:, None] * r_v[None, :] + mid_w[:, None] * e_ref[None, :]
    pts_world = ref_pos + pts_ref_frame @ ref_mat.T  # (4, 3)
    face_dists = depth  # (4,)

    # --- edge-edge single contact ---
    e1_ax = (best - 6) // 3
    e2_ax = (best - 6) % 3
    oh1 = _onehot_eq(3, jnp.clip(e1_ax, 0, 2), dtype)
    oh2 = _onehot_eq(3, jnp.clip(e2_ax, 0, 2), dtype)
    a1 = mat1 @ oh1  # column selection, gather-free
    a2 = mat2 @ oh2

    # supporting edge midpoints: move to the corner along the other two axes
    def edge_center(pos, mat, size, oh_edge, toward):
        # per-axis signs toward the other box, zeroed on the edge axis
        s = jnp.sign(mat.T @ toward + 1e-12)  # (3,)
        contrib = (1.0 - oh_edge) * s * size  # (3,)
        return pos + mat @ contrib

    c1 = edge_center(pos1, mat1, size1, oh1, normal)
    c2 = edge_center(pos2, mat2, size2, oh2, -normal)
    # closest points between the two infinite edge lines
    d12 = c2 - c1
    denom = jnp.maximum(1.0 - jnp.dot(a1, a2) ** 2, 1e-9)
    t1 = (jnp.dot(d12, a1) - jnp.dot(d12, a2) * jnp.dot(a1, a2)) / denom
    t2 = -(jnp.dot(d12, a2) - jnp.dot(d12, a1) * jnp.dot(a1, a2)) / denom
    p1 = c1 + t1 * a1
    p2 = c2 + t2 * a2
    edge_pt = 0.5 * (p1 + p2)

    # --- combine: 4 slots ---
    big = jnp.asarray(1e10, dtype)
    sep_positive = dist >= 0  # separated: keep slots inactive but report dist
    face_pts = pts_world
    face_d = jnp.where(face_dists < 0, face_dists, jnp.maximum(face_dists, dist))
    edge_pts = jnp.tile(edge_pt[None], (4, 1))
    slot0 = jnp.asarray(np.asarray([1.0, 0, 0, 0]), dtype)
    edge_d = dist * slot0 + big * (1.0 - slot0)

    pts = jnp.where(is_face, face_pts, edge_pts)
    dists = jnp.where(is_face, face_d, edge_d)
    # when fully separated, emit the true distance on slot 0 only
    dists = jnp.where(sep_positive, dist * slot0 + big * (1.0 - slot0), dists)
    normals = jnp.tile(normal[None], (4, 1))
    return PairContacts(dist=dists, pos=pts, normal=normals)


def capsule_box(pos_c, mat_c, size_c, pos_b, mat_b, size_b) -> PairContacts:
    """2-slot capsule-vs-box contact via sphere checks at the deepest segment
    points (endpoints + the segment point closest to the box center)."""
    dtype = pos_c.dtype
    r, hl = size_c[0], size_c[1]
    axis = mat_c[:, 2]
    ends = jnp.stack([pos_c - hl * axis, pos_c + hl * axis])  # (2, 3)

    # segment point closest to box center (good proxy for deepest interior pt)
    t = jnp.clip(jnp.dot(pos_b - pos_c, axis), -hl, hl)
    mid = pos_c + t * axis
    cands = jnp.concatenate([ends, mid[None]])  # (3, 3)

    local = (cands - pos_b) @ mat_b  # (3, 3) in box frame
    clamped = jnp.clip(local, -size_b, size_b)
    delta = local - clamped
    dn = jnp.linalg.norm(delta, axis=1)
    outside = dn > 1e-9
    # inside: push out along the smallest gap axis (one-hot from argmin)
    gaps = size_b - jnp.abs(local)  # (3, 3)
    ax = jnp.argmin(gaps, axis=1)  # (3,)
    ohax = (jnp.arange(3)[None, :] == ax[:, None]).astype(dtype)  # (3, 3)
    n_in_local = jnp.sign(jnp.sum(local * ohax, axis=1, keepdims=True)) * ohax
    d_in = -jnp.sum(gaps * ohax, axis=1)
    n_out_local = delta / jnp.maximum(dn, 1e-12)[:, None]
    n_local = jnp.where(outside[:, None], n_out_local, n_in_local)
    dists = jnp.where(outside, dn, d_in) - r
    # normal points from capsule toward box: -n_local in world
    normals = -(n_local @ mat_b.T)
    surf_local = jnp.where(outside[:, None], clamped, local - d_in[:, None] * n_in_local)
    surf = pos_b + surf_local @ mat_b.T
    pts = surf + 0.5 * dists[:, None] * normals

    # keep the deepest 2 of the 3 candidates (rank selection, no argsort)
    sel = _rank_select(dists, 2)  # (2, 3)
    return PairContacts(dist=sel @ dists, pos=sel @ pts, normal=sel @ normals)
