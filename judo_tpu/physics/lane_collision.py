"""Static-shape collision narrowphase, batch-in-lanes layout, PAIR-STACKED.

The lanes counterpart of collision.py / box_collision.py: identical contact
semantics (same candidate pair list, same per-pair slot counts, same mixed
contact parameters), with every geometric quantity shaped (P, ..., B): all
same-type candidate pairs are processed by ONE kernel invocation on stacked
tensors instead of a Python loop of per-pair (3, B) ops.

Why stacked: the per-pair loop serializes ~80 small ops x 15 box-box pairs
into a >1000-op dependency chain; stacking pairs into the leading axis makes
each op (P, 3, B) — P x fewer operations, and the per-pair chains run in
parallel.

Dynamic selections (SAT best axis, deepest-k points) are expressed as
first-true / rank one-hot algebra over comparison masks — no argsort, no
gathers, no data-dependent shapes — exactly as box_collision.py does, but
with the one-hot reductions running across lanes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from judo_tpu.physics.lane_engine import l_cross, l_dot3, p_mat_t_vec, p_mat_vec, usum
from judo_tpu.physics.model import (
    GEOM_BOX,
    GEOM_CAPSULE,
    GEOM_CYLINDER,
    GEOM_PLANE,
    GEOM_SPHERE,
    PhysicsModel,
)

_BIG = 1e10


class LaneContacts(NamedTuple):
    """ALL contact slots stacked: arrays lead with the slot axis C; static
    metadata as host-side tuples/np arrays (trace-time constants)."""

    dist: jnp.ndarray  # (C, B)
    pos: jnp.ndarray  # (C, 3, B)
    normal: jnp.ndarray  # (C, 3, B)
    body1: tuple  # (C,) ints
    body2: tuple  # (C,) ints
    # static mixed parameters (mj_contactParam), host arrays
    friction: np.ndarray  # (C,)
    solref: np.ndarray  # (C, 2)
    solimp: np.ndarray  # (C, 5)
    includemargin: np.ndarray  # (C,)

    @property
    def ncon(self) -> int:
        return len(self.body1)


def _col(m3: jnp.ndarray, i: int) -> jnp.ndarray:
    """Column i of a (..., 3, 3, B) matrix -> (..., 3, B)."""
    return m3[..., :, i, :]


def _safe_unit(v: jnp.ndarray, fallback: jnp.ndarray, eps: float = 1e-9) -> jnp.ndarray:
    n = jnp.sqrt(jnp.maximum(l_dot3(v, v), 1e-24))
    unit = v / n[..., None, :]
    return jnp.where((n > eps)[..., None, :], unit, fallback)


def first_true_onehot(masks: list) -> list:
    """One-hot over a static list of bool masks: first True wins."""
    taken = jnp.zeros_like(masks[0], dtype=bool)
    out = []
    for mk in masks:
        sel = mk & (~taken)
        out.append(sel)
        taken = taken | mk
    return out


def _closest_seg_point(a: jnp.ndarray, b: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    ab = b - a
    t = jnp.clip(l_dot3(p - a, ab) / jnp.maximum(l_dot3(ab, ab), 1e-12), 0.0, 1.0)
    return a + t[..., None, :] * ab


def _segment_segment(p1, q1, p2, q2):
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = l_dot3(d1, d1)
    e = l_dot3(d2, d2)
    f = l_dot3(d2, r)
    c = l_dot3(d1, r)
    b = l_dot3(d1, d2)
    denom = a * e - b * b
    s = jnp.where(denom > 1e-12, jnp.clip((b * f - c * e) / jnp.maximum(denom, 1e-12), 0.0, 1.0), 0.0)
    t = (b * s + f) / jnp.maximum(e, 1e-12)
    t_cl = jnp.clip(t, 0.0, 1.0)
    s = jnp.clip((b * t_cl - c) / jnp.maximum(a, 1e-12), 0.0, 1.0)
    return p1 + s[..., None, :] * d1, p2 + t_cl[..., None, :] * d2


def _e3(v, like: jnp.ndarray) -> jnp.ndarray:
    """Constant direction broadcast to the shape of ``like`` ((..., 3, B)).

    jnp.full-based (const_col)."""
    from judo_tpu.physics.lane_engine import const_col

    return jnp.broadcast_to(const_col(v, like.dtype), like.shape)


# --- per-type lane kernels, pair-stacked ---
#
# Signature: (x1 (P,3,B), m1 (P,3,3,B), s1 (P,3) jnp const, x2, m2, s2)
#   -> list of slots [(d (P,B), pos (P,3,B), n (P,3,B)), ...]
# Per-pair sizes enter as (P, 1) / (P, 1, 1) constant columns.


def _s(sz: tuple, k: int) -> jnp.ndarray:
    """Size component as (P, 1) for math against (P, B). ``sz`` is a 3-tuple
    of (P, 1) const columns (jnp.full splats — see _e3 note)."""
    return sz[k]


def _sv(sz: tuple, k: int) -> jnp.ndarray:
    """Size component as (P, 1, 1) for math against (P, 3, B)."""
    return sz[k][..., None]


def _sz3(sz: tuple) -> jnp.ndarray:
    """Full (P, 3, 1) size tensor from the 3-tuple of (P, 1) columns."""
    return jnp.concatenate([c[..., None] for c in sz], axis=1)


def _k_plane_sphere(x1, m1, s1, x2, m2, s2):
    n = _col(m1, 2)
    d = l_dot3(x2 - x1, n) - _s(s2, 0)
    pos = x2 - n * (_s(s2, 0) + 0.5 * d)[..., None, :]
    return [(d, pos, n)]


def _k_plane_capsule(x1, m1, s1, x2, m2, s2):
    n = _col(m1, 2)
    axis = _col(m2, 2)
    out = []
    for sgn in (-1.0, 1.0):
        c = x2 + sgn * _sv(s2, 1) * axis
        d = l_dot3(c - x1, n) - _s(s2, 0)
        out.append((d, c - n * (_s(s2, 0) + 0.5 * d)[..., None, :], n))
    return out


def _k_plane_cylinder(x1, m1, s1, x2, m2, s2):
    n = _col(m1, 2)
    axis = _col(m2, 2)
    proj = axis * l_dot3(axis, n)[..., None, :] - n
    rim = _safe_unit(proj, _col(m2, 0), eps=1e-8)
    out = []
    for sgn in (-1.0, 1.0):
        c = x2 + sgn * _sv(s2, 1) * axis + _sv(s2, 0) * rim
        d = l_dot3(c - x1, n)
        out.append((d, c - 0.5 * d[..., None, :] * n, n))
    return out


def _k_plane_box(x1, m1, s1, x2, m2, s2):
    n = _col(m1, 2)
    dtype = x1.dtype
    # the 8 corners stacked on a leading axis; the corner index k encodes the
    # sign pattern (bit2, bit1, bit0) = (sx, sy, sz), matching the original
    # (-1, 1)-nested loop order
    io = jax.lax.broadcasted_iota(jnp.int32, (8, 1, 1, 1), 0)
    sgn = [
        ((io // 4) % 2 * 2 - 1).astype(dtype),
        ((io // 2) % 2 * 2 - 1).astype(dtype),
        (io % 2 * 2 - 1).astype(dtype),
    ]
    corners_s = x2[None] + sum(
        sgn[i] * _sv(s2, i)[None] * _col(m2, i)[None] for i in range(3)
    )  # (8, P, 3, B)
    cd_s = l_dot3(corners_s - x1[None], n[None])  # (8, P, B)
    ranks = _rank_stacked(cd_s)
    out = []
    for s in range(4):
        w = (ranks == s).astype(dtype)  # (8, P, B)
        d = usum(w * cd_s, 0)
        p = usum(w[..., None, :] * corners_s, 0)
        out.append((d, p - 0.5 * d[..., None, :] * n, n))
    return out


def _k_sphere_sphere(x1, m1, s1, x2, m2, s2):
    delta = x2 - x1
    dn = jnp.sqrt(jnp.maximum(l_dot3(delta, delta), 1e-24))
    n = _safe_unit(delta, _e3([0, 0, 1], delta))
    d = dn - _s(s1, 0) - _s(s2, 0)
    return [(d, x1 + n * (_s(s1, 0) + 0.5 * d)[..., None, :], n)]


def _k_sphere_capsule(x1, m1, s1, x2, m2, s2):
    axis = _col(m2, 2)
    c = _closest_seg_point(x2 - _sv(s2, 1) * axis, x2 + _sv(s2, 1) * axis, x1)
    delta = c - x1
    dn = jnp.sqrt(jnp.maximum(l_dot3(delta, delta), 1e-24))
    n = _safe_unit(delta, _e3([0, 0, 1], delta))
    d = dn - _s(s1, 0) - _s(s2, 0)
    return [(d, x1 + n * (_s(s1, 0) + 0.5 * d)[..., None, :], n)]


def _k_sphere_box(x1, m1, s1, x2, m2, s2):
    dtype = x1.dtype
    local = p_mat_t_vec(m2, x1 - x2)  # (P, 3, B)
    size = _sz3(s2)  # (P, 3, 1)
    clamped = jnp.clip(local, -size, size)
    inside = jnp.all(jnp.abs(local) < size, axis=-2)  # (P, B)
    delta_out = local - clamped
    dn_out = jnp.sqrt(jnp.maximum(l_dot3(delta_out, delta_out), 1e-24))
    n_out = delta_out / jnp.maximum(dn_out, 1e-12)[..., None, :]
    gaps = size - jnp.abs(local)  # (P, 3, B)
    gmin = jnp.min(gaps, axis=-2)
    sel = first_true_onehot([gaps[..., i, :] == gmin for i in range(3)])
    ohax = jnp.stack([s.astype(dtype) for s in sel], axis=-2)  # (P, 3, B)
    n_in = jnp.sign(usum(local * ohax, -2))[..., None, :] * ohax
    dn_in = -gmin
    n_local = jnp.where(inside[..., None, :], n_in, n_out)
    dn_loc = jnp.where(inside, dn_in, dn_out)
    n = p_mat_vec(m2, -n_local)
    d = dn_loc - _s(s1, 0)
    surf_local = jnp.where(inside[..., None, :], local - dn_in[..., None, :] * n_in, clamped)
    surf = x2 + p_mat_vec(m2, surf_local)
    return [(d, surf + 0.5 * d[..., None, :] * n, n)]


def _k_capsule_capsule(x1, m1, s1, x2, m2, s2):
    a1, a2 = _col(m1, 2), _col(m2, 2)
    p1c, p2c = _segment_segment(
        x1 - _sv(s1, 1) * a1, x1 + _sv(s1, 1) * a1, x2 - _sv(s2, 1) * a2, x2 + _sv(s2, 1) * a2
    )
    delta = p2c - p1c
    dn = jnp.sqrt(jnp.maximum(l_dot3(delta, delta), 1e-24))
    n = _safe_unit(delta, _e3([0, 0, 1], delta))
    d = dn - _s(s1, 0) - _s(s2, 0)
    return [(d, p1c + n * (_s(s1, 0) + 0.5 * d)[..., None, :], n)]


def _k_cylinder_cylinder(x1, m1, s1, x2, m2, s2):
    dtype = x1.dtype
    a1 = _col(m1, 2)
    delta = x2 - x1
    h = l_dot3(delta, a1)
    radial = delta - a1 * h[..., None, :]
    rn = jnp.sqrt(jnp.maximum(l_dot3(radial, radial), 1e-24))
    n = _safe_unit(radial, _col(m1, 0))
    parallel = jnp.abs(l_dot3(a1, _col(m2, 2))) > 0.99
    overlap = jnp.abs(h) < (_s(s1, 1) + _s(s2, 1))
    d_radial = rn - _s(s1, 0) - _s(s2, 0)
    d = jnp.where(parallel & overlap, d_radial, jnp.asarray(_BIG, dtype))
    h_lo = jnp.maximum(jnp.broadcast_to(-_s(s1, 1), h.shape), h - _s(s2, 1))
    h_hi = jnp.minimum(jnp.broadcast_to(_s(s1, 1), h.shape), h + _s(s2, 1))
    radial_pos = x1 + n * (_s(s1, 0) + 0.5 * d_radial)[..., None, :]
    return [
        (d, radial_pos + a1 * h_hi[..., None, :], n),
        (d, radial_pos + a1 * h_lo[..., None, :], n),
    ]


def _cyl_correction(d, n, axis, r):
    na = jnp.clip(jnp.abs(l_dot3(n, axis)), 0.0, 1.0)
    return d + r * (1.0 - jnp.sqrt(jnp.maximum(1.0 - na * na, 0.0)))


def _k_sphere_cylinder(x1, m1, s1, x2, m2, s2):
    [(d, p, n)] = _k_sphere_capsule(x1, m1, s1, x2, m2, s2)
    return [(_cyl_correction(d, n, _col(m2, 2), _s(s2, 0)), p, n)]


def _k_capsule_cylinder(x1, m1, s1, x2, m2, s2):
    [(d, p, n)] = _k_capsule_capsule(x1, m1, s1, x2, m2, s2)
    return [(_cyl_correction(d, n, _col(m2, 2), _s(s2, 0)), p, n)]


def _k_cylinder_box(x1, m1, s1, x2, m2, s2):
    out = _k_capsule_box(x1, m1, s1, x2, m2, s2)
    axis = _col(m1, 2)
    return [(_cyl_correction(d, n, axis, _s(s1, 0)), p, n) for (d, p, n) in out]


def _rank_stacked(keys_s: jnp.ndarray) -> jnp.ndarray:
    """Stable ranks over the leading axis: keys_s (n, ..., B) -> (n, ..., B)
    where rank[i] = #{j : keys[j] < keys[i], index tiebreak}. The pairwise
    comparison tensor replaces the O(n^2) loop of narrow ops."""
    n = keys_s.shape[0]
    dtype = keys_s.dtype
    a = keys_s[:, None]  # (n, 1, ..., B) -> index i
    b = keys_s[None, :]  # (1, n, ..., B) -> index j
    io_i = jax.lax.broadcasted_iota(jnp.int32, (n, n) + (1,) * (keys_s.ndim - 1), 0)
    io_j = jax.lax.broadcasted_iota(jnp.int32, (n, n) + (1,) * (keys_s.ndim - 1), 1)
    beats = (b < a) | ((b == a) & (io_j < io_i))  # j beats i
    return usum(beats.astype(dtype), 1)  # (n, ..., B)


def _rank_select_l(keys: list, k: int) -> list:
    """Rank one-hot selection over a static list of keys: result[s][j]
    is 1.0 where keys[j] is the s-th smallest (stable, index tiebreak)."""
    n = len(keys)
    dtype = keys[0].dtype
    ranks_s = _rank_stacked(jnp.stack(keys))
    return [[(ranks_s[j] == s).astype(dtype) for j in range(n)] for s in range(k)]


def _k_capsule_box(x1, m1, s1, x2, m2, s2):
    """2-slot capsule-box (port of box_collision.capsule_box), pair-stacked."""
    dtype = x1.dtype
    r, hl = _s(s1, 0), _sv(s1, 1)
    axis = _col(m1, 2)
    size = _sz3(s2)  # (P, 3, 1)
    t = jnp.clip(l_dot3(x2 - x1, axis), -hl[..., 0], hl[..., 0])
    # the 3 candidate points stacked on a leading axis (see _k_box_box note)
    cands_s = jnp.stack(
        [x1 - hl * axis, x1 + hl * axis, x1 + t[..., None, :] * axis]
    )  # (3, P, 3, B)

    local = p_mat_t_vec(m2[None], cands_s - x2[None])  # (3, P, 3, B)
    clamped = jnp.clip(local, -size, size)
    delta = local - clamped
    dn = jnp.sqrt(jnp.maximum(l_dot3(delta, delta), 1e-24))
    outside = dn > 1e-9
    gaps = size - jnp.abs(local)
    gmin = jnp.min(gaps, axis=-2)
    sel = first_true_onehot([gaps[..., i, :] == gmin for i in range(3)])
    ohax = jnp.stack([s_.astype(dtype) for s_ in sel], axis=-2)
    n_in = jnp.sign(usum(local * ohax, -2))[..., None, :] * ohax
    d_in = -gmin
    n_out = delta / jnp.maximum(dn, 1e-12)[..., None, :]
    n_local = jnp.where(outside[..., None, :], n_out, n_in)
    dists_s = jnp.where(outside, dn, d_in) - r  # (3, P, B)
    normals_s = -p_mat_vec(m2[None], n_local)
    surf_local = jnp.where(outside[..., None, :], clamped, local - d_in[..., None, :] * n_in)
    surf = x2[None] + p_mat_vec(m2[None], surf_local)
    pts_s = surf + 0.5 * dists_s[..., None, :] * normals_s

    ranks = _rank_stacked(dists_s)
    out = []
    for s in range(2):
        w = (ranks == s).astype(dtype)  # (3, P, B)
        d = usum(w * dists_s, 0)
        p = usum(w[..., None, :] * pts_s, 0)
        n = usum(w[..., None, :] * normals_s, 0)
        out.append((d, p, n))
    return out


def _k_box_box(x1, m1, s1, x2, m2, s2):
    """4-slot box-box SAT manifold (port of box_collision.box_box), stacked
    AND component-sliced: every 3-vector lives as a tuple of (P, B)
    component planes, so no (P, 3, B) tensor (whose 3-axis would land in the
    sublane dimension at 3/8 utilization) is ever materialized. The SAT runs
    in the boxes' local frames (Gottschalk's 15 closed-form tests); the
    incident-face clip runs in the reference face frame."""
    dtype = x1.dtype
    size1 = [_s(s1, i) for i in range(3)]  # (P, 1) each
    size2 = [_s(s2, i) for i in range(3)]

    # component tuples: vectors are 3-tuples of (P, B)
    x1t = tuple(x1[:, k, :] for k in range(3))
    x2t = tuple(x2[:, k, :] for k in range(3))
    dt = tuple(x2t[k] - x1t[k] for k in range(3))
    c1t = [tuple(m1[:, k, i, :] for k in range(3)) for i in range(3)]
    c2t = [tuple(m2[:, k, j, :] for k in range(3)) for j in range(3)]

    def dot(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    def cross(a, b):
        return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])

    def add(a, b):
        return (a[0] + b[0], a[1] + b[1], a[2] + b[2])

    def sub(a, b):
        return (a[0] - b[0], a[1] - b[1], a[2] - b[2])

    def scale(w, a):  # w (P, B) or (P, 1)
        return (w * a[0], w * a[1], w * a[2])

    def blend(w, a, b):  # w in [0, 1]
        return tuple(w * a[k] + (1.0 - w) * b[k] for k in range(3))

    def vwhere(c, a, b):  # c bool (P, B)
        return tuple(jnp.where(c, a[k], b[k]) for k in range(3))

    def pack(a):  # tuple -> (P, 3, B)
        return jnp.stack(a, axis=1)

    # --- local-frame SAT (Gottschalk): all 15 tests in 12 scalars ---
    Rm = [[dot(c1t[i], c2t[j]) for j in range(3)] for i in range(3)]  # (P, B)
    Am = [[jnp.abs(Rm[i][j]) for j in range(3)] for i in range(3)]
    t1 = [dot(dt, c1t[i]) for i in range(3)]  # d in box1 coords
    t2 = [dot(dt, c2t[j]) for j in range(3)]  # d in box2 coords

    seps = [None] * 15
    inv_nrms = [None] * 15
    valids = [None] * 15
    one = jnp.ones_like(t1[0])
    for i in range(3):  # box1 face axes
        seps[i] = jnp.abs(t1[i]) - (size1[i] + size2[0] * Am[i][0] + size2[1] * Am[i][1] + size2[2] * Am[i][2])
        inv_nrms[i] = one
        valids[i] = jnp.ones_like(t1[i], dtype=bool)
    for j in range(3):  # box2 face axes
        seps[3 + j] = jnp.abs(t2[j]) - (size2[j] + size1[0] * Am[0][j] + size1[1] * Am[1][j] + size1[2] * Am[2][j])
        inv_nrms[3 + j] = one
        valids[3 + j] = jnp.ones_like(t2[j], dtype=bool)
    for i in range(3):  # cross axes c1_i x c2_j
        i1, i2 = (i + 1) % 3, (i + 2) % 3
        for j in range(3):
            j1, j2 = (j + 1) % 3, (j + 2) % 3
            k = 6 + 3 * i + j
            ad = jnp.abs(t1[i2] * Rm[i1][j] - t1[i1] * Rm[i2][j])
            p1k = size1[i1] * Am[i2][j] + size1[i2] * Am[i1][j]
            p2k = size2[j1] * Am[i][j2] + size2[j2] * Am[i][j1]
            len2 = 1.0 - Rm[i][j] * Rm[i][j]  # |c1_i x c2_j|^2
            inv_nrms[k] = jax.lax.rsqrt(jnp.maximum(len2, 1e-24))
            seps[k] = (ad - p1k - p2k) * inv_nrms[k]
            valids[k] = len2 > 1e-12
    seps_s = jnp.stack(seps)  # (15, P, B)
    valids_s = jnp.stack(valids)

    neg_inf = jnp.asarray(-_BIG, dtype)
    # cross axes (index >= 6) get the +1e-6 face-preference bias
    io15 = jax.lax.broadcasted_iota(jnp.int32, (15, 1, 1), 0)
    bias = (io15 >= 6).astype(dtype) * 1e-6
    scores_s = jnp.where(valids_s, seps_s + bias, neg_inf)

    def _tree_max(x):  # max over the static leading axis, balanced tree
        terms = [x[k] for k in range(x.shape[0])]
        while len(terms) > 1:
            nxt = [jnp.maximum(terms[i], terms[i + 1]) for i in range(0, len(terms) - 1, 2)]
            if len(terms) % 2:
                nxt.append(terms[-1])
            terms = nxt
        return terms[0]

    dist = _tree_max(jnp.where(valids_s, seps_s, neg_inf))
    # argmax with first-index tiebreak as a rank-0 one-hot: the pairwise-rank
    # form is log-depth, vs a 15-step serial first-true chain
    ranks = _rank_stacked(-scores_s)  # rank 0 = largest score, earliest index
    oh_s = (ranks == 0).astype(dtype)  # (15, P, B)
    oh = [oh_s[i] > 0.5 for i in range(15)]
    # winner axis in world frame, computed ONCE: blend the face axes
    # directly; for a winning cross axis blend its two factor columns and
    # take one normalized cross product
    face_axis = (jnp.zeros_like(one),) * 3
    for i in range(3):
        face_axis = add(face_axis, add(scale(oh_s[i], c1t[i]), scale(oh_s[3 + i], c2t[i])))
    w_c1 = [sum(oh_s[6 + 3 * i + j] for j in range(3)) for i in range(3)]  # (P, B)
    w_c2 = [sum(oh_s[6 + i + 3 * j] for j in range(3)) for i in range(3)]
    c1_sel = (jnp.zeros_like(one),) * 3
    c2_sel = (jnp.zeros_like(one),) * 3
    for i in range(3):
        c1_sel = add(c1_sel, scale(w_c1[i], c1t[i]))
        c2_sel = add(c2_sel, scale(w_c2[i], c2t[i]))
    inv_sel = usum(oh_s * jnp.stack(inv_nrms), 0)  # (P, B)
    cross_axis = scale(inv_sel, cross(c1_sel, c2_sel))
    is_edge_f = usum(oh_s[6:], 0)  # (P, B) 1.0 where a cross axis won
    axis = add(face_axis, scale(is_edge_f, cross_axis))
    sign = jnp.where(dot(axis, dt) >= 0, 1.0, -1.0).astype(dtype)
    normal = scale(sign, axis)

    is_face = (oh[0] | oh[1] | oh[2] | oh[3] | oh[4] | oh[5])
    ref_is_1 = (oh[0] | oh[1] | oh[2])

    # reference/incident box quantities blended per lane
    rsel = ref_is_1.astype(dtype)
    ref_pos = blend(rsel, x1t, x2t)
    inc_pos = blend(rsel, x2t, x1t)
    ref_cols = [blend(rsel, c1t[i], c2t[i]) for i in range(3)]
    inc_cols = [blend(rsel, c2t[i], c1t[i]) for i in range(3)]
    ref_size = [jnp.where(ref_is_1, size1[i], size2[i]) for i in range(3)]
    inc_size = [jnp.where(ref_is_1, size2[i], size1[i]) for i in range(3)]
    ref_n = vwhere(ref_is_1, normal, scale(-one, normal))

    # reference face local axis: one-hot over |alignment|
    ref_align = [dot(ref_cols[i], ref_n) for i in range(3)]
    ra_abs = [jnp.abs(v) for v in ref_align]
    ra_max = jnp.maximum(jnp.maximum(ra_abs[0], ra_abs[1]), ra_abs[2])
    e_ref = first_true_onehot([ra_abs[i] == ra_max for i in range(3)])
    ref_sign = jnp.sign(sum(ref_align[i] * e_ref[i].astype(dtype) for i in range(3)) + 1e-12)

    inc_align = [dot(inc_cols[i], ref_n) for i in range(3)]
    ia_abs = [jnp.abs(v) for v in inc_align]
    ia_max = jnp.maximum(jnp.maximum(ia_abs[0], ia_abs[1]), ia_abs[2])
    e_ax = first_true_onehot([ia_abs[i] == ia_max for i in range(3)])
    inc_sign = -jnp.sign(sum(inc_align[i] * e_ax[i].astype(dtype) for i in range(3)) + 1e-12)

    def blend3s(oh3, items):  # scalar (P, B)/( P, 1) items
        return sum(oh3[i].astype(dtype) * items[i] for i in range(3))

    def blend3v(oh3, items):  # tuple items
        out = (jnp.zeros_like(one),) * 3
        for i in range(3):
            out = add(out, scale(oh3[i].astype(dtype), items[i]))
        return out

    # incident face u/v axes are the two non-face axes in cyclic order:
    # u = (ax+1)%3, so axis k carries weight [ax == (k-1)%3] = e_ax[(k+2)%3]
    oh_u = [e_ax[(k + 2) % 3] for k in range(3)]
    oh_v = [e_ax[(k + 1) % 3] for k in range(3)]

    inc_face_size = blend3s(e_ax, inc_size)
    c_world = add(inc_pos, scale(inc_sign * inc_face_size, blend3v(e_ax, inc_cols)))
    u_axis_w = blend3v(oh_u, inc_cols)
    v_axis_w = blend3v(oh_v, inc_cols)
    u_half = blend3s(oh_u, inc_size)
    v_half = blend3s(oh_v, inc_size)

    # reference face rectangle frame
    r_u_w = blend3v([e_ref[(k + 2) % 3] for k in range(3)], ref_cols)
    r_v_w = blend3v([e_ref[(k + 1) % 3] for k in range(3)], ref_cols)
    r_n_w = blend3v(e_ref, ref_cols)
    hu = blend3s([e_ref[(k + 2) % 3] for k in range(3)], ref_size)
    hv = blend3s([e_ref[(k + 1) % 3] for k in range(3)], ref_size)
    h_face = blend3s(e_ref, ref_size)

    # incident-face corner coordinates IN THE REFERENCE FACE FRAME, expanded
    # analytically: vert(su, sv) = c_world + su*u_half*u_axis + sv*v_half*
    # v_axis, so each (u, v, w) dot decomposes into a base dot + two scalar
    # terms; world-space verts are never materialized
    rel_c = sub(c_world, ref_pos)
    base = [dot(rel_c, ax) for ax in (r_u_w, r_v_w, r_n_w)]
    du = [dot(u_axis_w, ax) * u_half for ax in (r_u_w, r_v_w, r_n_w)]
    dv = [dot(v_axis_w, ax) * v_half for ax in (r_u_w, r_v_w, r_n_w)]
    signs_uv = ((1, 1), (1, -1), (-1, 1), (-1, -1))
    u = [base[0] + su * du[0] + sv * dv[0] for su, sv in signs_uv]
    v = [base[1] + su * du[1] + sv * dv[1] for su, sv in signs_uv]
    w = [base[2] + su * du[2] + sv * dv[2] for su, sv in signs_uv]
    u_c = [jnp.clip(x, -hu, hu) for x in u]
    v_c = [jnp.clip(x, -hv, hv) for x in v]

    # incident-face plane in (u, v, w) ref coords: the plane normal is
    # cross(vert1-vert0, vert2-vert0) = 4*v_half*u_half*cross(v_axis, u_axis)
    n_pl = scale(4.0 * v_half * u_half, cross(v_axis_w, u_axis_w))
    n_u = dot(n_pl, r_u_w)
    n_v = dot(n_pl, r_v_w)
    n_w = dot(n_pl, r_n_w)
    n_w = jnp.sign(n_w + 1e-30) * jnp.maximum(jnp.abs(n_w), 1e-12)

    face_pts, face_ds = [], []
    h_ref = h_face * ref_sign
    for s_i in range(4):
        w_c = w[0] - (n_u * (u_c[s_i] - u[0]) + n_v * (v_c[s_i] - v[0])) / n_w
        depth = ref_sign * w_c - h_face
        mid_w = 0.5 * (w_c + h_ref)
        pcomp = add(
            add(ref_pos, scale(u_c[s_i], r_u_w)),
            add(scale(v_c[s_i], r_v_w), scale(mid_w, r_n_w)),
        )
        face_pts.append(pcomp)
        face_ds.append(depth)

    # edge-edge single contact
    e1_sel = [sum_oh([oh[6 + 3 * i + j] for j in range(3)]) for i in range(3)]  # axis of box1
    e2_sel = [sum_oh([oh[6 + i + 3 * j] for j in range(3)]) for i in range(3)]  # axis of box2
    a1 = blend3v(e1_sel, c1t)
    a2 = blend3v(e2_sel, c2t)
    # avoid zero axes when a face won: fall back to x-axes (masked out anyway)
    a1 = vwhere(is_face, c1t[0], a1)
    a2 = vwhere(is_face, c2t[0], a2)

    def edge_center(pos, cols, size, oh_edge, toward):
        out = pos
        for i in range(3):
            s_i = jnp.sign(dot(cols[i], toward) + 1e-12)
            keep = 1.0 - oh_edge[i].astype(dtype)
            out = add(out, scale(keep * s_i * size[i], cols[i]))
        return out

    ec1 = edge_center(x1t, c1t, size1, e1_sel, normal)
    ec2 = edge_center(x2t, c2t, size2, e2_sel, scale(-one, normal))
    d12 = sub(ec2, ec1)
    a1a2 = dot(a1, a2)
    denom = jnp.maximum(1.0 - a1a2 * a1a2, 1e-9)
    te1 = (dot(d12, a1) - dot(d12, a2) * a1a2) / denom
    te2 = -(dot(d12, a2) - dot(d12, a1) * a1a2) / denom
    edge_pt = scale(0.5 * one, add(add(ec1, scale(te1, a1)), add(ec2, scale(te2, a2))))

    big = jnp.asarray(_BIG, dtype)
    sep_positive = dist >= 0
    normal_s = pack(normal)
    out = []
    for s_i in range(4):
        fd = jnp.where(face_ds[s_i] < 0, face_ds[s_i], jnp.maximum(face_ds[s_i], dist))
        ed = dist if s_i == 0 else jnp.full_like(dist, _BIG)
        dd = jnp.where(is_face, fd, ed)
        pcomp = tuple(jnp.where(is_face, fp_k, ep_k) for fp_k, ep_k in zip(face_pts[s_i], edge_pt))
        dd = jnp.where(sep_positive, dist if s_i == 0 else big, dd)
        out.append((dd, pack(pcomp), normal_s))
    return out


def sum_oh(masks: list) -> jnp.ndarray:
    out = masks[0]
    for mk in masks[1:]:
        out = out | mk
    return out


_L_KERNELS = {
    (GEOM_PLANE, GEOM_SPHERE): _k_plane_sphere,
    (GEOM_PLANE, GEOM_CAPSULE): _k_plane_capsule,
    (GEOM_PLANE, GEOM_CYLINDER): _k_plane_cylinder,
    (GEOM_PLANE, GEOM_BOX): _k_plane_box,
    (GEOM_SPHERE, GEOM_SPHERE): _k_sphere_sphere,
    (GEOM_SPHERE, GEOM_CAPSULE): _k_sphere_capsule,
    (GEOM_SPHERE, GEOM_CYLINDER): _k_sphere_cylinder,
    (GEOM_SPHERE, GEOM_BOX): _k_sphere_box,
    (GEOM_CAPSULE, GEOM_CAPSULE): _k_capsule_capsule,
    (GEOM_CAPSULE, GEOM_CYLINDER): _k_capsule_cylinder,
    (GEOM_CAPSULE, GEOM_BOX): _k_capsule_box,
    (GEOM_CYLINDER, GEOM_CYLINDER): _k_cylinder_cylinder,
    (GEOM_CYLINDER, GEOM_BOX): _k_cylinder_box,
    (GEOM_BOX, GEOM_BOX): _k_box_box,
}

# slots emitted per pair type (static; must match the kernels above)
_SLOTS_PER_PAIR = {
    (GEOM_PLANE, GEOM_SPHERE): 1,
    (GEOM_PLANE, GEOM_CAPSULE): 2,
    (GEOM_PLANE, GEOM_CYLINDER): 2,
    (GEOM_PLANE, GEOM_BOX): 4,
    (GEOM_SPHERE, GEOM_SPHERE): 1,
    (GEOM_SPHERE, GEOM_CAPSULE): 1,
    (GEOM_SPHERE, GEOM_CYLINDER): 1,
    (GEOM_SPHERE, GEOM_BOX): 1,
    (GEOM_CAPSULE, GEOM_CAPSULE): 1,
    (GEOM_CAPSULE, GEOM_CYLINDER): 1,
    (GEOM_CAPSULE, GEOM_BOX): 2,
    (GEOM_CYLINDER, GEOM_CYLINDER): 2,
    (GEOM_CYLINDER, GEOM_BOX): 2,
    (GEOM_BOX, GEOM_BOX): 4,
}


def _pair_params_np(m: PhysicsModel, g1: int, g2: int):
    """Host-side mixed contact parameters (mj_contactParam): identical math to
    collision._pair_params_batched, evaluated in numpy at trace time (the
    inputs are model constants)."""
    gp = lambda a: np.asarray(jax.device_get(a), np.float64)  # noqa: E731
    fric = gp(m.geom_friction)
    solref = gp(m.geom_solref)
    solimp = gp(m.geom_solimp)
    solmix = gp(m.geom_solmix)
    margin = gp(m.geom_margin)
    gap = gp(m.geom_gap)
    p1, p2 = m.geom_priority[g1], m.geom_priority[g2]
    if p1 > p2:
        mu, sr, si = fric[g1, 0], solref[g1], solimp[g1]
        mg = margin[g1] - gap[g1]
    elif p2 > p1:
        mu, sr, si = fric[g2, 0], solref[g2], solimp[g2]
        mg = margin[g2] - gap[g2]
    else:
        mu = max(fric[g1, 0], fric[g2, 0])
        s1, s2 = solmix[g1], solmix[g2]
        w1 = s1 / max(s1 + s2, 1e-12)
        w2 = 1.0 - w1
        if solref[g1, 0] > 0 and solref[g2, 0] > 0:
            sr = w1 * solref[g1] + w2 * solref[g2]
        else:
            sr = np.minimum(solref[g1], solref[g2])
        si = w1 * solimp[g1] + w2 * solimp[g2]
        mg = max(margin[g1], margin[g2]) - max(gap[g1], gap[g2])
    return max(float(mu), 1e-5), sr, si, float(mg)


def find_contacts_l(m: PhysicsModel, kin: LaneKin) -> LaneContacts | None:
    """Narrowphase over the static pair list -> stacked LaneContacts.

    Slot order matches collision.find_contacts' grouped-by-type, pair-major
    ordering exactly (warm-start transfer and parity tests rely on it): for
    each pair type in first-seen order, for each pair, its slots in kernel
    order.
    """
    from judo_tpu.physics.lane_engine import LaneKin  # noqa: F401 (docs)

    gp = lambda a: np.asarray(jax.device_get(a), np.float64)  # noqa: E731
    geom_size = gp(m.geom_size)

    groups: dict = {}
    for g1, g2 in m.collision_pairs:
        sig = (m.geom_type[g1], m.geom_type[g2])
        if sig in _L_KERNELS:
            groups.setdefault(sig, []).append((g1, g2))

    dtype = kin.geom_xpos[0].dtype if kin.geom_xpos else jnp.float32
    d_parts: list = []  # per group: (P*S, B) pair-major
    p_parts: list = []
    n_parts: list = []
    body1: list = []
    body2: list = []
    friction: list = []
    solref: list = []
    solimp: list = []
    includemargin: list = []

    for sig, pairs in groups.items():
        kernel = _L_KERNELS[sig]
        P = len(pairs)
        x1 = jnp.stack([kin.geom_xpos[g1] for g1, _ in pairs])  # (P, 3, B)
        m1 = jnp.stack([kin.geom_xmat[g1] for g1, _ in pairs])  # (P, 3, 3, B)
        x2 = jnp.stack([kin.geom_xpos[g2] for _, g2 in pairs])
        m2 = jnp.stack([kin.geom_xmat[g2] for _, g2 in pairs])
        from judo_tpu.physics.lane_engine import const_col

        sz1 = np.stack([geom_size[g1] for g1, _ in pairs])  # (P, 3) host
        sz2 = np.stack([geom_size[g2] for _, g2 in pairs])
        s1 = tuple(const_col(sz1[:, k], dtype) for k in range(3))
        s2 = tuple(const_col(sz2[:, k], dtype) for k in range(3))
        slots = kernel(x1, m1, s1, x2, m2, s2)
        S = len(slots)
        assert S == _SLOTS_PER_PAIR[sig], (sig, S)
        # pair-major flatten: (S, P, B) stacked on axis 1 -> (P, S, B) -> (P*S, B)
        d_g = jnp.stack([d for d, _, _ in slots], axis=1)  # (P, S, B)
        p_g = jnp.stack([p for _, p, _ in slots], axis=1)  # (P, S, 3, B)
        n_g = jnp.stack([n for _, _, n in slots], axis=1)
        d_parts.append(d_g.reshape(P * S, *d_g.shape[2:]))
        p_parts.append(p_g.reshape(P * S, *p_g.shape[2:]))
        n_parts.append(n_g.reshape(P * S, *n_g.shape[2:]))
        for g1, g2 in pairs:
            mu, sr, si, mg = _pair_params_np(m, g1, g2)
            for _ in range(S):
                body1.append(int(m.geom_bodyid[g1]))
                body2.append(int(m.geom_bodyid[g2]))
                friction.append(mu)
                solref.append(sr)
                solimp.append(si)
                includemargin.append(mg)

    if not body1:
        return None
    return LaneContacts(
        dist=jnp.concatenate(d_parts, axis=0),
        pos=jnp.concatenate(p_parts, axis=0),
        normal=jnp.concatenate(n_parts, axis=0),
        body1=tuple(body1),
        body2=tuple(body2),
        friction=np.asarray(friction, np.float64),
        solref=np.stack(solref),
        solimp=np.stack(solimp),
        includemargin=np.asarray(includemargin, np.float64),
    )


def tangent_frame_l(n: jnp.ndarray) -> tuple:
    """Orthonormal (t1, t2) completing unit normals n ((..., 3, B))."""
    ex = _e3([1, 0, 0], n)
    ey = _e3([0, 1, 0], n)
    ref = jnp.where((jnp.abs(n[..., 0, :]) < 0.5)[..., None, :], ex, ey)
    t1 = l_cross(n, ref)
    t1 = t1 / jnp.maximum(jnp.sqrt(jnp.maximum(l_dot3(t1, t1), 1e-24)), 1e-12)[..., None, :]
    t2 = l_cross(n, t1)
    return t1, t2
