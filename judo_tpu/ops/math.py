"""Batched quaternion math in JAX.

Semantics match the reference numpy implementations in
judo/utils/math_utils.py:6-119 (wxyz order, broadcastable leading dims);
rewritten for jnp so they trace/jit/vmap cleanly.
"""

from __future__ import annotations

import jax.numpy as jnp


def safe_normalize_axis(axis: jnp.ndarray, eps: float = 1e-6) -> jnp.ndarray:
    """Normalize 3D axis vectors, substituting [1,0,0] for near-zero norms.

    Reference: judo/utils/math_utils.py:6-23.
    """
    norm = jnp.linalg.norm(axis, axis=-1)
    small = norm < eps
    safe_norm = jnp.where(small, 1.0, norm)
    normalized = axis / safe_norm[..., None]
    fallback = jnp.zeros_like(normalized).at[..., 0].set(1.0)
    return jnp.where(small[..., None], fallback, normalized)


def quat_inv(u: jnp.ndarray) -> jnp.ndarray:
    """Conjugate of a (unit) quaternion, wxyz. Reference: math_utils.py:26-35."""
    return u * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=u.dtype)


def quat_mul(u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product with broadcasting. Reference: math_utils.py:38-55."""
    w = u[..., 0] * v[..., 0] - u[..., 1] * v[..., 1] - u[..., 2] * v[..., 2] - u[..., 3] * v[..., 3]
    x = u[..., 0] * v[..., 1] + u[..., 1] * v[..., 0] + u[..., 2] * v[..., 3] - u[..., 3] * v[..., 2]
    y = u[..., 0] * v[..., 2] - u[..., 1] * v[..., 3] + u[..., 2] * v[..., 0] + u[..., 3] * v[..., 1]
    z = u[..., 0] * v[..., 3] + u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1] + u[..., 3] * v[..., 0]
    return jnp.stack([w, x, y, z], axis=-1)


def quat_diff(u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """u^* ⊗ v. Reference: math_utils.py:58-68."""
    return quat_mul(quat_inv(u), v)


def axis_angle_diff(u: jnp.ndarray, v: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Axis-angle of the relative rotation, wrapped to [0, pi].

    Reference: judo/utils/math_utils.py:71-95.
    """
    diff = quat_diff(u, v)
    axis = diff[..., 1:]
    sin_half = jnp.linalg.norm(axis, axis=-1)
    axis = safe_normalize_axis(axis, eps=1e-6)
    angle = 2.0 * jnp.arctan2(sin_half, diff[..., 0])
    wrap = angle > jnp.pi
    angle = jnp.where(wrap, 2.0 * jnp.pi - angle, angle)
    axis = jnp.where(wrap[..., None], -axis, axis)
    return angle, axis


def quat_diff_so3(u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """SO(3) log map of the relative rotation. Reference: math_utils.py:98-107."""
    diff = quat_diff(u, v)
    axis = diff[..., 1:]
    sin_half = jnp.linalg.norm(axis, axis=-1)
    axis = safe_normalize_axis(axis, eps=1e-6)
    speed = 2.0 * jnp.arctan2(sin_half, diff[..., 0])
    speed = jnp.where(speed > jnp.pi, speed - 2.0 * jnp.pi, speed)
    return axis * speed[..., None]


def quat_vel(u: jnp.ndarray, v: jnp.ndarray, dt: float) -> jnp.ndarray:
    """Finite-difference angular velocity between quats. Reference: math_utils.py:110-119."""
    return 2.0 * quat_mul(quat_inv(u), (v - u) / dt)[..., 1:]


def quat_rotate(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate vector(s) v by quaternion(s) q (wxyz), broadcasting leading dims.

    Matches the batched helper in judo/tasks/spot/spot_utils.py:8-28.
    """
    w = q[..., :1]
    u = q[..., 1:]
    uv = jnp.cross(u, v)
    uuv = jnp.cross(u, uv)
    return v + 2.0 * (w * uv + uuv)


def quat_to_mat(q: jnp.ndarray) -> jnp.ndarray:
    """Quaternion (wxyz) to rotation matrix, batched over leading dims."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = jnp.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        axis=-1,
    )
    return r.reshape(*q.shape[:-1], 3, 3)


def quat_integrate(q: jnp.ndarray, omega: jnp.ndarray, dt: float) -> jnp.ndarray:
    """Integrate unit quaternion by body-frame angular velocity omega for dt.

    Matches MuJoCo's mju_quatIntegrate (exact exponential map), used for ball /
    free joint position integration.
    """
    angle = jnp.linalg.norm(omega, axis=-1, keepdims=True) * dt
    axis = safe_normalize_axis(omega, eps=1e-12)
    half = 0.5 * angle
    dq = jnp.concatenate([jnp.cos(half), axis * jnp.sin(half)], axis=-1)
    out = quat_mul(q, dq)
    return out / jnp.linalg.norm(out, axis=-1, keepdims=True)
