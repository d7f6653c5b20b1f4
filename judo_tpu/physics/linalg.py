"""Small-matrix batched linear algebra for the per-step mass matrices.

Two generations of design:

1. XLA's native Cholesky/triangular-solve lower to blocked while-loops sized
   for large tiles — a poor fit for the nv x nv (nv ~ 4-25) mass matrices
   this engine factors per physics step.
2. The first replacement *unrolled the factorization over columns with
   ``.at[...].set`` updates* — but gather/scatter ops inside a scan are slow
   next to fused elementwise ops and blow up XLA compile time; ~10 scatters
   per column x 2 factorizations dominated the whole step.

The current formulation is **scatter/gather-free**: every per-column update
is expressed with static slices, constant one-hot masks, and full-matrix
elementwise/outer-product ops — each column costs a couple of fused
elementwise ops across the whole rollout batch, nothing else.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp


def cholesky(m: jnp.ndarray) -> jnp.ndarray:
    """Lower-triangular Cholesky factor of SPD ``m`` (..., n, n).

    Right-looking outer-product form: at column j the remaining Schur
    complement lives in ``a``; the column is extracted with a static slice,
    masked with a *constant* lower-triangular one-hot, and both the factor
    accumulation and the trailing update are rank-1 elementwise ops.
    """
    n = m.shape[-1]
    dtype = m.dtype
    a = m
    l = jnp.zeros_like(m)  # noqa: E741
    eye = np.eye(n, dtype=bool)
    for j in range(n):
        d = jnp.sqrt(jnp.maximum(a[..., j, j], 1e-30))  # (...,)
        col = a[..., :, j] / d[..., None]  # (..., n)
        keep = np.zeros(n, np.float32)
        keep[j:] = 1.0  # rows >= j belong to L's column j
        col = col * jnp.asarray(keep, dtype)
        l = l + col[..., :, None] * jnp.asarray(eye[j], dtype)[None, :]
        # trailing update: subtract the rank-1 outer product (rows/cols > j)
        a = a - col[..., :, None] * col[..., None, :]
    return l


def spd_inverse(m: jnp.ndarray) -> jnp.ndarray:
    """Explicit inverse of SPD ``m`` (..., n, n) via Gauss-Jordan.

    Scatter-free: per column, the pivot row is a static slice, the
    elimination multipliers are the pivot column scaled (with the pivot row
    itself excluded by a constant mask), and both the matrix and the inverse
    accumulator are updated with one fused rank-1 op each. No pivoting —
    SPD diagonals stay strictly positive through elimination.

    Materializing M^-1 (n ~ 4-25) and applying it with matmuls is cheaper
    than running substitutions against wide right-hand sides (e.g. the
    (nv, nefc~300) contact-Jacobian transpose): the substitutions cost O(n)
    sequential ops *per use*, the matmul is a single op.
    """
    n = m.shape[-1]
    dtype = m.dtype
    a = m
    x = jnp.broadcast_to(jnp.eye(n, dtype=dtype), m.shape)
    eye = jnp.eye(n, dtype=dtype)
    for j in range(n):
        # eliminate column j from every other row using the UNnormalized pivot
        # row (classic GJ deferred normalization: halves the per-column ops);
        # the constant mask kills the pivot row's own multiplier
        notj_over_d = (1.0 - eye[j]) / a[..., j, j][..., None]  # (..., n)
        f = a[..., :, j] * notj_over_d  # (..., n)
        a = a - f[..., :, None] * a[..., j, None, :]
        x = x - f[..., :, None] * x[..., j, None, :]
    # a is now diagonal; normalize x rows by it (extract via masked reduce —
    # jnp.diagonal is a gather on some backends)
    diag = jnp.sum(a * eye, axis=-1)  # (..., n)
    x = x / diag[..., :, None]
    return 0.5 * (x + x.swapaxes(-1, -2))


def spd_solve(m: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """SPD solve via the explicit inverse (one matmul against b)."""
    inv = spd_inverse(m)
    if b.ndim == m.ndim - 1:
        return jnp.einsum("...ij,...j->...i", inv, b)
    return inv @ b


def cho_solve(l: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:  # noqa: E741
    """Solve (L L^T) x = b given the factor from ``cholesky``.

    Scatter-free substitutions: each step uses a static row slice and a
    constant one-hot accumulation instead of indexed updates.
    """
    n = l.shape[-1]
    dtype = l.dtype
    vec = b.ndim == l.ndim - 1
    if vec:
        b = b[..., None]
    eye = np.eye(n, dtype=np.float32)
    # forward: L y = b
    y = jnp.zeros_like(b)
    for j in range(n):
        acc = jnp.einsum("...k,...kc->...c", l[..., j, :], y)  # uses only y[<j] (rest are 0*0)
        yj = (b[..., j, :] - acc) / l[..., j, j][..., None]
        y = y + jnp.asarray(eye[j], dtype)[..., :, None] * yj[..., None, :]
    # backward: L^T x = y
    x = jnp.zeros_like(b)
    for j in range(n - 1, -1, -1):
        acc = jnp.einsum("...k,...kc->...c", l[..., :, j], x)  # uses only x[>j]
        xj = (y[..., j, :] - acc) / l[..., j, j][..., None]
        x = x + jnp.asarray(eye[j], dtype)[..., :, None] * xj[..., None, :]
    return x[..., 0] if vec else x


def cho_inverse(l: jnp.ndarray) -> jnp.ndarray:  # noqa: E741
    """Explicit inverse (L L^T)^-1 from the factor (API kept; delegates to the
    Gauss-Jordan path on the recomposed matrix costs an extra matmul, so the
    substitutions run against the identity instead)."""
    n = l.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(n, dtype=l.dtype), l.shape)
    inv = cho_solve(l, eye)
    return 0.5 * (inv + inv.swapaxes(-1, -2))
