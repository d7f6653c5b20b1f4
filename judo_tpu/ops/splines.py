"""JAX spline interpolation for control knots.

The reference interpolates control knots with ``scipy.interpolate.interp1d``
(kind in {"zero", "linear", "cubic"}, axis=-2, constant extrapolation with the
edge knot values — judo/controller/controller.py:382-401, judo/app/structs.py:57-84).

This module reimplements those semantics as pure jnp functions with static
shapes so they trace once under jit and batch with vmap/broadcasting:

- "zero": previous-knot step function
- "linear": piecewise linear
- "cubic": C2 cubic spline with not-a-knot boundary conditions (the same
  boundary conditions scipy uses), solved as a dense (N,N) linear system —
  N is the number of knots (3..12 here), so the solve is trivially cheap and
  maps to one small batched matmul/solve on device.

All evaluators clamp queries to [t0, tN-1]: outside the knot range the spline
returns the edge knot value (matching interp1d's fill_value=(first, last)).
"""

from __future__ import annotations

from typing import Literal

import jax.numpy as jnp

SplineOrder = Literal["zero", "linear", "cubic"]


def _interval_index(ts: jnp.ndarray, tq: jnp.ndarray, n_max: int) -> jnp.ndarray:
    """Index of the knot interval containing each query (clipped to valid range)."""
    idx = jnp.searchsorted(ts, tq, side="right") - 1
    return jnp.clip(idx, 0, n_max)


def _notaknot_slopes(ts: jnp.ndarray, knots: jnp.ndarray) -> jnp.ndarray:
    """First derivatives of the not-a-knot cubic spline at each knot.

    Solves the standard tridiagonal system for knot slopes s_i (assembled dense;
    N <= ~16 so a dense solve is cheap and trivially batchable).

    ts: (N,), knots: (..., N, nu) -> slopes (..., N, nu)
    """
    n = ts.shape[0]
    dt = ts[1:] - ts[:-1]  # (N-1,)
    slope = (knots[..., 1:, :] - knots[..., :-1, :]) / dt[..., :, None]  # (..., N-1, nu)

    a = jnp.zeros((n, n), dtype=knots.dtype)
    # Interior rows i = 1..N-2:
    #   dt[i] * s[i-1] + 2*(dt[i-1]+dt[i]) * s[i] + dt[i-1] * s[i+1]
    #     = 3*(dt[i]*slope[i-1] + dt[i-1]*slope[i])
    i = jnp.arange(1, n - 1)
    a = a.at[i, i - 1].set(dt[1:])
    a = a.at[i, i].set(2.0 * (dt[:-1] + dt[1:]))
    a = a.at[i, i + 1].set(dt[:-1])
    b_mid = 3.0 * (
        dt[1:, None] * slope[..., :-1, :] + dt[:-1, None] * slope[..., 1:, :]
    )  # (..., N-2, nu)

    # Not-a-knot boundary rows (same conditions as scipy's CubicSpline).
    d0 = ts[2] - ts[0]
    a = a.at[0, 0].set(dt[1])
    a = a.at[0, 1].set(d0)
    b0 = (
        (dt[0] + 2.0 * d0) * dt[1] * slope[..., 0, :] + dt[0] ** 2 * slope[..., 1, :]
    ) / d0  # (..., nu)

    dn = ts[-1] - ts[-3]
    a = a.at[-1, -1].set(dt[-2])
    a = a.at[-1, -2].set(dn)
    bn = (
        dt[-1] ** 2 * slope[..., -2, :] + (2.0 * dn + dt[-1]) * dt[-2] * slope[..., -1, :]
    ) / dn  # (..., nu)

    b = jnp.concatenate([b0[..., None, :], b_mid, bn[..., None, :]], axis=-2)  # (..., N, nu)
    return jnp.linalg.solve(a, b)


def eval_spline(
    ts: jnp.ndarray,
    knots: jnp.ndarray,
    tq: jnp.ndarray,
    order: SplineOrder = "linear",
) -> jnp.ndarray:
    """Evaluate a knot spline at query times.

    Args:
        ts: knot times, shape (N,), strictly increasing.
        knots: knot values, shape (..., N, nu).
        tq: query times, shape (T,).
        order: "zero" | "linear" | "cubic" (static).

    Returns:
        Values at tq, shape (..., T, nu). Constant extrapolation with edge
        values outside [ts[0], ts[-1]].
    """
    n = ts.shape[0]
    if order == "zero":
        idx = _interval_index(ts, tq, n - 1)  # may index the last knot directly
        return jnp.take(knots, idx, axis=-2)

    tq_c = jnp.clip(tq, ts[0], ts[-1])
    idx = _interval_index(ts, tq_c, n - 2)
    t0 = jnp.take(ts, idx)  # (T,)
    y0 = jnp.take(knots, idx, axis=-2)  # (..., T, nu)
    y1 = jnp.take(knots, idx + 1, axis=-2)
    h = jnp.take(ts, idx + 1) - t0  # (T,)
    x = ((tq_c - t0) / h)[..., :, None]  # (T, 1) normalized local coordinate

    if order == "linear":
        return y0 + (y1 - y0) * x

    if order == "cubic":
        if n < 4:
            raise ValueError("cubic splines require at least 4 knots (reference forces num_nodes>=4)")
        slopes = _notaknot_slopes(ts, knots)  # (..., N, nu)
        s0 = jnp.take(slopes, idx, axis=-2) * h[..., :, None]
        s1 = jnp.take(slopes, idx + 1, axis=-2) * h[..., :, None]
        # Cubic Hermite in normalized coordinates.
        dy = y1 - y0
        c2 = 3.0 * dy - 2.0 * s0 - s1
        c3 = -2.0 * dy + s0 + s1
        return y0 + x * (s0 + x * (c2 + x * c3))

    raise ValueError(f"unknown spline order: {order}")


def interp_linear(old_ts: jnp.ndarray, values: jnp.ndarray, new_ts: jnp.ndarray) -> jnp.ndarray:
    """Linear re-interpolation with linear extrapolation.

    Matches scipy interp1d(kind="linear", fill_value="extrapolate") used by CEM
    to carry its sigma state across node-count changes (judo/optimizers/cem.py:44-53).

    old_ts: (N,), values: (..., N, nu), new_ts: (M,) -> (..., M, nu)
    """
    n = old_ts.shape[0]
    idx = jnp.clip(jnp.searchsorted(old_ts, new_ts, side="right") - 1, 0, n - 2)
    t0 = jnp.take(old_ts, idx)
    h = jnp.take(old_ts, idx + 1) - t0
    y0 = jnp.take(values, idx, axis=-2)
    y1 = jnp.take(values, idx + 1, axis=-2)
    x = ((new_ts - t0) / h)[..., :, None]
    return y0 + (y1 - y0) * x  # no clipping: extrapolates linearly on both ends
