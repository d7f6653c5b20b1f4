"""Sensor evaluation (position-stage sensors).

The reference harvests ``framepos`` sensors for rollout traces
(judo/visualizers/utils.py:169-190) and tasks index into sensordata
(judo/tasks/base.py:180-204); this module produces the same flat sensordata
layout from the JAX pipeline.
"""

from __future__ import annotations

import jax.numpy as jnp

from judo_tpu.ops.math import quat_mul
from judo_tpu.physics.model import (
    SENSOR_DISTANCE,
    SENSOR_FRAMEPOS,
    SENSOR_FRAMEQUAT,
    SENSOR_FRAMEXAXIS,
    SENSOR_FRAMEYAXIS,
    SENSOR_FRAMEZAXIS,
    SENSOR_JOINTPOS,
    SENSOR_JOINTVEL,
    _OBJ_BODY,
    _OBJ_SITE,
    _OBJ_XBODY,
    PhysicsModel,
)
from judo_tpu.physics.smooth import Kinematics


def _distance_sensor(m: PhysicsModel, kin: Kinematics, body1: int, body2: int, cutoff) -> jnp.ndarray:
    """Min distance between two bodies' geoms via the narrowphase kernels
    (mjSENS_GEOMDIST semantics: clamped to cutoff from above)."""
    from judo_tpu.physics.collision import _KERNELS

    dists = [cutoff]
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
                continue  # handled once in canonical order
            sig = (m.geom_type[a], m.geom_type[b])
            kernel = _KERNELS.get(sig)
            if kernel is None:
                continue
            d, _, _ = kernel(
                kin.geom_xpos[a], kin.geom_xmat[a], m.geom_size[a],
                kin.geom_xpos[b], kin.geom_xmat[b], m.geom_size[b],
            )
            dists.append(jnp.min(d))
    return jnp.minimum(jnp.stack([jnp.asarray(v) for v in dists]).min(), cutoff)


def evaluate_sensors(
    m: PhysicsModel, kin: Kinematics, qpos: jnp.ndarray | None = None, qvel: jnp.ndarray | None = None
) -> jnp.ndarray:
    """Flat (nsensordata,) vector matching MuJoCo's sensordata layout.

    Assembled as per-sensor segments concatenated in address order (the
    sensordata layout is static), never via ``.at[]`` indexed writes inside
    the rollout scan."""
    dtype = kin.xpos.dtype
    segs: list[jnp.ndarray] = []
    cursor = 0

    def emit(adr: int, dim: int, val: jnp.ndarray | None) -> None:
        nonlocal cursor
        assert adr >= cursor, "sensordata layout must be address-ordered"
        if adr > cursor:
            segs.append(jnp.zeros(adr - cursor, dtype))
        segs.append(jnp.zeros(dim, dtype) if val is None else jnp.reshape(val, (dim,)))
        cursor = adr + dim

    for i in range(m.nsensor):
        stype = m.sensor_type[i]
        objtype = m.sensor_objtype[i]
        objid = m.sensor_objid[i]
        adr = m.sensor_adr[i]
        dim = m.sensor_dim[i]
        val: jnp.ndarray | None = None
        if stype == SENSOR_JOINTPOS and qpos is not None:
            val = qpos[m.jnt_qposadr[objid]]
        elif stype == SENSOR_JOINTVEL and qvel is not None:
            val = qvel[m.jnt_dofadr[objid]]
        elif stype == SENSOR_FRAMEPOS:
            if objtype == _OBJ_SITE:
                val = kin.site_xpos[objid]
            elif objtype in (_OBJ_BODY, _OBJ_XBODY):
                val = kin.xipos[objid] if objtype == _OBJ_BODY else kin.xpos[objid]
            if val is not None:
                # relative to a reference frame when specified (mjSENS_FRAMEPOS ref)
                refid = m.sensor_refid[i]
                if refid >= 0 and m.sensor_reftype[i] == _OBJ_SITE:
                    val = kin.site_xmat[refid].T @ (val - kin.site_xpos[refid])
        elif stype == SENSOR_DISTANCE and objtype == _OBJ_BODY:
            val = _distance_sensor(m, kin, objid, m.sensor_refid[i], m.sensor_cutoff[i])
        elif stype in (SENSOR_FRAMEXAXIS, SENSOR_FRAMEYAXIS, SENSOR_FRAMEZAXIS):
            col = {SENSOR_FRAMEXAXIS: 0, SENSOR_FRAMEYAXIS: 1, SENSOR_FRAMEZAXIS: 2}[stype]
            if objtype == _OBJ_SITE:
                val = kin.site_xmat[objid][:, col]
            elif objtype in (_OBJ_BODY, _OBJ_XBODY):
                val = kin.xmat[objid][:, col]
        elif stype == SENSOR_FRAMEQUAT:
            if objtype == _OBJ_SITE:
                b = m.site_bodyid[objid]
                val = quat_mul(kin.xquat[b], m.site_quat[objid])
            elif objtype in (_OBJ_BODY, _OBJ_XBODY):
                val = quat_mul(kin.xquat[objid], m.body_iquat[objid]) if objtype == _OBJ_BODY else kin.xquat[objid]
        # other sensor types: zeros for now (extended as tasks require them)
        emit(adr, dim, val)

    if cursor < m.nsensordata:
        segs.append(jnp.zeros(m.nsensordata - cursor, dtype))
    if not segs:
        return jnp.zeros(m.nsensordata, dtype)
    return jnp.concatenate(segs).astype(dtype)
