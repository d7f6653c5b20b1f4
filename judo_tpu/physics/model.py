"""Model/state pytrees and host-side lowering from MuJoCo's MJCF compiler.

Models are compiled on the host with ``mujoco.MjModel`` (the reference does the
same via ``MjSpec`` — judo/tasks/base.py:35-37) and then *lowered* into a
``PhysicsModel``: a frozen pytree whose array leaves are baked into the jitted
step function and whose structural metadata (tree topology, joint types,
addresses) is static Python data. Nothing from the MuJoCo runtime is used on
the hot path — stepping is implemented from scratch in JAX — and this module
imports ``mujoco`` only inside ``put_model``, so a lowered model can be loaded
and stepped where MuJoCo is not installed (tasks/exported.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Enum codes below are MuJoCo's own values (mjtJoint, mjtGeom, mjtIntegrator,
# mjtSensor, mjtEq, mjtObj), so lowering is a passthrough;
# tests/test_physics/test_parity.py checks them against the installed mujoco.

# Joint type codes (mjtJoint).
FREE, BALL, SLIDE, HINGE = 0, 1, 2, 3

# Geom type codes (mjtGeom).
GEOM_PLANE, GEOM_HFIELD, GEOM_SPHERE, GEOM_CAPSULE = 0, 1, 2, 3
GEOM_ELLIPSOID, GEOM_CYLINDER, GEOM_BOX, GEOM_MESH = 4, 5, 6, 7

# Integrator codes (mjtIntegrator).
INT_EULER, INT_RK4, INT_IMPLICIT, INT_IMPLICITFAST = 0, 1, 2, 3

# Sensor type codes we support (mjtSensor).
SENSOR_JOINTPOS, SENSOR_JOINTVEL = 9, 10
SENSOR_FRAMEPOS, SENSOR_FRAMEQUAT = 26, 27
SENSOR_FRAMEXAXIS, SENSOR_FRAMEYAXIS, SENSOR_FRAMEZAXIS = 28, 29, 30
SENSOR_FRAMELINVEL = 31
SENSOR_DISTANCE = 39  # mjSENS_GEOMDIST

# Equality constraint types (mjtEq).
EQ_CONNECT, EQ_WELD, EQ_JOINT, EQ_TENDON = 0, 1, 2, 3

# Object types (mjtObj).
_OBJ_BODY, _OBJ_XBODY, _OBJ_GEOM, _OBJ_SITE = 1, 2, 5, 6


def _t(x) -> tuple:
    """Static tuple-of-ints from an array (hashable, safe in jit closures)."""
    return tuple(int(v) for v in np.asarray(x).reshape(-1))


def _static(**kwargs):
    """Dataclass field that is pytree metadata (static under jit)."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PhysicsModel:
    """Static-shaped device model. Array fields are pytree leaves; ``_static``
    fields are pytree metadata and participate in jit caching."""

    # --- static structural metadata ---
    nq: int = _static()
    nv: int = _static()
    nu: int = _static()
    nbody: int = _static()
    njnt: int = _static()
    ngeom: int = _static()
    nsite: int = _static()
    nsensor: int = _static()
    nsensordata: int = _static()
    integrator: int = _static()
    cone_pyramidal: bool = _static()
    contact_enabled: bool = _static()
    limit_enabled: bool = _static()
    gravity_enabled: bool = _static()
    solver_iterations: int = _static()

    body_parentid: Tuple[int, ...] = _static()
    body_rootid: Tuple[int, ...] = _static()
    body_jntadr: Tuple[int, ...] = _static()
    body_jntnum: Tuple[int, ...] = _static()
    body_dofadr: Tuple[int, ...] = _static()
    body_dofnum: Tuple[int, ...] = _static()
    jnt_type: Tuple[int, ...] = _static()
    jnt_qposadr: Tuple[int, ...] = _static()
    jnt_dofadr: Tuple[int, ...] = _static()
    jnt_bodyid: Tuple[int, ...] = _static()
    jnt_limited: Tuple[int, ...] = _static()
    jnt_actfrclimited: Tuple[int, ...] = _static()
    dof_bodyid: Tuple[int, ...] = _static()
    dof_jntid: Tuple[int, ...] = _static()
    dof_parentid: Tuple[int, ...] = _static()
    geom_type: Tuple[int, ...] = _static()
    geom_bodyid: Tuple[int, ...] = _static()
    geom_condim: Tuple[int, ...] = _static()
    geom_priority: Tuple[int, ...] = _static()
    site_bodyid: Tuple[int, ...] = _static()
    actuator_trnid: Tuple[int, ...] = _static()
    sensor_type: Tuple[int, ...] = _static()
    sensor_objtype: Tuple[int, ...] = _static()
    sensor_objid: Tuple[int, ...] = _static()
    sensor_adr: Tuple[int, ...] = _static()
    sensor_dim: Tuple[int, ...] = _static()
    sensor_reftype: Tuple[int, ...] = _static()
    sensor_refid: Tuple[int, ...] = _static()
    sensor_objname: Tuple[str, ...] = _static()
    neq: int = _static()
    eq_type: Tuple[int, ...] = _static()
    eq_obj1id: Tuple[int, ...] = _static()
    eq_obj2id: Tuple[int, ...] = _static()
    # Candidate collision pairs, precomputed at lowering: tuple of (g1, g2).
    collision_pairs: Tuple[Tuple[int, int], ...] = _static()

    # --- dynamic array leaves ---
    timestep: jnp.ndarray
    gravity: jnp.ndarray  # (3,)
    qpos0: jnp.ndarray  # (nq,)
    qpos_spring: jnp.ndarray  # (nq,)
    body_pos: jnp.ndarray  # (nbody, 3)
    body_quat: jnp.ndarray  # (nbody, 4)
    body_ipos: jnp.ndarray  # (nbody, 3)
    body_iquat: jnp.ndarray  # (nbody, 4)
    body_mass: jnp.ndarray  # (nbody,)
    body_inertia: jnp.ndarray  # (nbody, 3) principal inertia
    jnt_pos: jnp.ndarray  # (njnt, 3)
    jnt_axis: jnp.ndarray  # (njnt, 3)
    jnt_range: jnp.ndarray  # (njnt, 2)
    jnt_stiffness: jnp.ndarray  # (njnt,)
    jnt_solref: jnp.ndarray  # (njnt, 2) limit solref
    jnt_solimp: jnp.ndarray  # (njnt, 5) limit solimp
    jnt_margin: jnp.ndarray  # (njnt,)
    jnt_actfrcrange: jnp.ndarray  # (njnt, 2) total-actuator-force clamp
    dof_damping: jnp.ndarray  # (nv,)
    dof_armature: jnp.ndarray  # (nv,)
    dof_frictionloss: jnp.ndarray  # (nv,)
    dof_invweight0: jnp.ndarray  # (nv,)
    geom_pos: jnp.ndarray  # (ngeom, 3)
    geom_quat: jnp.ndarray  # (ngeom, 4)
    geom_size: jnp.ndarray  # (ngeom, 3)
    geom_friction: jnp.ndarray  # (ngeom, 3)
    geom_solref: jnp.ndarray  # (ngeom, 2)
    geom_solimp: jnp.ndarray  # (ngeom, 5)
    geom_solmix: jnp.ndarray  # (ngeom,)
    geom_margin: jnp.ndarray  # (ngeom,)
    geom_gap: jnp.ndarray  # (ngeom,)
    site_pos: jnp.ndarray  # (nsite, 3)
    site_quat: jnp.ndarray  # (nsite, 4)
    sensor_cutoff: jnp.ndarray  # (nsensor,)
    eq_data: jnp.ndarray  # (neq, 11)
    eq_solref: jnp.ndarray  # (neq, 2)
    eq_solimp: jnp.ndarray  # (neq, 5)
    actuator_gear: jnp.ndarray  # (nu, 6)
    actuator_gainprm: jnp.ndarray  # (nu, 10)
    actuator_biasprm: jnp.ndarray  # (nu, 10)
    actuator_ctrlrange: jnp.ndarray  # (nu, 2)
    actuator_forcerange: jnp.ndarray  # (nu, 2)
    actuator_ctrllimited: jnp.ndarray  # (nu,) bool
    actuator_forcelimited: jnp.ndarray  # (nu,) bool
    # dof ancestry mask for the dense CRB mass matrix: mask[i, j] = 1 iff dof j
    # is dof i or one of its tree ancestors (static structure, but used in
    # arithmetic so kept as an array leaf).
    dof_ancestor_mask: jnp.ndarray  # (nv, nv)
    # body_dof_mask[b, i] = 1 iff dof i is in body b's ancestor chain (for
    # dense point Jacobians).
    body_dof_mask: jnp.ndarray  # (nbody, nv)
    # subtree_mask[b, c] = 1 iff body c is in body b's subtree (incl. itself):
    # turns every backward tree accumulation into one matmul.
    subtree_mask: jnp.ndarray  # (nbody, nbody)
    # dofdot_mask[i, j] = 1 iff dof j's velocity contributes to cdof_dot[i]
    # (strict dof ancestors, same-joint rotational siblings excluded, free-
    # joint translations included for its rotations; trans rows all-zero).
    dofdot_mask: jnp.ndarray  # (nv, nv)
    body_invweight0: jnp.ndarray  # (nbody, 2) [trans, rot] from MjModel
    impratio: jnp.ndarray  # ()


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PhysicsState:
    """Minimal carried state of the simulation (one env; batch via vmap)."""

    qpos: jnp.ndarray  # (nq,)
    qvel: jnp.ndarray  # (nv,)
    time: jnp.ndarray  # ()


def make_state(model: PhysicsModel, qpos=None, qvel=None, time=0.0) -> PhysicsState:
    """Fresh state at the model's reference pose."""
    dtype = model.qpos0.dtype
    return PhysicsState(
        qpos=jnp.asarray(qpos if qpos is not None else model.qpos0, dtype=dtype),
        qvel=jnp.asarray(qvel, dtype=dtype) if qvel is not None else jnp.zeros(model.nv, dtype=dtype),
        time=jnp.asarray(time, dtype=dtype),
    )


def _collision_pairs(m, pair_filter=None) -> Tuple[Tuple[int, int], ...]:
    """Enumerate candidate geom pairs using MuJoCo's filtering rules.

    Mirrors the contype/conaffinity + same-body/parent-child exclusion logic
    (dynamic broadphase is replaced by a static pair list + per-step distance
    masking, which is the static-shape-friendly formulation for XLA).
    """
    pairs = []
    nge = m.ngeom
    weld = m.body_weldid
    for g1 in range(nge):
        for g2 in range(g1 + 1, nge):
            b1, b2 = m.geom_bodyid[g1], m.geom_bodyid[g2]
            if weld[b1] == weld[b2]:
                continue
            # parent-child exclusion (unless the parent weld is the world)
            wp1 = weld[m.body_parentid[weld[b1]]]
            wp2 = weld[m.body_parentid[weld[b2]]]
            if (wp1 == weld[b2] and weld[b2] != 0) or (wp2 == weld[b1] and weld[b1] != 0):
                continue
            # contype/conaffinity compatibility
            if not (
                (m.geom_contype[g1] & m.geom_conaffinity[g2])
                or (m.geom_contype[g2] & m.geom_conaffinity[g1])
            ):
                continue
            if pair_filter is not None and not pair_filter(m, g1, g2):
                continue
            t1, t2 = int(m.geom_type[g1]), int(m.geom_type[g2])
            # order pairs canonically: smaller type code first (plane first etc.)
            if t1 <= t2:
                pairs.append((g1, g2))
            else:
                pairs.append((g2, g1))
    return tuple(pairs)


def put_model(
    m,
    dtype: Any = jnp.float32,
    solver_iterations: int | None = None,
    collision_pair_filter=None,
) -> PhysicsModel:
    """Lower a compiled ``mujoco.MjModel`` into a device ``PhysicsModel``.

    The analogue of the reference's per-rollout MjModel deep copies
    (judo/utils/mj_rollout_backend.py:38-43) — but one shared immutable device
    model serves every rollout via vmap instead of R host copies.

    solver_iterations overrides opt.iterations for the contact solver (planner
    models trade solver tightness for sequential depth).
    collision_pair_filter(m, g1, g2) -> bool optionally prunes candidate pairs
    beyond MuJoCo's rules — planner models drop contact sets that cannot
    influence the plan (e.g. robot self-collision) to cut the static contact
    budget.
    """
    import mujoco

    # HOST-side numpy leaves, not device arrays. Every model constant is
    # consumed at TRACE time (baked into the jitted step as an HLO constant),
    # so device residency buys nothing; numpy leaves embed as constants
    # instead of captured device buffers, shrinking the executable's implicit
    # per-call argument list.
    np_dtype = np.dtype(dtype)
    a = lambda x: np.asarray(np.asarray(x), dtype=np_dtype)  # noqa: E731

    nv = m.nv
    # dof ancestry mask from dof_parentid chains
    mask = np.zeros((nv, nv), dtype=np.float64)
    for i in range(nv):
        j = i
        while j >= 0:
            mask[i, j] = 1.0
            j = m.dof_parentid[j]

    # body -> supporting dof mask (dofs of the body and all its ancestors)
    body_dof = np.zeros((m.nbody, nv), dtype=np.float64)
    for b in range(m.nbody):
        bb = b
        while bb > 0:
            d0 = m.body_dofadr[bb]
            body_dof[b, d0 : d0 + m.body_dofnum[bb]] = 1.0
            bb = m.body_parentid[bb]

    # subtree mask from the parent chain
    subtree = np.eye(m.nbody, dtype=np.float64)
    for b in range(m.nbody - 1, 0, -1):
        p_ = m.body_parentid[b]
        subtree[p_] += subtree[b]
    subtree = np.minimum(subtree, 1.0)

    # cdof_dot contribution mask (see field docstring)
    dofdot = np.zeros((nv, nv), dtype=np.float64)
    jnt_of_dof = np.asarray(m.dof_jntid)
    for i in range(nv):
        jt = int(m.jnt_type[jnt_of_dof[i]])
        dadr = int(m.jnt_dofadr[jnt_of_dof[i]])
        if jt == FREE and i - dadr < 3:
            continue  # translational free dofs: cdof_dot = 0
        j = int(m.dof_parentid[i])
        while j >= 0:
            dofdot[i, j] = 1.0
            j = int(m.dof_parentid[j])
        if jt == BALL:
            # exclude same-joint siblings (all three rotate simultaneously)
            dofdot[i, dadr : dadr + 3] = 0.0
        elif jt == FREE:
            # rotations: include own translations, exclude rotation siblings
            dofdot[i, dadr + 3 : dadr + 6] = 0.0
            dofdot[i, dadr : dadr + 3] = 1.0

    disable = m.opt.disableflags
    contact_enabled = not (disable & mujoco.mjtDisableBit.mjDSBL_CONTACT)
    limit_enabled = not (disable & mujoco.mjtDisableBit.mjDSBL_LIMIT)
    gravity_enabled = not (disable & mujoco.mjtDisableBit.mjDSBL_GRAVITY)

    return PhysicsModel(
        nq=m.nq,
        nv=m.nv,
        nu=m.nu,
        nbody=m.nbody,
        njnt=m.njnt,
        ngeom=m.ngeom,
        nsite=m.nsite,
        nsensor=m.nsensor,
        nsensordata=m.nsensordata,
        integrator=int(m.opt.integrator),
        cone_pyramidal=int(m.opt.cone) == int(mujoco.mjtCone.mjCONE_PYRAMIDAL),
        contact_enabled=contact_enabled,
        limit_enabled=limit_enabled,
        gravity_enabled=gravity_enabled,
        solver_iterations=int(m.opt.iterations) if solver_iterations is None else int(solver_iterations),
        body_parentid=_t(m.body_parentid),
        body_rootid=_t(m.body_rootid),
        body_jntadr=_t(m.body_jntadr),
        body_jntnum=_t(m.body_jntnum),
        body_dofadr=_t(m.body_dofadr),
        body_dofnum=_t(m.body_dofnum),
        jnt_type=_t(m.jnt_type),
        jnt_qposadr=_t(m.jnt_qposadr),
        jnt_dofadr=_t(m.jnt_dofadr),
        jnt_bodyid=_t(m.jnt_bodyid),
        jnt_limited=_t(m.jnt_limited),
        jnt_actfrclimited=_t(m.jnt_actfrclimited),
        dof_bodyid=_t(m.dof_bodyid),
        dof_jntid=_t(m.dof_jntid),
        dof_parentid=_t(m.dof_parentid),
        geom_type=_t(m.geom_type),
        geom_bodyid=_t(m.geom_bodyid),
        geom_condim=_t(m.geom_condim),
        geom_priority=_t(m.geom_priority),
        site_bodyid=_t(m.site_bodyid),
        actuator_trnid=_t(m.actuator_trnid[:, 0]),
        sensor_type=_t(m.sensor_type),
        sensor_objtype=_t(m.sensor_objtype),
        sensor_objid=_t(m.sensor_objid),
        sensor_adr=_t(m.sensor_adr),
        sensor_dim=_t(m.sensor_dim),
        sensor_reftype=_t(m.sensor_reftype),
        sensor_refid=_t(m.sensor_refid),
        sensor_objname=tuple(
            mujoco.mj_id2name(m, int(m.sensor_objtype[i]), int(m.sensor_objid[i])) or ""
            for i in range(m.nsensor)
        ),
        neq=m.neq,
        eq_type=_t(m.eq_type),
        eq_obj1id=_t(m.eq_obj1id),
        eq_obj2id=_t(m.eq_obj2id),
        collision_pairs=_collision_pairs(m, collision_pair_filter),
        timestep=a(m.opt.timestep),
        gravity=a(m.opt.gravity),
        qpos0=a(m.qpos0),
        qpos_spring=a(m.qpos_spring),
        body_pos=a(m.body_pos),
        body_quat=a(m.body_quat),
        body_ipos=a(m.body_ipos),
        body_iquat=a(m.body_iquat),
        body_mass=a(m.body_mass),
        body_inertia=a(m.body_inertia),
        jnt_pos=a(m.jnt_pos),
        jnt_axis=a(m.jnt_axis),
        jnt_range=a(m.jnt_range),
        jnt_stiffness=a(m.jnt_stiffness),
        jnt_solref=a(m.jnt_solref),
        jnt_solimp=a(m.jnt_solimp),
        jnt_margin=a(m.jnt_margin),
        jnt_actfrcrange=a(m.jnt_actfrcrange),
        dof_damping=a(m.dof_damping),
        dof_armature=a(m.dof_armature),
        dof_frictionloss=a(m.dof_frictionloss),
        dof_invweight0=a(m.dof_invweight0),
        geom_pos=a(m.geom_pos),
        geom_quat=a(m.geom_quat),
        geom_size=a(m.geom_size),
        geom_friction=a(m.geom_friction),
        geom_solref=a(m.geom_solref),
        geom_solimp=a(m.geom_solimp),
        geom_solmix=a(m.geom_solmix),
        geom_margin=a(m.geom_margin),
        geom_gap=a(m.geom_gap),
        site_pos=a(m.site_pos),
        site_quat=a(m.site_quat),
        sensor_cutoff=a(m.sensor_cutoff),
        eq_data=a(m.eq_data),
        eq_solref=a(m.eq_solref),
        eq_solimp=a(m.eq_solimp),
        actuator_gear=a(m.actuator_gear),
        actuator_gainprm=a(m.actuator_gainprm),
        actuator_biasprm=a(m.actuator_biasprm),
        actuator_ctrlrange=a(m.actuator_ctrlrange),
        actuator_forcerange=a(m.actuator_forcerange),
        actuator_ctrllimited=np.asarray(m.actuator_ctrllimited, dtype=bool),
        actuator_forcelimited=np.asarray(m.actuator_forcelimited, dtype=bool),
        dof_ancestor_mask=a(mask),
        body_dof_mask=a(body_dof),
        subtree_mask=a(subtree),
        dofdot_mask=a(dofdot),
        body_invweight0=a(m.body_invweight0),
        impratio=a(m.opt.impratio),
    )
