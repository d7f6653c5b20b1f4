"""Forward dynamics + integration: the jitted step and rollout entry points.

step() is the batched-engine equivalent of one ``mj_step``; rollout() is the
equivalent of the reference's threaded batch rollout
(judo/utils/mj_rollout_backend.py:84: R threads x T steps each) expressed as
``vmap(scan(step))`` — the batch dimension maps onto vector lanes / the device
mesh instead of CPU threads.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from judo_tpu.ops.math import quat_integrate
from judo_tpu.physics.model import BALL, FREE, HINGE, INT_IMPLICITFAST, SLIDE, PhysicsModel, PhysicsState
from judo_tpu.physics import smooth
from judo_tpu.physics.sensors import evaluate_sensors


class ForwardResult(NamedTuple):
    qacc: jnp.ndarray  # (nv,)
    qfrc_smooth: jnp.ndarray  # (nv,) all smooth forces (actuation+passive-bias)
    mass_matrix: jnp.ndarray  # (nv, nv)
    kin: smooth.Kinematics
    sensordata: jnp.ndarray  # (nsensordata,)
    efc_force: jnp.ndarray  # (nefc,) constraint forces (warm-start carry)
    minv: jnp.ndarray  # (nv, nv) inverse mass matrix (temporal-warm-start carry)


def _ns_refresh(a: jnp.ndarray, x: jnp.ndarray, iters: int = 3) -> jnp.ndarray:
    """Newton-Schulz refresh of an approximate inverse ``x`` of SPD ``a``.

    X <- X (2I - A X), symmetrized. Quadratically convergent: with X the
    previous physics step's exact inverse and A drifting by O(h) per step
    (the mass matrix depends only on qpos), three iterations restore the
    inverse to machine precision. This replaces the per-step sequential
    Gauss-Jordan elimination (nv dependent rank-1 columns) with 6 batched
    matmuls — the batched formulation of MuJoCo's per-MjData factorization
    reuse.

    Divergence guard: NS diverges explosively (residual^(2^iters)) when the
    seed's residual ||I - A X|| reaches 1 — possible after an impact-scale
    state jump between steps. The initial residual is measured (reusing the
    first iteration's A @ X product) and divergent lanes keep the *frozen*
    previous inverse instead: bounded error for a few steps, never NaNs.
    The periodic exact re-seed in rollout() (reseed_every) then restores the
    chain exactly.
    """
    eye = jnp.eye(a.shape[-1], dtype=a.dtype)
    t = a @ x
    r0 = jnp.max(jnp.abs(eye - t), axis=(-2, -1), keepdims=True)
    x0 = x
    for i in range(iters):
        if i > 0:
            t = a @ x
        x = x @ (2.0 * eye - t)
        x = 0.5 * (x + x.swapaxes(-1, -2))
    return jnp.where(r0 < 1.0, x, x0)


def forward(
    m: PhysicsModel,
    s: PhysicsState,
    ctrl: jnp.ndarray,
    f_warm: jnp.ndarray | None = None,
    minv_warm: jnp.ndarray | None = None,
) -> ForwardResult:
    """Full forward dynamics at the current state (mj_forward semantics).

    ``f_warm`` optionally warm-starts the constraint solver from the previous
    step's efc forces (MuJoCo's warm-start semantics, carried explicitly
    through the rollout scan instead of mutated in MjData).

    ``minv_warm`` optionally carries the previous step's inverse mass matrix;
    when given, M^-1 is Newton-Schulz-refreshed from it instead of recomputed
    by elimination (see _ns_refresh).
    """
    kin = smooth.kinematics(m, s)
    com = smooth.com_quantities(m, kin)
    vel = smooth.velocity(m, com, s.qvel)
    mm = smooth.crb_mass_matrix(m, com)
    qfrc_bias = smooth.rne_bias(m, com, vel, s.qvel)
    qfrc_passive = smooth.passive_force(m, s)
    qfrc_actuator = smooth.actuation(m, s, ctrl)
    qfrc_smooth = qfrc_actuator + qfrc_passive - qfrc_bias

    from judo_tpu.physics import linalg

    from judo_tpu.physics import collision, solver

    # One explicit inverse serves both the smooth acceleration and the contact
    # solver's Delassus operator (see linalg.py for why substitutions/scatters
    # are avoided). Inside a rollout the inverse is carried
    # across steps and Newton-Schulz-refreshed; cold calls eliminate exactly.
    if minv_warm is None:
        minv = linalg.spd_inverse(mm)
    else:
        minv = _ns_refresh(mm, minv_warm)
    qacc_smooth = minv @ qfrc_smooth

    has_contacts = m.contact_enabled and collision.num_contact_slots(m) > 0
    if solver.num_constraint_rows(m) > 0:
        contacts = (
            collision.find_contacts(m, kin) if has_contacts else collision.empty_contacts(s.qpos.dtype)
        )
        qacc, efc_force = solver.solve_contacts(
            m, com, kin, contacts, mm, minv, s.qpos, s.qvel, qacc_smooth, f_warm
        )
    else:
        qacc = qacc_smooth
        efc_force = jnp.zeros(0, s.qpos.dtype)

    sensordata = evaluate_sensors(m, kin, s.qpos, s.qvel)
    return ForwardResult(qacc, qfrc_smooth, mm, kin, sensordata, efc_force, minv)


def _integrate_pos(m: PhysicsModel, qpos: jnp.ndarray, qvel: jnp.ndarray, h) -> jnp.ndarray:
    """mj_integratePos semantics: joint-type-aware position update.

    Scatter-free: qpos is contiguous per joint in a static layout, so the new
    vector is assembled from per-joint static slices and one concatenate
    instead of indexed ``.at[].set`` updates inside the scan.
    """
    segs: list[jnp.ndarray] = []
    cursor = 0
    for j in range(m.njnt):
        jt = m.jnt_type[j]
        qadr, dadr = m.jnt_qposadr[j], m.jnt_dofadr[j]
        assert qadr == cursor, "qpos layout must be joint-contiguous"
        if jt in (SLIDE, HINGE):
            segs.append(qpos[qadr : qadr + 1] + h * qvel[dadr : dadr + 1])
            cursor += 1
        elif jt == BALL:
            segs.append(quat_integrate(qpos[qadr : qadr + 4], qvel[dadr : dadr + 3], h))
            cursor += 4
        elif jt == FREE:
            segs.append(qpos[qadr : qadr + 3] + h * qvel[dadr : dadr + 3])
            segs.append(quat_integrate(qpos[qadr + 3 : qadr + 7], qvel[dadr + 3 : dadr + 6], h))
            cursor += 7
    if cursor < m.nq:  # trailing non-joint qpos (none in practice)
        segs.append(qpos[cursor:])
    if not segs:
        return qpos
    return jnp.concatenate(segs)


def implicit_damping(m: PhysicsModel) -> jnp.ndarray:
    """Per-dof implicit damping diagonal (a model constant).

    - Euler (MuJoCo default): joint damping only.
    - implicitfast: additionally folds actuator velocity-bias derivatives
      (position-actuator kv, biasprm[2]) into the implicit matrix — the terms
      MuJoCo's mj_implicitSkip keeps after dropping the RNE derivative.
    """
    damp = m.dof_damping
    if m.integrator == INT_IMPLICITFAST:
        act_kv = jnp.zeros(m.nv, damp.dtype)
        for u in range(m.nu):
            j = m.actuator_trnid[u]
            dadr = m.jnt_dofadr[j]
            gear = m.actuator_gear[u, 0]
            act_kv = act_kv.at[dadr].add(-m.actuator_biasprm[u, 2] * gear * gear)
        damp = damp + act_kv
    return damp


def step_with_forward(
    m: PhysicsModel,
    s: PhysicsState,
    ctrl: jnp.ndarray,
    f_warm: jnp.ndarray | None = None,
    minv_warm: jnp.ndarray | None = None,
    mhinv_warm: jnp.ndarray | None = None,
) -> tuple[PhysicsState, ForwardResult, jnp.ndarray]:
    """One physics step; also returns the forward intermediates and the
    implicit-matrix inverse (M + h diag(damp))^-1 for temporal warm-starting.

    Implicit-in-velocity damping: (M + h*diag(damp)) (v' - v) = h M qacc,
    with damp from implicit_damping(). Like M^-1 in forward(), the implicit
    inverse is Newton-Schulz-refreshed from the previous step's value when
    carried through a rollout scan.
    """
    h = m.timestep
    res = forward(m, s, ctrl, f_warm, minv_warm)

    from judo_tpu.physics import linalg

    mh = res.mass_matrix + h * jnp.diag(implicit_damping(m))
    if mhinv_warm is None:
        mhinv = linalg.spd_inverse(mh)
    else:
        mhinv = _ns_refresh(mh, mhinv_warm)
    dv = mhinv @ (h * (res.mass_matrix @ res.qacc))
    qvel_new = s.qvel + dv

    qpos_new = _integrate_pos(m, s.qpos, qvel_new, h)
    return PhysicsState(qpos=qpos_new, qvel=qvel_new, time=s.time + h), res, mhinv


def step(m: PhysicsModel, s: PhysicsState, ctrl: jnp.ndarray) -> PhysicsState:
    """One physics step (mj_step semantics), cold (exact-elimination) inverses."""
    return step_with_forward(m, s, ctrl)[0]


def seed_inverses(m: PhysicsModel, s: PhysicsState) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Exact (M^-1, (M + h diag(damp))^-1) at state ``s``.

    Seeds (and periodically re-seeds) the Newton-Schulz temporal warm-start
    chain carried through rollout scans — shared by rollout() and the Spot
    policy_rollout() so the two paths cannot drift apart.
    """
    from judo_tpu.physics import linalg

    kin = smooth.kinematics(m, s)
    com = smooth.com_quantities(m, kin)
    mm = smooth.crb_mass_matrix(m, com)
    minv = linalg.spd_inverse(mm)
    mhinv = linalg.spd_inverse(mm + m.timestep * jnp.diag(implicit_damping(m)))
    return minv, mhinv


class RolloutOutput(NamedTuple):
    states: jnp.ndarray  # (T, nq + nv)
    sensordata: jnp.ndarray  # (T, nsensordata)


def default_unroll(m: PhysicsModel) -> int:
    """Scan-unroll heuristic: unrolling amortizes per-step loop overhead on
    small scenes but multiplies graph size and compile time — contact-rich
    scenes stay at 1."""
    from judo_tpu.physics.collision import num_contact_slots

    return 5 if num_contact_slots(m) <= 16 else 1


def rollout(
    m: PhysicsModel,
    s0: PhysicsState,
    controls: jnp.ndarray,
    physics_substeps: int = 1,
    unroll: int | None = None,
    reseed_every: int = 10,
) -> RolloutOutput:
    """Roll out a control sequence from one initial state.

    controls: (T, nu) — each control is held for ``physics_substeps`` physics
    steps (the reference's Spot pipeline runs 2 physics steps per command —
    judo/tasks/spot/spot_base.py:114-117).

    Recording convention matches ``mujoco.rollout`` (and the C++
    System::rollout, system_class.cpp:272-331): after each command's steps we
    record the post-step (qpos, qvel) and the sensordata evaluated during the
    final step's forward pass (i.e. at that step's *pre-integration* state).

    ``reseed_every``: the Newton-Schulz-carried mass-matrix inverses are
    re-seeded *exactly* (full elimination) every this-many commands — a nested
    scan(blocks) x scan(steps) structure, so the exact factorization's cost is
    amortized over the block while NS drift/divergence stays bounded to one
    block even after impact-scale state jumps (see _ns_refresh's guard).

    Batch over rollouts with ``jax.vmap(rollout, in_axes=(None, 0, 0))``.
    """

    from judo_tpu.physics.solver import num_constraint_rows

    nefc = num_constraint_rows(m)

    def body(carry, ctrl: jnp.ndarray):
        s, f, minv, mhinv = carry
        res = None
        for _ in range(physics_substeps):
            s, res, mhinv = step_with_forward(m, s, ctrl, f, minv, mhinv)
            minv = res.minv
            if res.efc_force.shape[0] == nefc:
                f = res.efc_force
        return (s, f, minv, mhinv), (jnp.concatenate([s.qpos, s.qvel]), res.sensordata)

    if unroll is None:
        unroll = default_unroll(m)
    f0 = jnp.zeros(nefc, s0.qpos.dtype)

    T = controls.shape[0]
    K = max(1, min(int(reseed_every), T))
    n_blocks = -(-T // K)
    Tp = n_blocks * K
    if Tp != T:  # pad with the last control; outputs are sliced back to T
        controls = jnp.concatenate([controls, jnp.repeat(controls[-1:], Tp - T, axis=0)], axis=0)
    blocks = controls.reshape(n_blocks, K, controls.shape[-1])

    def block(carry, ctrl_block: jnp.ndarray):
        s, f = carry
        minv, mhinv = seed_inverses(m, s)
        (s, f, _, _), outs = jax.lax.scan(
            body, (s, f, minv, mhinv), ctrl_block, unroll=min(unroll, K)
        )
        return (s, f), outs

    (_, _), (states, sensors) = jax.lax.scan(block, (s0, f0), blocks)
    states = states.reshape(Tp, *states.shape[2:])[:T]
    sensors = sensors.reshape(Tp, *sensors.shape[2:])[:T]
    return RolloutOutput(states, sensors)
