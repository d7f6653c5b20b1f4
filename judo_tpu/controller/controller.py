"""The planner core: a pure jitted solve function + a host Controller wrapper.

The reference's ``Controller.update_action`` (judo/controller/controller.py:210-299)
mutates numpy state while looping sample -> rollout -> reward -> update. Here
that whole loop is ONE pure function of an explicit ``SolverState`` pytree —
jitted once per shape signature, vmapped over the rollout batch, and ready to
shard over a device mesh (see judo_tpu.parallel). The host ``Controller`` class
keeps the reference's API (update_action / action(t) / reset / spline_data /
update_states) for the sim/GUI processes.

Shape-affecting GUI knobs (num_rollouts, num_nodes, horizon, spline order,
normalizer kind) re-specialize the compiled solve — the static-shape answer to
the reference's live backend resizing (controller.py:225-228). Value knobs
(sigma, temperature, reward weights, goal positions) flow through parameter
pytrees with zero recompilation.
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Any, Literal, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from scipy.interpolate import interp1d

from judo_tpu.config import OverridableConfig
from judo_tpu.gui import slider
from judo_tpu.ops.splines import eval_spline
from judo_tpu.optimizers import Optimizer, OptimizerConfig, get_registered_optimizers
from judo_tpu.physics import make_state, rollout
from judo_tpu.physics.model import SENSOR_FRAMEPOS
from judo_tpu.tasks import Task, TaskConfig, get_registered_tasks
from judo_tpu.utils import normalization as norm


@slider("horizon", 0.1, 10.0, bounded=True)
@slider("control_freq", 0.25, 50.0)
@dataclass
class ControllerConfig(OverridableConfig):
    """Base controller config (reference parity: controller.py:31-42)."""

    horizon: float = 1.0
    spline_order: Literal["zero", "linear", "cubic"] = "linear"
    control_freq: float = 20.0
    max_opt_iters: int = 1
    max_num_traces: int = 5
    action_normalizer: Literal["none", "min_max", "running"] = "none"
    # APGD budget for the lanes physics path (None = the model's own solver
    # iterations). The preconditioned CW-bounded solver tracks a converged
    # reference to ~2e-5 at 8 warm-started iterations on the leap scene, and
    # cold starts converge cleanly too
    # (tests/test_physics/test_solver_quality.py) — 8 is the shipping budget.
    solver_iterations: int | None = 8
    # >0: pipeline the solve — update_action dispatches the new solve before
    # syncing the previous one's outputs (host mirrors lag by `depth` solves;
    # the on-device carry chains without host sync, so the optimization state
    # is never stale). Hides dispatch latency; steady-state per-solve wall
    # time approaches pure device compute.
    pipeline_depth: int = 0
    # return the full per-rollout tensors (states/sensors/controls/knots) from
    # the jitted solve. Default False: everything the host needs rides the
    # packed mirror, so the solve does not materialize per-rollout outputs the
    # host never reads. Forced on when the task overrides post_rollout (which
    # receives those tensors).
    full_outputs: bool = False


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SolverState:
    """Carried planner state: everything the reference mutates in place."""

    times: jnp.ndarray  # (N,) knot times
    nominal_knots: jnp.ndarray  # (N, nu)
    opt_state: Any  # optimizer-specific (CEM sigma, ...)
    norm_state: Any  # running-normalizer statistics
    rng: jax.Array  # PRNG key
    # locomotion-policy tasks carry the last policy output per rollout
    # (reference: controller.py:86-88, _last_policy_output); () otherwise
    last_policy_output: Any = ()
    # lanes backends carry the previous solve's step-0 constraint forces per
    # rollout (R, nefc): warm-starts contact ONSET (the plant moved one
    # control cycle) — the analogue of mjData's efc warm-start persisting
    # across the reference's per-thread rollouts; () otherwise
    efc_warm: Any = ()

    def replace(self, **changes) -> SolverState:
        return dataclasses.replace(self, **changes)


class SolveOutputs(NamedTuple):
    rewards: jnp.ndarray  # (R,)
    # the big per-rollout tensors are None unless ControllerConfig
    # .full_outputs (or a post_rollout override) asks for them — see the
    # config field's comment
    states: jnp.ndarray | None  # (R, T, nq + nv)
    sensors: jnp.ndarray | None  # (R, T, nsensordata)
    rollout_controls: jnp.ndarray | None  # (R, T, nu)
    candidate_knots: jnp.ndarray | None  # (R, N, nu)
    traces: jnp.ndarray | None  # (num_elites, num_trace_sensors, T-1, 2, 3)
    # flat [times | knots | rewards | traces] — everything the host mirrors
    # need, packed device-side so the per-solve device->host sync is ONE
    # transfer
    mirror: jnp.ndarray


def get_trace_sensor_ids(model) -> list[int]:
    """Framepos sensors whose name contains 'trace' (visualizers/utils.py:169-190).

    ``model`` is a ``mujoco.MjModel`` or a ``tasks.exported.HostModel``."""
    return [
        i
        for i in range(model.nsensor)
        if model.sensor_type[i] == SENSOR_FRAMEPOS and "trace" in model.sensor(i).name
    ]


# Rollout backends a caller may name; "judo_tpu" is an alias of "auto".
ROLLOUT_BACKENDS = ("auto", "judo_tpu", "vmap", "lanes_xla")


class Controller:
    """Host-side controller with the reference API, backed by the jitted solve."""

    def __init__(
        self,
        controller_config: ControllerConfig,
        task: Task,
        optimizer: Optimizer,
        rollout_backend: Literal["auto", "judo_tpu", "vmap", "lanes_xla"] = "auto",
        mesh=None,
    ) -> None:
        self._controller_cfg = controller_config
        self.task = task
        self.optimizer = optimizer
        self.rollout_backend = rollout_backend
        self.mesh = mesh  # optional jax.sharding.Mesh: shard rollouts over it
        self.model = task.model
        self.pm = task.planning_model
        self.dtype = self.pm.qpos0.dtype

        self.available_optimizers = get_registered_optimizers()
        self.available_tasks = get_registered_tasks()

        self.system_metadata: dict[str, Any] = {}
        self.current_state = np.concatenate([task.data.qpos, task.data.qvel])

        self.trace_sensors = get_trace_sensor_ids(self.model)
        self.trace_inds = [
            int(self.model.sensor_adr[i]) + k for i in self.trace_sensors for k in range(3)
        ]

        self._solve_cache: dict[tuple, Any] = {}
        self._args_cache: dict[str, Any] = {}
        self._pending: list = []  # in-flight solves (pipeline_depth > 0)
        self._consume_futures: list = []
        import threading
        from concurrent.futures import ThreadPoolExecutor

        self._consumer = ThreadPoolExecutor(max_workers=1, thread_name_prefix="judo-consume")
        self._mirror_lock = threading.Lock()
        self.last_plan_timing: dict[str, float] | None = None
        self.last_outputs: SolveOutputs | None = None
        self.traces: np.ndarray | None = None
        self.rewards = np.zeros(self.optimizer_cfg.num_rollouts)
        self.reset()

    # --- config plumbing (reference API parity) ---
    @property
    def controller_cfg(self) -> ControllerConfig:
        return self._controller_cfg

    @controller_cfg.setter
    def controller_cfg(self, cfg: ControllerConfig) -> None:
        self._controller_cfg = cfg

    @property
    def optimizer_cfg(self) -> OptimizerConfig:
        return self.optimizer.config

    @optimizer_cfg.setter
    def optimizer_cfg(self, cfg: OptimizerConfig) -> None:
        self.optimizer.config = cfg

    @property
    def task_config(self) -> TaskConfig:
        return self.task.config

    @task_config.setter
    def task_config(self, cfg: TaskConfig) -> None:
        self.task.config = cfg

    @property
    def horizon(self) -> float:
        return self.controller_cfg.horizon

    @property
    def nu(self) -> int:
        return self.task.nu

    @property
    def spline_order(self) -> str:
        return self.controller_cfg.spline_order

    @property
    def max_opt_iters(self) -> int:
        return self.controller_cfg.max_opt_iters

    @property
    def max_num_traces(self) -> int:
        return self.controller_cfg.max_num_traces

    @property
    def num_timesteps(self) -> int:
        """Rollout length, bucketed UP to a multiple of 4 steps.

        Bucketing quantizes the compiled-solve shape so a GUI horizon-slider
        drag recompiles at most once per 4-step bucket instead of once per dt
        (SURVEY §7: cache compiled solvers per bucketed shape). The planner
        rolls out to the bucket edge — up to 3*dt beyond the requested
        horizon, same direction as the reference's own ceil()
        (judo/controller/controller.py:144-147)."""
        # -1e-9: guard against float wobble (0.84/0.04 -> 21.000000000000004)
        T = int(np.ceil(self.horizon / self.task.dt - 1e-9))
        return 4 * int(np.ceil(T / 4))

    @property
    def rollout_times(self) -> np.ndarray:
        return self.task.dt * np.arange(self.num_timesteps)

    @property
    def spline_timesteps(self) -> np.ndarray:
        return np.linspace(0.0, self.horizon, self.optimizer_cfg.num_nodes, endpoint=True)

    @property
    def time(self) -> float:
        return self.task.time

    @time.setter
    def time(self, value: float) -> None:
        self.task.time = value

    @property
    def spline_data(self):
        """(times, knots, order) triple for publishing to the sim process."""
        from judo_tpu.app.structs import SplineData

        with self._mirror_lock:
            return SplineData(t=self.times, x=self.nominal_knots, kind=self.spline_order)

    # --- shape signature / compiled solve management ---
    def _enforce_cubic_min_nodes(self) -> None:
        if self.optimizer_cfg.num_nodes < 4 and self.spline_order == "cubic":
            warnings.warn("Cubic splines require at least 4 nodes. Setting num_nodes=4.", stacklevel=2)
            self.optimizer_cfg.num_nodes = 4

    def _resolve_rollout_backend(self) -> str:
        """Pick the rollout implementation for the jitted solve.

        - ``lanes_xla``: the batch-last lanes formulation
          (lane_rollout.rollout_lanes / policy_rollout_lanes) under jit;
          refuses models whose geometry or equalities it does not cover.
        - ``vmap``: vmap(step.rollout) / vmap(policy.policy_rollout) over
          per-state code.

        ``auto`` takes ``vmap`` on every platform. On the H200 ``lanes_xla``
        plans faster in both benchmark tasks, but it departs from mj_step on
        the leap_cube scene once contacts start (PERF.md, Findings), so it
        stays opt-in until that is fixed. The reference's analogous switch
        is backend auto-selection on task.uses_locomotion_policy
        (judo/controller/controller.py:73-85).
        """
        choice = self.rollout_backend
        if choice not in ROLLOUT_BACKENDS:
            raise ValueError(
                f"unknown rollout_backend {choice!r}; choose one of {ROLLOUT_BACKENDS}"
            )
        if choice in ("auto", "judo_tpu"):
            return "vmap"
        if choice == "lanes_xla":
            from judo_tpu.physics.lane_rollout import lane_supported

            if not lane_supported(self.pm):
                raise ValueError(
                    f"rollout_backend 'lanes_xla' does not cover {self.task.name}'s "
                    "geometry or equality types; use 'vmap'"
                )
        return choice

    def _signature(self) -> tuple:
        oc = self.optimizer_cfg
        cc = self.controller_cfg
        extra = tuple(
            sorted(
                (f, getattr(oc, f))
                for f in ("num_elites",)
                if hasattr(oc, f)
            )
        )
        return (
            type(self.optimizer).__name__,
            bool(self.optimizer.stop_cond()),
            oc.num_rollouts,
            oc.num_nodes,
            bool(oc.use_noise_ramp),
            cc.spline_order,
            # horizon enters as the BUCKETED rollout length (knot/rollout
            # times are runtime args), so slider drags hit the solve cache
            self.num_timesteps,
            int(cc.max_opt_iters),
            cc.action_normalizer,
            min(cc.max_num_traces, oc.num_rollouts),
            self._resolve_rollout_backend(),
            # remaining trace-time captured values, so LRU-cached closures can
            # never go stale when a knob cycles A->B->A with these changed
            cc.solver_iterations,
            bool(cc.full_outputs),
            int(self.task.physics_substeps),
            bool(self.task.uses_locomotion_policy),
            hash(np.asarray(self.task.actuator_ctrlrange).tobytes()),
            extra,
        )

    def _build_solve(self):
        """Specialize + jit the pure solve for the current shape signature."""
        task = self.task
        optimizer = self.optimizer
        pm = self.pm
        dtype = self.dtype
        order = self.spline_order
        num_nodes = self.optimizer_cfg.num_nodes
        max_opt_iters = self.max_opt_iters
        kind = self.controller_cfg.action_normalizer
        if kind not in norm.normalizer_registry:
            warnings.warn(
                f"Invalid action normalizer type '{kind}'. Available: "
                f"{list(norm.normalizer_registry)}. Falling back to 'none'.",
                stacklevel=2,
            )
            kind = "none"
        substeps = task.physics_substeps
        solver_iters = self.controller_cfg.solver_iterations
        uses_policy = task.uses_locomotion_policy
        lanes = self._resolve_rollout_backend() == "lanes_xla"
        spot_policy = getattr(task, "policy", None) if uses_policy else None
        ctrl_lo = jnp.asarray(task.actuator_ctrlrange[:, 0], dtype)
        ctrl_hi = jnp.asarray(task.actuator_ctrlrange[:, 1], dtype)
        num_trace_elites = min(self.max_num_traces, self.optimizer_cfg.num_rollouts)
        trace_inds = jnp.asarray(self.trace_inds, dtype=jnp.int32)
        n_trace = len(self.trace_sensors)
        need_full = bool(self.controller_cfg.full_outputs) or (
            type(task).post_rollout is not Task.post_rollout
        )
        mesh = self.mesh
        if mesh is not None:
            from judo_tpu.parallel.mesh import rollout_sharding

            batch_sharding = rollout_sharding(mesh)

            def shard_batch(x):
                return jax.lax.with_sharding_constraint(x, batch_sharding)
        else:

            def shard_batch(x):
                return x

        def solve(
            carry: SolverState,
            current_state: jnp.ndarray,
            time: jnp.ndarray,
            task_params: dict,
            opt_params: Any,
            norm_params: dict,
            metadata: dict,
            spline_ts: jnp.ndarray,  # (N,) knot offsets — runtime so equal-shape horizons share one compile
            rollout_ts: jnp.ndarray,  # (T,) rollout time offsets
        ) -> tuple[SolverState, SolveOutputs]:
            new_times = time + spline_ts
            # resample the nominal spline at the shifted knot times (:219-221)
            nominal = eval_spline(carry.times, carry.nominal_knots, new_times, order)
            nominal_n = norm.normalize(kind, norm_params, carry.norm_state, nominal)

            opt_state = optimizer.pre_optimization(opt_params, carry.opt_state, carry.times, new_times)
            norm_state = carry.norm_state
            rng = carry.rng

            x0 = make_state(pm, qpos=current_state[: pm.nq], qvel=current_state[pm.nq :], time=time)

            candidates = None
            states = sensors = rollout_controls = rewards = None
            # stop_cond is static (trace-time) like the reference's per-iter
            # check (judo/controller/controller.py:250, optimizers/base.py:87-96):
            # a True stop_cond truncates the unrolled optimization loop.
            effective_iters = 1 if optimizer.stop_cond() else max_opt_iters
            for _ in range(effective_iters):
                rng, sub = jax.random.split(rng)
                # sample + clip to normalized ctrlrange (:251-257)
                cand_n, opt_state = optimizer.sample(opt_params, opt_state, nominal_n, sub)
                lo = norm.normalize(kind, norm_params, norm_state, ctrl_lo)
                hi = norm.normalize(kind, norm_params, norm_state, ctrl_hi)
                cand_n = jnp.clip(cand_n, lo, hi)
                # shard the candidate batch over the device mesh; everything
                # downstream (spline eval, physics, rewards) inherits the
                # partitioning and reductions become cross-device collectives
                cand_n = shard_batch(cand_n)
                candidates = norm.denormalize(kind, norm_params, norm_state, cand_n)

                # candidate knot splines evaluated at rollout times (:261-262)
                rollout_controls = eval_spline(new_times, candidates, time + rollout_ts, order)

                # roll out dynamics (:267-271): vmap over the candidate batch
                sim_controls = task.task_to_sim_ctrl(rollout_controls)
                if uses_policy and lanes:
                    # policy-in-the-loop lanes rollout: obs -> MLP -> ctrl ->
                    # substeps physics per scan step — the answer to the
                    # reference's System::rollout C++ threads + 125 ms cutoff
                    # watchdog (system_class.cpp:272-331).
                    from judo_tpu.physics.lane_rollout import policy_rollout_lanes

                    R_ = sim_controls.shape[0]
                    qp0 = jnp.broadcast_to(x0.qpos, (R_, pm.nq))
                    qv0 = jnp.broadcast_to(x0.qvel, (R_, pm.nv))

                    def policy_lanes_rollout(qp, qv, ct, po):
                        out = policy_rollout_lanes(
                            pm, spot_policy, qp, qv, ct, po,
                            physics_substeps=substeps, iterations=solver_iters,
                        )
                        return out.states, out.sensordata, out.final_policy_output

                    if mesh is not None and mesh.devices.size > 1:
                        # per-shard rollout, same scheme as the plain lanes
                        # branch below (candidate batch over the mesh)
                        from jax.sharding import PartitionSpec as P

                        ndev = mesh.devices.size
                        assert R_ % ndev == 0, (
                            f"num_rollouts {R_} must divide over the "
                            f"{ndev}-device mesh for the lanes backend"
                        )
                        bspec = P(tuple(mesh.axis_names))
                        states, sensors, new_policy_output = jax.shard_map(
                            policy_lanes_rollout,
                            mesh=mesh,
                            in_specs=(bspec, bspec, bspec, bspec),
                            out_specs=(bspec, bspec, bspec),
                            check_vma=False,
                        )(qp0, qv0, sim_controls, carry.last_policy_output)
                    else:
                        states, sensors, new_policy_output = policy_lanes_rollout(
                            qp0, qv0, sim_controls, carry.last_policy_output
                        )
                    new_efc_warm = carry.efc_warm
                elif uses_policy:
                    from judo_tpu.tasks.spot.policy import policy_rollout

                    pout = carry.last_policy_output
                    out = jax.vmap(
                        lambda c, p: policy_rollout(pm, spot_policy, x0, c, p, substeps)
                    )(sim_controls, pout)
                    states, sensors = out.states, out.sensordata
                    new_policy_output = out.final_policy_output
                    new_efc_warm = carry.efc_warm
                elif lanes:
                    from judo_tpu.physics.lane_rollout import rollout_lanes

                    R_ = sim_controls.shape[0]
                    qp0 = jnp.broadcast_to(x0.qpos, (R_, pm.nq))
                    qv0 = jnp.broadcast_to(x0.qvel, (R_, pm.nv))

                    def lanes_rollout(qp, qv, ct, fw):
                        out = rollout_lanes(
                            pm, qp, qv, ct,
                            physics_substeps=substeps,
                            iterations=solver_iters, efc_warm=fw,
                        )
                        return out.states, out.sensordata, out.efc0

                    if mesh is not None and mesh.devices.size > 1:
                        # candidate batch sharded over the mesh; each device
                        # runs the lanes rollout on its LOCAL shard. This is
                        # the device form of the reference's rollout-batch
                        # thread parallelism (judo/utils/mj_rollout_backend.py
                        # :32-88) — embarrassingly parallel, no collectives
                        # inside; reward reductions downstream ride GSPMD.
                        from jax.sharding import PartitionSpec as P

                        ndev = mesh.devices.size
                        assert R_ % ndev == 0, (
                            f"num_rollouts {R_} must divide over the "
                            f"{ndev}-device mesh for the lanes backend"
                        )
                        bspec = P(tuple(mesh.axis_names))
                        states, sensors, new_efc_warm = jax.shard_map(
                            lanes_rollout,
                            mesh=mesh,
                            in_specs=(bspec, bspec, bspec, bspec),
                            out_specs=(bspec, bspec, bspec),
                            # no collectives inside; skip the varying-axes
                            # check (the scan's zero-init efc carry is
                            # device-invariant by construction)
                            check_vma=False,
                        )(qp0, qv0, sim_controls, carry.efc_warm)
                    else:
                        states, sensors, new_efc_warm = lanes_rollout(
                            qp0, qv0, sim_controls, carry.efc_warm
                        )
                    new_policy_output = carry.last_policy_output
                else:
                    out = jax.vmap(lambda c: rollout(pm, x0, c, physics_substeps=substeps))(sim_controls)
                    states, sensors = out.states, out.sensordata
                    new_policy_output = carry.last_policy_output
                    new_efc_warm = carry.efc_warm

                rewards = task.reward(states, sensors, rollout_controls, task_params, metadata)
                nominal_n, opt_state = optimizer.update(opt_params, opt_state, cand_n, rewards)
                norm_state = norm.update_normalizer(kind, norm_params, norm_state, candidates)

            new_nominal = norm.denormalize(kind, norm_params, norm_state, nominal_n)

            # elite trace packing (controller.py:323-363), device-side
            if n_trace > 0 and num_trace_elites > 0:
                _, elite_idx = jax.lax.top_k(rewards, num_trace_elites)
                tr = sensors[elite_idx][:, :, trace_inds]  # (k, T, 3*ns)
                k_, t_ = tr.shape[0], tr.shape[1]
                tr = tr.reshape(k_, t_, n_trace, 3).swapaxes(1, 2)  # (k, ns, T, 3)
                traces = jnp.stack([tr[:, :, :-1], tr[:, :, 1:]], axis=3)  # (k, ns, T-1, 2, 3)
            else:
                traces = jnp.zeros((0, 0, 0, 2, 3), dtype)

            new_carry = SolverState(
                times=new_times,
                nominal_knots=new_nominal,
                opt_state=opt_state,
                norm_state=norm_state,
                rng=rng,
                last_policy_output=new_policy_output,
                efc_warm=new_efc_warm,
            )
            mirror = jnp.concatenate(
                [new_times.ravel(), new_nominal.ravel(), rewards.ravel(), traces.ravel()]
            )
            if need_full:
                outputs = SolveOutputs(
                    rewards, states, sensors, rollout_controls, candidates, traces, mirror
                )
            else:
                # slim return: the mirror carries everything the host reads
                outputs = SolveOutputs(rewards, None, None, None, None, None, mirror)
            return new_carry, outputs

        # float32 matmuls pinned to full precision. JAX's default lets the
        # GPU run them in TF32, which on the H200 moved leap_cube rollouts by
        # a median 0.14 in qpos over 100 steps (the same candidates batched
        # two ways; 1.4e-5 pinned). The pin costs ~1.5% of plan time
        # (PERF.md, Findings).
        def solve_at_precision(*args):
            with jax.default_matmul_precision("highest"):
                return solve(*args)

        return jax.jit(solve_at_precision)

    _SOLVE_CACHE_MAX = 16

    def _get_solve(self):
        """Compiled-solve LRU cache: one entry per shape signature, so
        toggling a GUI knob back to a previous value never re-pays the
        compile (SURVEY §7 recompile-management stance)."""
        sig = self._signature()
        fn = self._solve_cache.get(sig)
        if fn is None:
            fn = self._build_solve()
            self._solve_cache[sig] = fn
            while len(self._solve_cache) > self._SOLVE_CACHE_MAX:
                self._solve_cache.pop(next(iter(self._solve_cache)))
        else:  # refresh LRU order
            self._solve_cache.pop(sig)
            self._solve_cache[sig] = fn
        return fn

    # --- normalizer plumbing ---
    def _norm_params(self) -> dict:
        kind = self.controller_cfg.action_normalizer
        if kind not in norm.normalizer_registry:
            kind = "none"
        return norm.make_normalizer_params(
            kind, self.model.nu, ctrlrange=self.task.actuator_ctrlrange, dtype=self.dtype
        )

    @staticmethod
    def _fingerprint(cfg: Any) -> tuple:
        """Cheap value fingerprint of a config dataclass (arrays by bytes)."""
        import dataclasses as dc

        out = []
        for f in dc.fields(cfg):
            v = getattr(cfg, f.name)
            if isinstance(v, np.ndarray):
                out.append((f.name, v.tobytes()))
            elif dc.is_dataclass(v) and not isinstance(v, type):
                out.append((f.name, Controller._fingerprint(v)))
            else:
                out.append((f.name, v))
        return tuple(out)

    def _device_params(self) -> tuple[Any, Any, Any]:
        """Device-resident (task_params, opt_params, norm_params), re-uploaded
        only when the source config values change, so host->device transfers
        stay off the per-solve hot path."""
        cache = self._args_cache
        tfp = self._fingerprint(self.task.config)
        if cache.get("task_fp") != tfp:
            cache["task_fp"] = tfp
            cache["task_params"] = jax.device_put(self.task.task_params(self.dtype))
        ofp = self._fingerprint(self.optimizer.config)
        if cache.get("opt_fp") != ofp:
            cache["opt_fp"] = ofp
            cache["opt_params"] = jax.device_put(self.optimizer.params())
        nfp = (self.controller_cfg.action_normalizer,)
        if cache.get("norm_fp") != nfp:
            cache["norm_fp"] = nfp
            cache["norm_params"] = jax.device_put(self._norm_params())
        return cache["task_params"], cache["opt_params"], cache["norm_params"]

    def _device_times(self) -> tuple[Any, Any]:
        """Device-resident (spline_ts, rollout_ts), re-uploaded only when the
        horizon / node count / bucketed T change."""
        cache = self._args_cache
        key = (float(self.horizon), self.optimizer_cfg.num_nodes, self.num_timesteps)
        if cache.get("times_fp") != key:
            cache["times_fp"] = key
            cache["spline_ts"] = jax.device_put(jnp.asarray(self.spline_timesteps, self.dtype))
            cache["rollout_ts"] = jax.device_put(jnp.asarray(self.rollout_times, self.dtype))
        return cache["spline_ts"], cache["rollout_ts"]

    def solve_args(self) -> tuple[tuple, dict]:
        """(arguments of the compiled solve for the current state, the merged
        host metadata); ``self._get_solve()(*args)`` is one planning step."""
        metadata = self.task.pre_rollout(self.current_state)
        merged_meta = {**self.system_metadata, **metadata}
        device_meta = {
            k: jnp.asarray(v, self.dtype) for k, v in merged_meta.items() if not isinstance(v, str)
        }
        task_params, opt_params, norm_params = self._device_params()
        args = (
            self._carry,
            jnp.asarray(self.current_state, self.dtype),
            jnp.asarray(self.time, self.dtype),
            task_params,
            opt_params,
            norm_params,
            device_meta,
            *self._device_times(),
        )
        return args, merged_meta

    # --- main entry points (reference API) ---
    def update_action(self) -> None:
        """One planning step (the hot path).

        Per-stage timing is recorded in ``last_plan_timing`` (SURVEY §5.1: the
        reference only has end-to-end plan_time telemetry; here the split is
        prep [host arg staging] / device [dispatch + on-device solve] / sync
        [device->host pull + spline rebuild] — the natural stage boundaries of
        a fused jitted solve).

        With ``controller_cfg.pipeline_depth > 0`` the call dispatches the new
        solve FIRST and then syncs the oldest in-flight solve's outputs: the
        device works on solve N while the host consumes solve N-depth. The
        on-device SolverState carry chains without any host round-trip, so
        the optimizer/warm-start state is never stale — only the published
        spline/trace mirrors lag by ``depth`` solves."""
        import time as _time

        t0 = _time.perf_counter()
        assert self.current_state.shape == (self.model.nq + self.model.nv,)
        assert self.optimizer_cfg.num_rollouts > 0, "Need at least one rollout!"
        self._enforce_cubic_min_nodes()
        self._sync_state_shapes()

        solve = self._get_solve()
        args, merged_meta = self.solve_args()
        t1 = _time.perf_counter()
        self._carry, outputs = solve(*args)
        self._pending.append((self._carry, outputs, merged_meta))
        # start the device->host copy of the packed mirror NOW: by the time
        # the (pipelined) consumer reads it `depth` cycles later the bytes
        # are already host-side
        try:
            outputs.mirror.copy_to_host_async()
        except (AttributeError, RuntimeError):  # CPU arrays / older jaxlib
            pass
        depth = max(int(self.controller_cfg.pipeline_depth), 0)
        if depth == 0:
            while self._pending:
                self._consume(*self._pending.pop(0))
        else:
            # hand the oldest in-flight solves to the consumer thread: the
            # device->host pull of the mirrors blocks until the solve ends
            # and must not sit on the dispatch cycle's critical path. The
            # single worker
            # consumes strictly in order; readers of the mirrors (action(),
            # spline_data) see a consistent snapshot via _mirror_lock.
            while len(self._pending) > depth:
                carry, outputs, merged_meta = self._pending.pop(0)
                # post_rollout runs HERE on the main thread (it may mutate
                # task state, which the main thread also reads when staging
                # the next solve's args — advisor r4); only the blocking
                # device->host mirror pull goes to the worker. Touching the
                # device arrays does not synchronize (async dispatch).
                self.task.post_rollout(
                    outputs.states, outputs.sensors, outputs.rollout_controls, merged_meta
                )
                self._consume_futures.append(
                    self._consumer.submit(self._consume_mirrors, carry, outputs)
                )
            while len(self._consume_futures) > 2:  # bound the backlog
                self._consume_futures.pop(0).result()
        t2 = _time.perf_counter()
        t3 = t2
        if depth == 0:
            t3 = _time.perf_counter()
        self.last_plan_timing = {
            "prep_ms": 1e3 * (t1 - t0),
            "device_ms": 1e3 * (t2 - t1),
            "sync_ms": 1e3 * (t3 - t2),
            "total_ms": 1e3 * (t3 - t0),
        }

    def _consume(self, carry: SolverState, outputs: SolveOutputs, merged_meta: dict) -> None:
        """Sync one solve's outputs into the host-side mirrors (main thread)."""
        if outputs.states is not None:
            self.task.post_rollout(
                outputs.states, outputs.sensors, outputs.rollout_controls, merged_meta
            )
        self._consume_mirrors(carry, outputs)

    def _consume_mirrors(self, carry: SolverState, outputs: SolveOutputs) -> None:
        # ONE device->host pull of the packed mirror vector (device_get
        # itself waits for the solve, so no separate block_until_ready).
        # Layout dims come from
        # the carry (same solve), so the slim-output mode needs no big
        # tensors on host.
        flat = np.asarray(jax.device_get(outputs.mirror))
        n = carry.times.shape[0]
        nu = carry.nominal_knots.shape[1]  # task action dim (not model nu)
        r = outputs.rewards.shape[0]
        i0 = 0
        times = flat[i0 : i0 + n]; i0 += n
        knots = flat[i0 : i0 + n * nu].reshape(n, nu); i0 += n * nu
        rewards = flat[i0 : i0 + r]; i0 += r
        traces = flat[i0:].reshape(-1, 2, 3)
        with self._mirror_lock:
            self.last_outputs = outputs
            self.times, self.nominal_knots, self.rewards = times, knots, rewards
            self.update_spline(times, knots)
            self.traces = traces if traces.size else None

    def flush_pipeline(self) -> None:
        """Drain all in-flight solves (pipeline_depth > 0) into the mirrors."""
        while self._consume_futures:
            self._consume_futures.pop(0).result()
        while self._pending:
            self._consume(*self._pending.pop(0))

    def action(self, time: float) -> np.ndarray:
        """Current best action (host-side spline query; consistent snapshot
        when the pipelined consumer thread is updating the mirrors)."""
        with self._mirror_lock:
            return self.spline(time)

    def update_spline(self, times: np.ndarray, controls: np.ndarray) -> None:
        fill = (controls[..., 0, :], controls[..., -1, :])
        self.spline = interp1d(
            times, controls, kind=self.spline_order, axis=-2, fill_value=fill, bounds_error=False
        )

    def update_traces(self, outputs: SolveOutputs, traces: np.ndarray | None = None) -> None:
        """Flatten device-packed elite traces to the (total, 2, 3) wire layout."""
        tr = np.asarray(outputs.traces) if traces is None else traces  # (k, ns, T-1, 2, 3)
        if tr.size == 0:
            self.traces = None
            return
        k, ns, tm1 = tr.shape[0], tr.shape[1], tr.shape[2]
        # reference interleaving (controller.py:352-363): index = elite*ns + sensor
        self.traces = tr.reshape(k * ns * tm1, 2, 3)

    def update_states(self, state_msg) -> None:
        """Consume a MujocoState message (controller.py:365-369)."""
        self.current_state = np.concatenate([state_msg.qpos, state_msg.qvel])
        self.time = state_msg.time
        self.system_metadata = state_msg.sim_metadata

    def reset(self) -> None:
        """Reset task + solver state (controller.py:309-321)."""
        # drop in-flight solves from a previous task/state; a consume already
        # EXECUTING on the worker cannot be cancelled and would publish
        # pre-reset mirrors after this returns (advisor r4) — drain it
        for f in self._consume_futures:
            if not f.cancel():
                try:
                    f.result()
                except Exception:  # noqa: BLE001 — a failed stale consume is moot
                    pass
        self._consume_futures = []
        self._pending = []
        self.task.reset()
        self._enforce_cubic_min_nodes()
        n = self.optimizer_cfg.num_nodes
        warm = np.tile(self.task.optimizer_warm_start(), (n, 1))
        times0 = self.task.data.time + self.spline_timesteps
        kind = self.controller_cfg.action_normalizer
        norm_params = self._norm_params()
        self._carry = SolverState(
            times=jnp.asarray(times0, self.dtype),
            nominal_knots=jnp.asarray(warm, self.dtype),
            opt_state=self.optimizer.init_state(self.dtype),
            norm_state=norm.init_normalizer_state(
                kind if kind in norm.normalizer_registry else "none",
                self.model.nu,
                norm_params,
                self.dtype,
            ),
            rng=jax.random.key(np.random.randint(0, 2**31 - 1)),
            last_policy_output=(
                jnp.zeros((self.optimizer_cfg.num_rollouts, 12), self.dtype)
                if self.task.uses_locomotion_policy
                else ()
            ),
            efc_warm=self._init_efc_warm(),
        )
        self.times = np.asarray(times0)
        self.nominal_knots = warm
        self.current_state = np.concatenate([self.task.data.qpos, self.task.data.qvel])
        self.update_spline(self.times, self.nominal_knots)

    def _init_efc_warm(self):
        """(R, nefc) zeros for lanes backends (cross-solve onset warm start);
        () elsewhere (the vmap path manages warm starts per step)."""
        if self.task.uses_locomotion_policy:
            return ()
        if not self._resolve_rollout_backend().startswith("lanes"):
            return ()
        from judo_tpu.physics.solver import num_constraint_rows

        nefc = num_constraint_rows(self.pm)
        return jnp.zeros((self.optimizer_cfg.num_rollouts, max(nefc, 1)), self.dtype)

    def _sync_state_shapes(self) -> None:
        """Re-shape carried state when GUI knobs changed node counts etc."""
        ew = self._init_efc_warm()
        cur = self._carry.efc_warm
        if isinstance(ew, tuple) != isinstance(cur, tuple) or (
            not isinstance(ew, tuple) and ew.shape != cur.shape
        ):
            self._carry = self._carry.replace(efc_warm=ew)
        if self.task.uses_locomotion_policy:
            r = self.optimizer_cfg.num_rollouts
            pout = self._carry.last_policy_output
            if not isinstance(pout, tuple) and pout.shape[0] != r:
                self._carry = self._carry.replace(
                    last_policy_output=jnp.zeros((r, 12), self.dtype)
                )
        n = self.optimizer_cfg.num_nodes
        if self._carry.nominal_knots.shape[0] != n:
            old_times = self._carry.times
            new_times = jnp.linspace(old_times[0], old_times[-1], n)
            nominal = eval_spline(old_times, self._carry.nominal_knots, new_times, "linear")
            opt_state = self.optimizer.pre_optimization(
                self.optimizer.params(), self._carry.opt_state, old_times, new_times
            )
            # states whose node axis didn't re-interp above are re-initialized
            opt_state = jax.tree.map(
                lambda leaf, ref: leaf if leaf.shape == ref.shape else ref,
                opt_state,
                self.optimizer.init_state(self.dtype),
            )
            self._carry = self._carry.replace(times=new_times, nominal_knots=nominal, opt_state=opt_state)


def make_controller(
    init_task: str,
    init_optimizer: str,
    task_registration_cfg: dict | None = None,
    optimizer_registration_cfg: dict | None = None,
    rollout_backend: Literal["auto", "judo_tpu", "vmap", "lanes_xla"] = "judo_tpu",
    mesh=None,
) -> Controller:
    """Instantiate a controller from registry names (controller.py:404-442).

    ``mesh`` accepts ``None``/``"none"``, ``"auto"``, ``"hybrid"``, or a
    ``jax.sharding.Mesh`` — the user-reachable parallelism knob (the
    reference's analogue is the rollout thread-count resize,
    judo/utils/rollout_backend.py:10-47). The candidate batch shards over the
    mesh; ``num_rollouts`` must divide by the device count.
    """
    from judo_tpu.app.utils import register_optimizers_from_cfg, register_tasks_from_cfg
    from judo_tpu.parallel.mesh import resolve_mesh

    if task_registration_cfg is not None:
        register_tasks_from_cfg(task_registration_cfg)
    if optimizer_registration_cfg is not None:
        register_optimizers_from_cfg(optimizer_registration_cfg)

    available_tasks = get_registered_tasks()
    available_optimizers = get_registered_optimizers()
    task_entry = available_tasks.get(init_task)
    optimizer_entry = available_optimizers.get(init_optimizer)
    assert task_entry is not None, f"Task {init_task} not found in task registry."
    assert optimizer_entry is not None, f"Optimizer {init_optimizer} not found in optimizer registry."

    task_cls, _ = task_entry
    task = task_cls()

    optimizer_cls, optimizer_config_cls = optimizer_entry
    optimizer_cfg = optimizer_config_cls()
    optimizer_cfg.set_override(init_task)
    optimizer = optimizer_cls(optimizer_cfg, task.nu)

    controller_cfg = ControllerConfig()
    controller_cfg.set_override(init_task)

    return Controller(
        controller_config=controller_cfg,
        task=task,
        optimizer=optimizer,
        rollout_backend=rollout_backend,
        mesh=resolve_mesh(mesh),
    )
