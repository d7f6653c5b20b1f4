"""App nodes: sim loop + controller loop over the message bus.

Mirrors the reference's dora nodes (judo/app/dora/{simulation,controller}.py)
as threads in one process. Topic contract (judo_dora_default.yaml):

    simulation --states--> controller
    controller --controls (SplineData), plan_time, traces--> simulation/viz
    viz/CLI    --task, optimizer, pause, reset, configs--> both
"""

from __future__ import annotations

import threading
import time
import warnings
from typing import Any

import numpy as np

from judo_tpu.app.bus import MessageBus
from judo_tpu.app.structs import MujocoState, SplineData
from judo_tpu.controller import Controller, make_controller
from judo_tpu.simulation import Simulation, get_simulation_backend


class SimulationNode:
    """Paced sim loop: evaluate received control spline at sim time, step,
    publish states (dora/simulation.py:52-87)."""

    def __init__(self, bus: MessageBus, init_task: str, backend: str = "mujoco") -> None:
        self.bus = bus
        from judo_tpu.tasks import get_registered_tasks

        task_cls, _ = get_registered_tasks()[init_task]
        task = task_cls()
        # auto-upgrade: locomotion-policy tasks need the policy-in-the-loop
        # plant (reference judo/app/dora/simulation.py:34-43)
        self._requested_backend = backend
        if backend == "mujoco" and task.uses_locomotion_policy:
            backend = "mujoco_policy"
        self.sim: Simulation = get_simulation_backend(backend)(task)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        bus.subscribe("task", self._on_task)
        bus.subscribe("sim_pause", self._on_pause)
        bus.subscribe("task_reset", self._on_reset)

    def _on_task(self, name: str) -> None:
        with self._lock:
            from judo_tpu.simulation import PolicySimulation
            from judo_tpu.tasks import get_registered_tasks

            entry = get_registered_tasks().get(name)
            if entry is None:
                warnings.warn(f"unknown task '{name}'", stacklevel=1)
                return
            task = entry[0]()
            if (
                self._requested_backend == "mujoco"
                and task.uses_locomotion_policy
                and not isinstance(self.sim, PolicySimulation)
            ):
                self.sim = PolicySimulation(task)
            else:
                self.sim.set_task_instance(task)

    def _on_pause(self, _msg: Any) -> None:
        with self._lock:
            self.sim.pause()

    def _on_reset(self, _msg: Any) -> None:
        with self._lock:
            self.sim.task.reset()

    def warmup(self) -> None:
        """Step the plant once, reset it and publish its state, so that
        first-use compiles (a JAX plant's step, eager ops in task hooks)
        happen before the paced loop starts, and the controller can warm
        up on a real state message (ControllerNode.warmup)."""
        with self._lock:
            self.sim.step(np.zeros(self.sim.task.nu))
            self.sim.task.reset()
            self.bus.publish("states", self.sim.sim_state)

    def step_once(self) -> None:
        """One sim tick (also used directly by tests/benchmark)."""
        with self._lock:
            spline_msg: SplineData | None = self.bus.read("controls")
            task = self.sim.task
            if spline_msg is not None and spline_msg.x.shape[-1] == task.nu:
                command = spline_msg.spline()(self.sim.task.data.time)
            else:
                command = np.zeros(task.nu)
            self.sim.step(command)
            self.bus.publish("states", self.sim.sim_state)

    def spin(self) -> None:
        while not self._stop.is_set():
            t0 = time.perf_counter()
            self.step_once()
            elapsed = time.perf_counter() - t0
            budget = self.sim.timestep
            if elapsed > budget:
                warnings.warn(f"sim step overran: {elapsed * 1e3:.1f}ms > {budget * 1e3:.1f}ms", stacklevel=1)
            else:
                time.sleep(budget - elapsed)

    def stop(self) -> None:
        self._stop.set()


class ControllerNode:
    """Controller loop at control_freq: consume states, plan, publish spline +
    plan_time + traces (dora/controller.py:126-157).

    ``mesh`` (``none``/``auto``/``hybrid`` or a ``jax.sharding.Mesh``) shards
    the candidate batch over a device mesh — the app-layer entry to multi-chip
    planning (the reference's analogue is the GUI-resizable rollout thread
    pool, judo/utils/rollout_backend.py:10-47).

    Task/optimizer switches build + warm-compile the NEW controller on a
    worker thread while the old one keeps planning, then swap it in — the
    control loop never blocks on XLA compiles (the reference switches
    in-place in milliseconds because libmujoco needs no compile; a jitted
    solve needs the background warmup for the same UX). ``join_switch()``
    waits for the swap (tests, scripted runs)."""

    def __init__(
        self, bus: MessageBus, init_task: str, init_optimizer: str, mesh=None
    ) -> None:
        from concurrent.futures import ThreadPoolExecutor

        from judo_tpu.parallel.mesh import resolve_mesh

        self.bus = bus
        self.mesh = resolve_mesh(mesh)
        self.controller: Controller = make_controller(init_task, init_optimizer, mesh=self.mesh)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._paused = False
        self._swapper = ThreadPoolExecutor(max_workers=1, thread_name_prefix="judo-swap")
        self._swap_future = None
        self._swap_gen = 0
        bus.subscribe("task", self._on_task)
        bus.subscribe("optimizer", self._on_optimizer)
        bus.subscribe("task_reset", self._on_reset)
        bus.subscribe("controller_pause", self._on_pause)

    def _submit_swap(self, build) -> None:
        """Run ``build()`` (Controller construction + warm compile) on the
        worker; swap the result in unless a newer switch superseded it."""
        self._swap_gen += 1
        gen = self._swap_gen

        def job():
            try:
                new_controller = build()
            except Exception as e:  # noqa: BLE001 — a failed switch must not kill the loop
                warnings.warn(f"controller switch failed: {e}", stacklevel=1)
                return
            with self._lock:
                if gen == self._swap_gen:  # latest request wins
                    self.controller = new_controller

        self._swap_future = self._swapper.submit(job)

    def join_switch(self, timeout: float | None = None) -> None:
        """Block until an in-flight task/optimizer switch has been applied."""
        f = self._swap_future
        if f is not None:
            f.result(timeout=timeout)

    def _on_task(self, name: str) -> None:
        with self._lock:
            entry = self.controller.available_tasks.get(name)
            if entry is None:
                warnings.warn(f"unknown task '{name}'", stacklevel=1)
                return
            task_cls, _ = entry
            opt_cls = type(self.controller.optimizer)
            opt_cfg_cls = type(self.controller.optimizer.config)
            cfg_cls = type(self.controller.controller_cfg)
            mesh = self.mesh

        def build() -> Controller:
            task = task_cls()
            opt_cfg = opt_cfg_cls()
            opt_cfg.set_override(name)
            optimizer = opt_cls(opt_cfg, task.nu)
            cfg = cfg_cls()
            cfg.set_override(name)
            c = Controller(cfg, task, optimizer, mesh=mesh)
            c.update_action()  # warm compile off the control loop
            c.reset()
            return c

        self._submit_swap(build)

    def _on_optimizer(self, name: str) -> None:
        with self._lock:
            entry = self.controller.available_optimizers.get(name)
            if entry is None:
                warnings.warn(f"unknown optimizer '{name}'", stacklevel=1)
                return
            opt_cls, opt_cfg_cls = entry
            task = self.controller.task
            cfg = self.controller.controller_cfg
            mesh = self.mesh

        def build() -> Controller:
            opt_cfg = opt_cfg_cls()
            opt_cfg.set_override(task.name)
            c = Controller(cfg, task, opt_cls(opt_cfg, task.nu), mesh=mesh)
            c.update_action()
            c.reset()
            return c

        self._submit_swap(build)

    def _on_reset(self, _msg: Any) -> None:
        with self._lock:
            self.controller.reset()

    def _on_pause(self, _msg: Any) -> None:
        with self._lock:
            self._paused = not self._paused

    def warmup(self) -> None:
        """Compile + run the solve once and discard the result, so the paced
        spin loop never blocks on first-jit (the reference pre-warms caches
        before forking its nodes, judo/cli.py:126-141). A published state
        message is consumed first: its sim metadata is part of the solve's
        input structure, so warming up without it would leave a second
        compile for the first paced step."""
        with self._lock:
            state_msg: MujocoState | None = self.bus.read("states")
            if state_msg is not None and state_msg.qpos.shape[0] == self.controller.model.nq:
                self.controller.update_states(state_msg)
            self.controller.update_action()
            self.controller.reset()

    def step_once(self) -> float | None:
        """One plan step; returns plan time in seconds (None if skipped)."""
        with self._lock:
            if self._paused:
                return None
            state_msg: MujocoState | None = self.bus.read("states")
            if state_msg is not None:
                if state_msg.qpos.shape[0] != self.controller.model.nq:
                    return None  # stale message from a prior task (dora/controller.py:117-124)
                self.controller.update_states(state_msg)
            t0 = time.perf_counter()
            self.controller.update_action()
            plan_time = time.perf_counter() - t0
            self.bus.publish("controls", self.controller.spline_data)
            self.bus.publish("plan_time", plan_time)
            if self.controller.traces is not None:
                self.bus.publish("traces", self.controller.traces)
            return plan_time

    def spin(self) -> None:
        while not self._stop.is_set():
            t0 = time.perf_counter()
            self.step_once()
            period = 1.0 / self.controller.controller_cfg.control_freq
            elapsed = time.perf_counter() - t0
            if elapsed < period:
                time.sleep(period - elapsed)

    def stop(self) -> None:
        self._stop.set()
