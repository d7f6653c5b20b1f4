#!/usr/bin/env python3
"""Smoke test of the planner on NVIDIA GPUs, through its user entry points.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --devices 4  # four cards: the sharded solve only

One card, in order:

1. the card's name and power limit (``nvidia-smi``, before JAX starts);
2. refuse anything but a GPU: exit 1 with no result line;
3. leap_cube + MPPI at R=320 (horizon 1.0 s, T=100 steps, 68 contact slots)
   and spot_navigate + MPPI at R=24 (horizon 2.0 s: the 50 Hz locomotion MLP
   over 100 Hz physics), each through ``make_controller`` ->
   ``Controller.update_action`` on the ``auto`` rollout backend: first-call
   (compile) time, the solve's ``memory_analysis()``, depth-0 and depth-2 p50
   plan time, peak device memory, finite rewards of the right shape;
4. the headless closed loop (``cli run``: simulation and controller nodes in
   this process) on leap_cube for a few seconds, with the JAX engine as plant;
5. parity: the leap_cube scene rolled out for 50 steps at float32 on the card
   against CPU MuJoCo's ``mj_step`` trajectory (committed with the package,
   judo_tpu/tasks/exported.py), at the solve's matmul precision
   ("highest"); the vmap engine's error at JAX's default precision (TF32
   allowed), and the lanes engine's, are printed beside it;
6. the tests marked ``gpu``, in this process (one JAX client holds the card).

With ``--devices 4``: leap_cube + MPPI at R=1280 sharded over a 1-D
4-device mesh through ``Controller(mesh=...)``, against the same seed's solve
on one card.

The last line of stdout is ``{"ok": true, "device": {...}}``; a failed phase
raises, so the script exits non-zero without that line.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time

# f32 max |qpos| bound against mj_step over the 50-step leap_cube rollout:
# the CPU float64 test bound (tests/test_physics/test_scene_parity.py). The
# f64 error there is 0.0097, set by the solver's model differences from
# MuJoCo; f32 with full-precision matmuls adds little to it (0.0098), so the
# bound carries over unchanged.
PARITY_TOL = 0.03
SEED = 0


def _p50_ms(c, n: int) -> float:
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        c.update_action()
        times.append(time.perf_counter() - t0)
    c.flush_pipeline()
    times.sort()
    return 1e3 * times[len(times) // 2]


def solve_phase(task: str, num_rollouts: int, horizon: float, n_solves: int = 10) -> dict:
    """One task through make_controller -> update_action at depth 0 and 2."""
    import jax
    import numpy as np

    from judo_tpu.controller import make_controller

    np.random.seed(SEED)
    c = make_controller(task, "mppi")
    c.optimizer_cfg.num_rollouts = num_rollouts
    c.controller_cfg.horizon = horizon
    c.reset()
    backend = c._resolve_rollout_backend()
    t0 = time.perf_counter()
    c.update_action()  # compiles the solve, then runs it once
    first_s = time.perf_counter() - t0
    args, _ = c.solve_args()
    mem = c._get_solve().lower(*args).compile().memory_analysis()
    d0 = _p50_ms(c, n_solves)
    c.controller_cfg.pipeline_depth = 2
    for _ in range(4):
        c.update_action()
    d2 = _p50_ms(c, n_solves)
    rewards = np.asarray(c.rewards)
    if rewards.shape != (num_rollouts,) or not np.isfinite(rewards).all():
        raise AssertionError(f"{task}: rewards {rewards.shape} not finite/shaped")
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")  # None on CPU
    out = {
        "task": task, "num_rollouts": num_rollouts, "horizon_steps": c.num_timesteps,
        "backend": backend, "first_call_s": first_s, "depth0_p50_ms": d0,
        "depth2_p50_ms": d2, "peak_bytes_in_use": peak,
        "reward_mean": float(rewards.mean()),
    }
    print(f"[solve] {task}: memory_analysis {mem}")
    print(f"[solve] {json.dumps(out)}", flush=True)
    return out


def closed_loop_phase(seconds: float = 5.0) -> None:
    """``python -m judo_tpu.cli run --task leap_cube --optimizer mppi``, in process."""
    from judo_tpu.cli import build_parser

    argv = ["run", "--task", "leap_cube", "--optimizer", "mppi", "--seconds", str(seconds),
            "--sim-backend", "judo_tpu"]
    args = build_parser().parse_args(argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        args.func(args)
    log = buf.getvalue()
    print("\n".join(f"[closed loop] {line}" for line in log.splitlines()), flush=True)
    sim_times = [float(line.split("t=")[1].split("s")[0]) for line in log.splitlines()
                 if line.startswith("t=") and "plan=" in line]
    if "shutdown complete" not in log or len(set(sim_times)) < 2:
        raise AssertionError("closed loop: no plan published while the plant stepped")


def parity_phase(production_engine: str) -> None:
    from judo_tpu.tasks.exported import rollout_parity_error

    precision = "highest"  # the solve's (Controller._build_solve)
    runs = [("vmap", "highest"), ("vmap", "default"), ("lanes", precision)]
    for engine, p in runs:
        err = rollout_parity_error(engine, p)
        print(f"[parity] leap_cube f32 50 steps vs mj_step, engine {engine}, matmul precision "
              f"{p}: max|qpos| {err:.6g} (bound {PARITY_TOL})", flush=True)
        if (engine, p) == (production_engine, precision) and not err < PARITY_TOL:
            raise AssertionError(f"parity error {err} >= {PARITY_TOL} ({engine}, {p})")


class _Outcomes:
    """pytest plugin that counts test outcomes."""

    def __init__(self) -> None:
        self.counts = {"passed": 0, "failed": 0, "skipped": 0}

    def pytest_runtest_logreport(self, report) -> None:
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] = self.counts.get(report.outcome, 0) + 1


def gpu_tests_phase() -> None:
    """The tests marked gpu. Only the files that hold them are collected:
    the other test files may import mujoco, which a GPU machine may lack."""
    from pathlib import Path

    import pytest

    files = sorted(
        str(p) for p in Path("tests").rglob("test_*.py") if "pytest.mark.gpu" in p.read_text()
    )
    outcomes = _Outcomes()
    rc = pytest.main(
        ["-o", "addopts=", "-m", "gpu", "-p", "no:xdist", "-p", "no:cacheprovider", "-q",
         "-rs", *files],
        plugins=[outcomes],
    )
    print(f"[gpu tests] exit {rc}, {outcomes.counts}", flush=True)
    c = outcomes.counts
    if rc != 0 or c["passed"] == 0 or c["failed"] or c["skipped"]:
        raise AssertionError(f"gpu tests: exit {rc}, {c}")


def sharded_phase(n_devices: int, num_rollouts: int = 1280) -> None:
    """Same-seed leap_cube solve on one device and sharded over n devices."""
    import numpy as np

    from judo_tpu.controller import Controller, ControllerConfig
    from judo_tpu.optimizers import MPPI, MPPIConfig
    from judo_tpu.parallel import make_rollout_mesh
    from judo_tpu.tasks.leap_cube import LeapCube

    def run(mesh):
        np.random.seed(SEED)
        task = LeapCube()
        opt = MPPI(MPPIConfig(num_rollouts=num_rollouts, num_nodes=4, sigma=0.2), task.nu)
        c = Controller(ControllerConfig(horizon=1.0, spline_order="cubic"), task, opt, mesh=mesh)
        t0 = time.perf_counter()
        c.update_action()
        first = time.perf_counter() - t0
        d0 = _p50_ms(c, 5)
        print(f"[sharded] devices {1 if mesh is None else mesh.devices.size}: R={num_rollouts} "
              f"first call {first:.3f} s, depth-0 p50 {d0:.3f} ms", flush=True)
        return c

    one = run(None)
    sh = run(make_rollout_mesh(n_devices))
    # rtol: the f32 tolerance tests/test_parallel/test_sharded_solve.py uses
    # for its f32 (policy) path, since partitioning may reassociate
    # reductions. atol 1e-5 for the knots: each is an MPPI-weighted sum over
    # all R candidates of O(1) knot values, so reassociating that f32 sum
    # moves knots near zero by up to ~log2(R) * eps * max|knot| ~ 1e-6.
    for name, atol in (("rewards", 1e-6), ("nominal_knots", 1e-5)):
        a, b = np.asarray(getattr(sh, name)), np.asarray(getattr(one, name))
        print(f"[sharded] {name}: max abs diff {float(np.max(np.abs(a - b))):.3g}, "
              f"max |value| {float(np.max(np.abs(b))):.3g}", flush=True)
        np.testing.assert_allclose(a, b, rtol=5e-5, atol=atol)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded solve over four cards")
    args = ap.parse_args()

    from judo_tpu.utils.device import card_name_and_power_limit, require_gpu

    # 1. the card (nvidia-smi runs as a child; no JAX backend is up yet)
    card = card_name_and_power_limit()
    print(f"card: {card}", flush=True)

    # 2. a GPU, or nothing
    device = require_gpu()
    print(f"device: {json.dumps(device)}", flush=True)
    if device["count"] < args.devices:
        raise RuntimeError(f"--devices {args.devices} but JAX sees {device['count']}")

    t0 = time.perf_counter()

    def phase(fn, *a):
        out = fn(*a)
        print(f"[time] {fn.__name__} done at {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    if args.devices > 1:
        phase(sharded_phase, args.devices)
    else:
        leap = phase(solve_phase, "leap_cube", 320, 1.0)
        phase(solve_phase, "spot_navigate", 24, 2.0)
        phase(closed_loop_phase)
        phase(parity_phase, "lanes" if leap["backend"] == "lanes_xla" else "vmap")
        phase(gpu_tests_phase)

    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
