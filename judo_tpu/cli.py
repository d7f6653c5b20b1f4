"""Command-line entry points (reference: judo/cli.py:144-176).

The reference launches a 3-process dora dataflow via hydra; here a single
process hosts the sim + controller threads (+ visualizer when available), so
the CLI is a plain argparse app:

    python -m judo_tpu.cli run --task cartpole --optimizer ps --seconds 10
    python -m judo_tpu.cli run --config example_configs/example.yaml
    python -m judo_tpu.cli benchmark --tasks cartpole --optimizers ps,mppi

The ``--config`` YAML mirrors the reference's hydra launch config
(judo/configs/judo_dora_default.yaml): top-level ``task`` / ``optimizer`` /
``simulation_backend`` knobs, ``custom_tasks`` / ``custom_optimizers`` dotted
class paths, and per-task ``controller_config_overrides`` /
``optimizer_config_overrides`` registered into the override registry.
"""

from __future__ import annotations

import argparse
import threading
import time


def apply_launch_config(args: argparse.Namespace) -> None:
    """Load a YAML launch config and fold it into the parsed args.

    Mirrors the reference's launch-time composition (judo/cli.py:144-152 +
    judo/app/utils.py:19-44 + visualizer override registration,
    judo/visualizers/visualizer.py:75-97) without a hydra dependency.
    """
    if not getattr(args, "config", None):
        return
    import yaml

    from judo_tpu.app.utils import register_optimizers_from_cfg, register_tasks_from_cfg
    from judo_tpu.config import set_config_overrides
    from judo_tpu.controller import ControllerConfig
    from judo_tpu.optimizers import get_registered_optimizers

    with open(args.config) as f:
        cfg = yaml.safe_load(f) or {}

    if cfg.get("custom_tasks"):
        register_tasks_from_cfg(cfg["custom_tasks"])
    if cfg.get("custom_optimizers"):
        register_optimizers_from_cfg(cfg["custom_optimizers"])

    for task_name, values in (cfg.get("controller_config_overrides") or {}).items():
        set_config_overrides(task_name, ControllerConfig, dict(values))
    optimizers = get_registered_optimizers()
    for task_name, per_opt in (cfg.get("optimizer_config_overrides") or {}).items():
        for opt_name, values in (per_opt or {}).items():
            entry = optimizers.get(opt_name)
            if entry is None:
                raise KeyError(f"optimizer_config_overrides: unknown optimizer '{opt_name}'")
            set_config_overrides(task_name, entry[1], dict(values))

    # YAML values are defaults; explicit CLI flags (non-default) win
    defaults = {"task": "cylinder_push", "optimizer": "ps", "sim_backend": "mujoco", "mesh": "none"}
    if cfg.get("task") and args.task == defaults["task"]:
        args.task = cfg["task"]
    if cfg.get("optimizer") and args.optimizer == defaults["optimizer"]:
        args.optimizer = cfg["optimizer"]
    if cfg.get("simulation_backend") and args.sim_backend == defaults["sim_backend"]:
        args.sim_backend = cfg["simulation_backend"]
    if cfg.get("mesh") and getattr(args, "mesh", "none") == defaults["mesh"]:
        args.mesh = cfg["mesh"]


def _cmd_run(args: argparse.Namespace) -> None:
    from judo_tpu.app.bus import MessageBus
    from judo_tpu.app.nodes import ControllerNode, SimulationNode

    apply_launch_config(args)
    bus = MessageBus()
    sim_node = SimulationNode(bus, args.task, backend=args.sim_backend)
    ctrl_node = ControllerNode(bus, args.task, args.optimizer, mesh=args.mesh)
    if ctrl_node.mesh is not None:
        print(
            f"mesh: sharding {ctrl_node.controller.optimizer_cfg.num_rollouts} rollouts "
            f"over {ctrl_node.mesh.devices.size} devices {ctrl_node.mesh.shape}",
            flush=True,
        )

    # Pre-warm BEFORE starting the paced threads (the analogue of the
    # reference's _warm_caches, judo/cli.py:126-141): the first solve triggers
    # the XLA compile (tens of seconds) and must not happen while the sim
    # thread contends for the GIL or while --seconds is ticking.
    print("warming up: compiling the solve (first run may take ~30s)...", flush=True)
    t0 = time.perf_counter()
    sim_node.warmup()
    ctrl_node.warmup()
    print(f"warmup done in {time.perf_counter() - t0:.1f}s", flush=True)

    gui_server = None
    if getattr(args, "gui", False):
        from judo_tpu.visualizers.server import GuiServer

        gui_server = GuiServer(bus, ctrl_node, sim_node, port=args.gui_port)
        gui_server.start()
        print(f"GUI: http://localhost:{gui_server.port}", flush=True)

    threads = [
        threading.Thread(target=sim_node.spin, daemon=True),
        threading.Thread(target=ctrl_node.spin, daemon=True),
    ]
    for t in threads:
        t.start()

    t_end = time.time() + args.seconds if args.seconds > 0 else None
    try:
        while t_end is None or time.time() < t_end:
            time.sleep(0.5)
            plan_time = bus.read("plan_time")
            state = bus.read("states")
            if plan_time is not None and state is not None:
                print(
                    f"t={state.time:7.2f}s plan={plan_time * 1e3:7.1f}ms "
                    f"qpos[:3]={state.qpos[:3].round(3)}",
                    flush=True,
                )
    except KeyboardInterrupt:
        pass
    finally:
        # graceful stop+join (the reference's cleanup discipline,
        # judo/cli.py:26-107): never abandon threads mid-dispatch
        sim_node.stop()
        ctrl_node.stop()
        for t in threads:
            t.join(timeout=30.0)
        if gui_server is not None:
            gui_server.stop()
        print("shutdown complete", flush=True)


def _cmd_benchmark(args: argparse.Namespace) -> None:
    from judo_tpu.app.benchmark import format_table, run_benchmark

    tasks = args.tasks.split(",") if args.tasks else None
    optimizers = args.optimizers.split(",") if args.optimizers else None
    results = run_benchmark(tasks=tasks, optimizers=optimizers, num_samples=args.num_samples)
    print(format_table(results))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="judo-tpu", description="Sampling-based MPC on JAX")
    p.add_argument(
        "--platform",
        default="",
        choices=["", "cpu", "gpu"],
        help="force the jax backend (default: JAX's own choice)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    run = sub.add_parser("run", help="closed-loop sim + controller")
    run.add_argument("--task", default="cylinder_push")
    run.add_argument("--optimizer", default="ps")
    run.add_argument(
        "--sim-backend",
        default="mujoco",
        help="plant: mujoco (CPU MuJoCo) or judo_tpu (the JAX engine; needs no mujoco)",
    )
    run.add_argument(
        "--mesh",
        default="none",
        help="shard the rollout batch over a device mesh: none|auto|hybrid "
        "(auto = all visible devices; hybrid = (hosts, devices/host) after "
        "jax.distributed bootstrap)",
    )
    run.add_argument("--config", default="", help="YAML launch config (see example_configs/)")
    run.add_argument("--seconds", type=float, default=10.0, help="<=0 runs until Ctrl+C")
    run.add_argument("--gui", action="store_true", help="serve the browser GUI/renderer")
    run.add_argument("--gui-port", type=int, default=8008)
    run.set_defaults(func=_cmd_run)

    bench = sub.add_parser("benchmark", help="plan-time distribution per task/optimizer pair")
    bench.add_argument("--tasks", default="")
    bench.add_argument("--optimizers", default="")
    bench.add_argument("--num-samples", type=int, default=100)
    bench.set_defaults(func=_cmd_benchmark)
    return p


def main() -> None:
    args = build_parser().parse_args()
    if args.platform:
        import jax

        # "gpu" is JAX's alias for cuda and rocm together; this build targets CUDA
        jax.config.update("jax_platforms", {"gpu": "cuda"}.get(args.platform, args.platform))
    args.func(args)


def benchmark_main() -> None:
    """Console entry mirroring the reference's ``benchmark`` script."""
    import sys

    sys.argv = [sys.argv[0], "benchmark", *sys.argv[1:]]
    main()


if __name__ == "__main__":
    main()
