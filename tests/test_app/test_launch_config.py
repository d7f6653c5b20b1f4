"""YAML launch-config composition tests (reference semantics:
judo/cli.py:144-152 hydra compose + judo/app/utils.py:19-44 registration +
example_configs/example.yaml)."""

from __future__ import annotations

from judo_tpu.cli import apply_launch_config, build_parser

EXAMPLE_YAML = "example_configs/example.yaml"


def test_example_config_registers_and_overrides(tmp_path):
    parser = build_parser()
    args = parser.parse_args(["run", "--config", EXAMPLE_YAML])
    apply_launch_config(args)

    # custom task/optimizer registered and selected
    from judo_tpu.optimizers import get_registered_optimizers
    from judo_tpu.tasks import get_registered_tasks

    assert args.task == "my_cylinder_push"
    assert args.optimizer == "my_cem"
    tasks = get_registered_tasks()
    optimizers = get_registered_optimizers()
    assert "my_cylinder_push" in tasks
    assert "my_cem" in optimizers

    # overrides land in the registry and apply on key switch
    from judo_tpu.controller import ControllerConfig

    cc = ControllerConfig()
    cc.set_override("my_cylinder_push")
    assert cc.spline_order == "zero"
    assert cc.horizon == 1.0

    oc = optimizers["my_cem"][1]()
    assert oc.my_custom_param == 42
    oc.set_override("my_cylinder_push")
    assert oc.num_rollouts == 32
    assert oc.use_noise_ramp is True
    assert oc.noise_ramp == 4.0


def test_cli_flags_override_yaml():
    parser = build_parser()
    args = parser.parse_args(["run", "--config", EXAMPLE_YAML, "--task", "cartpole"])
    apply_launch_config(args)
    assert args.task == "cartpole"  # explicit flag wins
    assert args.optimizer == "my_cem"  # yaml default applies


def test_registered_overrides_reapply_on_gui_task_switch():
    """Launch-registered per-task overrides must re-apply when the GUI
    switches tasks mid-run (reference: the visualizer re-applies registered
    controller/optimizer overrides on switch, visualizer.py:126-134)."""
    import numpy as np

    from judo_tpu.app.bus import MessageBus
    from judo_tpu.app.nodes import ControllerNode
    from judo_tpu.config import set_config_overrides
    from judo_tpu.controller import ControllerConfig
    from judo_tpu.optimizers import get_registered_optimizers

    from judo_tpu.config import _OVERRIDE_REGISTRY

    np.random.seed(0)
    mppi_cfg_cls = get_registered_optimizers()["mppi"][1]
    # snapshot the registry entries; set_config_overrides MERGES, so restore
    # must rewrite the saved dicts
    saved = {
        cls: dict(_OVERRIDE_REGISTRY[cls]["cylinder_push"])
        for cls in (ControllerConfig, mppi_cfg_cls)
    }
    set_config_overrides("cylinder_push", ControllerConfig, {"horizon": 0.77})
    set_config_overrides("cylinder_push", mppi_cfg_cls, {"num_rollouts": 24})
    try:
        bus = MessageBus()
        node = ControllerNode(bus, "cartpole", "mppi")
        bus.publish("task", "cylinder_push")
        node.join_switch(timeout=300)
        assert node.controller.task.name == "cylinder_push"
        assert node.controller.controller_cfg.horizon == 0.77
        assert node.controller.optimizer_cfg.num_rollouts == 24
    finally:
        for cls, vals in saved.items():
            _OVERRIDE_REGISTRY[cls]["cylinder_push"] = vals


def test_cli_platform_accepts_gpu_and_refuses_tpu():
    import pytest

    from judo_tpu.cli import build_parser

    args = build_parser().parse_args(["--platform", "gpu", "run", "--task", "leap_cube"])
    assert args.platform == "gpu"
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--platform", "tpu", "run"])
