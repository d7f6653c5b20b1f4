"""Mesh reachability from the product surface.

The reference's parallelism knob is user-reachable (GUI thread-count resize,
judo/utils/rollout_backend.py:10-47); this build's equivalent is the
``--mesh`` CLI flag -> ControllerNode(mesh=...) -> sharded solve. These tests
drive that path on the 8-virtual-CPU mesh from conftest, asserting the batch
really shards without touching Controller internals to SET anything up.
"""

import jax
import numpy as np
import pytest

from judo_tpu.app.bus import MessageBus
from judo_tpu.app.nodes import ControllerNode, SimulationNode
from judo_tpu.parallel import ROLLOUT_AXIS
from judo_tpu.parallel.mesh import resolve_mesh

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs the multi-device CPU mesh from conftest"
)


def test_resolve_mesh_specs():
    assert resolve_mesh(None) is None
    assert resolve_mesh("none") is None
    assert resolve_mesh("") is None
    m = resolve_mesh("auto")
    assert m is not None and m.devices.size == len(jax.devices())
    assert resolve_mesh(m) is m
    with pytest.raises(ValueError):
        resolve_mesh("bogus")


def test_controller_node_mesh_shards_batch():
    """ControllerNode(mesh='auto') plans with the batch partitioned over the
    mesh — the CLI `run --mesh auto` path end to end (minus arg parsing)."""
    np.random.seed(0)
    bus = MessageBus()
    sim = SimulationNode(bus, "cylinder_push")
    node = ControllerNode(bus, "cylinder_push", "mppi", mesh="auto")
    ndev = len(jax.devices())
    # num_rollouts must divide over the mesh; the stock override is 32 on 8
    assert node.controller.optimizer_cfg.num_rollouts % ndev == 0
    node.controller.controller_cfg.full_outputs = True  # inspect states sharding
    sim.step_once()
    node.step_once()
    out = node.controller.last_outputs
    assert out is not None
    sharding = out.states.sharding
    # the candidate/batch axis is partitioned over the rollout mesh axis
    spec = sharding.spec
    assert spec[0] is not None and ROLLOUT_AXIS in str(spec[0])
    assert len(sharding.device_set) == ndev


def test_cli_mesh_flag_plumbs_through(monkeypatch):
    """`run --mesh auto` reaches ControllerNode without a full spin."""
    import judo_tpu.cli as cli

    captured = {}

    class FakeNode:
        def __init__(self, bus, task, optimizer, mesh=None):
            captured["mesh"] = mesh
            raise KeyboardInterrupt  # abort _cmd_run right after construction

    parser = cli.build_parser()
    args = parser.parse_args(["run", "--task", "cylinder_push", "--mesh", "auto"])
    monkeypatch.setattr("judo_tpu.app.nodes.ControllerNode", FakeNode)
    with pytest.raises(KeyboardInterrupt):
        cli._cmd_run(args)
    assert captured["mesh"] == "auto"
