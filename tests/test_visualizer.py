"""Visualization-layer tests (headless): widget reflection, scene extraction,
visualizer state machine (reference: tests/test_visualizer.py there drives a
real ViserServer; here the backend-agnostic layer is tested directly)."""

import dataclasses

import numpy as np
import pytest

from judo_tpu.app.bus import MessageBus
from judo_tpu.app.structs import MujocoState
from judo_tpu.gui import slider
from judo_tpu.utils.fields import np_1d_field
from judo_tpu.visualizers import Visualizer, build_scene, reflect_config
from judo_tpu.visualizers.widgets import ConfigBinding


@slider("gain", 0.0, 10.0, 0.5)
@dataclasses.dataclass
class DemoCfg:
    gain: float = 2.0
    steps: int = 5
    enabled: bool = True
    goal: np.ndarray = np_1d_field(
        np.array([0.1, 0.2]), names=["x", "y"], mins=[-1, -1], maxs=[1, 1], steps=[0.01, 0.01],
        vis_name="goal_marker", xyz_vis_indices=[0, 1, None],
    )


def test_reflection_kinds():
    specs = {s.name: s for s in reflect_config(DemoCfg())}
    assert specs["gain"].kind == "slider"
    assert (specs["gain"].minimum, specs["gain"].maximum, specs["gain"].step) == (0.0, 10.0, 0.5)
    assert specs["steps"].kind == "int_slider"
    assert specs["enabled"].kind == "checkbox"
    assert specs["goal"].kind == "array"
    assert specs["goal"].vis_name == "goal_marker"
    assert [c.name for c in specs["goal"].children] == ["x", "y"]


def test_reflection_literal_dropdown():
    from judo_tpu.controller import ControllerConfig

    specs = {s.name: s for s in reflect_config(ControllerConfig())}
    assert specs["spline_order"].kind == "dropdown"
    assert set(specs["spline_order"].options) == {"zero", "linear", "cubic"}
    assert specs["horizon"].kind == "slider"


def test_binding_writes_values_and_sets_event():
    cfg = DemoCfg()
    binding = ConfigBinding(cfg)
    binding.set_value(("gain",), 7.5)
    assert cfg.gain == 7.5
    binding.set_value(("goal", "1"), -0.5)
    assert cfg.goal[1] == -0.5
    assert binding.changed.is_set()


def test_build_scene_from_cartpole():
    from judo_tpu.tasks import Cartpole

    np.random.seed(0)
    task = Cartpole()
    scene = build_scene(task.model)
    names = [b.name for b in scene.bodies]
    assert "cart" in names and "pole" in names
    cart = next(b for b in scene.bodies if b.name == "cart")
    assert cart.geoms[0].geom_type == "box"
    d = scene.to_dict()
    assert len(d["bodies"]) == task.model.nbody


def test_visualizer_state_machine():
    np.random.seed(0)
    bus = MessageBus()
    viz = Visualizer(bus, "cartpole", "ps")
    tree = viz.widget_tree()
    assert set(tree) == {"task", "optimizer", "controller"}

    published = []
    bus.subscribe("task", published.append)
    viz.set_task("cylinder_push")
    assert published == ["cylinder_push"]
    assert bus.read("optimizer_config") is not None

    # FK propagation from states
    import mujoco

    task = viz.available_tasks["cylinder_push"][0]()
    mujoco.mj_forward(task.model, task.data)
    msg = MujocoState(
        time=0.0, qpos=task.data.qpos.copy(), qvel=task.data.qvel.copy(),
        xpos=task.data.xpos.copy(), xquat=task.data.xquat.copy(),
        mocap_pos=task.data.mocap_pos.copy(), mocap_quat=task.data.mocap_quat.copy(),
        sim_metadata={},
    )
    bus.publish("states", msg)
    np.testing.assert_allclose(viz.scene.bodies[1].xpos, task.data.xpos[1])

    bus.publish("plan_time", 0.025)
    assert viz.plan_time_ms == pytest.approx(25.0)


def test_visualizer_reset_and_pause_topics():
    np.random.seed(0)
    bus = MessageBus()
    viz = Visualizer(bus, "cartpole", "ps")
    viz.reset_task()
    viz.pause_simulation()
    assert bus.read("task_reset") is True
    assert bus.read("sim_pause") is True


def test_goal_marker_protocol_roundtrip():
    """The draggable goal-marker flow at the protocol level:

    np_1d_field(xyz_vis_indices=...) must survive reflection and wire
    serialization (so the client can place the marker), and the exact
    {"type": "set"} element write a marker drag emits must land in the
    config array — the same path the reference's icosphere callbacks use
    (judo/gui.py:269-316).
    """
    from judo_tpu.tasks.cylinder_push import CylinderPushConfig
    from judo_tpu.visualizers.server import widget_to_dict

    cfg = CylinderPushConfig()
    specs = reflect_config(cfg)
    goal = next(s for s in specs if s.name == "goal_pos")
    assert goal.kind == "array"
    assert goal.xyz_vis_indices == [0, 1, None]

    # wire form carries the indices for the client
    wire = widget_to_dict(goal)
    assert wire["xyz_vis_indices"] == [0, 1, None]

    # a drag to world (0.31, -0.2) sends per-element set messages
    binding = ConfigBinding(cfg)
    binding.set_value(("goal_pos", "0"), 0.31)
    binding.set_value(("goal_pos", "1"), -0.2)
    np.testing.assert_allclose(cfg.goal_pos, [0.31, -0.2])
    assert binding.changed.is_set()  # consuming node republishes the config


def test_build_scene_renders_mesh_geoms():
    """User MJCF mesh assets reach the wire as triangle soups (the builtin
    scenes are mesh-free; reference mesh path: judo/visualizers/model.py)."""
    import mujoco

    from judo_tpu.visualizers.scene import build_scene

    xml = """
    <mujoco>
      <asset>
        <mesh name="tet" vertex="0 0 0  1 0 0  0 1 0  0 0 1"/>
      </asset>
      <worldbody>
        <body name="b"><freejoint/>
          <geom type="mesh" mesh="tet" rgba="0.8 0.2 0.2 1"/>
        </body>
      </worldbody>
    </mujoco>
    """
    model = mujoco.MjModel.from_xml_string(xml)
    scene = build_scene(model)
    geoms = [g for b in scene.bodies for g in b.geoms]
    mesh_geoms = [g for g in geoms if g.geom_type == "mesh"]
    assert len(mesh_geoms) == 1
    tri = mesh_geoms[0].mesh_tri
    assert tri is not None and tri.ndim == 3 and tri.shape[1:] == (3, 3)
    wire = scene.to_dict()
    wg = [g for b in wire["bodies"] for g in b["geoms"] if g["type"] == "mesh"]
    assert len(wg) == 1 and len(wg[0]["verts"]) == tri.size
