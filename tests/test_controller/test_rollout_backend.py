"""Rollout-backend choice: what ``auto`` resolves to per JAX platform, and
refusal of names that are not backends."""

import jax
import numpy as np
import pytest

from judo_tpu.controller import Controller, ControllerConfig
from judo_tpu.optimizers import MPPI, MPPIConfig
from judo_tpu.tasks import get_registered_tasks


def _controller(rollout_backend: str = "auto") -> Controller:
    np.random.seed(0)
    task = get_registered_tasks()["cylinder_push"][0]()
    opt = MPPI(MPPIConfig(num_rollouts=4, num_nodes=4), task.nu)
    return Controller(ControllerConfig(horizon=0.1), task, opt, rollout_backend=rollout_backend)


@pytest.mark.parametrize("alias", ["auto", "judo_tpu"])
def test_auto_resolves_to_vmap_on_gpu(monkeypatch, alias):
    """vmap: lanes_xla is faster on the H200 but fails mj_step parity on
    leap_cube (PERF.md), so auto never picks it."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    c = _controller(alias)
    assert c._resolve_rollout_backend() == "vmap"


def test_auto_resolves_to_vmap_on_cpu():
    assert _controller()._resolve_rollout_backend() == "vmap"


def test_lanes_backend_refuses_uncovered_model(monkeypatch):
    from judo_tpu.physics import lane_rollout

    monkeypatch.setattr(lane_rollout, "lane_supported", lambda m: False)
    with pytest.raises(ValueError, match="does not cover"):
        _controller("lanes_xla")


@pytest.mark.parametrize("name", ["lanes_pallas", "pallas", "tpu"])
def test_unknown_backend_raises(name):
    with pytest.raises(ValueError, match="unknown rollout_backend"):
        _controller(name)
