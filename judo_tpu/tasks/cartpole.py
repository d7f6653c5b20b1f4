"""Cartpole balancing task (reference: judo/tasks/cartpole.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import jax.numpy as jnp
import numpy as np

from judo_tpu import MODEL_PATH
from judo_tpu.ops.costs import quadratic_norm, smooth_l1_norm
from judo_tpu.tasks.base import Task, TaskConfig

XML_PATH = str(MODEL_PATH / "xml" / "cartpole.xml")


@dataclass
class CartpoleConfig(TaskConfig):
    """MJPC-style cartpole reward weights (cartpole.py:20-27)."""

    w_vertical: float = 10.0
    w_centered: float = 10.0
    w_velocity: float = 0.1
    w_control: float = 0.1
    p_vertical: float = 0.01
    p_centered: float = 0.1


class Cartpole(Task[CartpoleConfig]):
    """Swing up and balance the pole while centering the cart."""

    name: str = "cartpole"
    config_t: type[CartpoleConfig] = CartpoleConfig

    def __init__(self, model_path: str = XML_PATH, sim_model_path: str | None = None) -> None:
        super().__init__(model_path=model_path, sim_model_path=sim_model_path)
        self.reset()

    def reward(
        self,
        states: jnp.ndarray,
        sensors: jnp.ndarray,
        controls: jnp.ndarray,
        params: dict[str, Any],
        system_metadata: dict[str, Any] | None = None,
    ) -> jnp.ndarray:
        """Four penalties summed over time (cartpole.py:64-78): pole-vertical,
        cart-centered (both smooth-L1), quadratic velocity and control."""
        vertical = -params["w_vertical"] * smooth_l1_norm(
            jnp.cos(states[..., 1]) - 1.0, params["p_vertical"]
        ).sum(-1)
        centered = -params["w_centered"] * smooth_l1_norm(states[..., 0], params["p_centered"]).sum(-1)
        velocity = -params["w_velocity"] * quadratic_norm(states[..., 2:]).sum(-1)
        control = -params["w_control"] * quadratic_norm(controls).sum(-1)
        return vertical + centered + velocity + control

    def reset(self) -> None:
        """Random reset around [1, pi] (cartpole.py:80-84)."""
        self.data.qpos = np.array([1.0, np.pi]) + np.random.randn(2)
        self.data.qvel = 1e-1 * np.random.randn(2)
        self.forward()
