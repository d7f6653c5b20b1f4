"""Batched rigid-body physics in JAX.

This subpackage replaces the reference's CPU rollout engines — the threaded
``mujoco.rollout`` backend (judo/utils/mj_rollout_backend.py) and the C++
``mujoco_extensions`` System rollout (mujoco_extensions/system/system_class.cpp)
— with a from-scratch JAX implementation of the MuJoCo computation pipeline:
models are compiled host-side with MuJoCo's MJCF compiler, lowered into a
static-shaped pytree, and stepped on device with jit/vmap/scan.
"""

from judo_tpu.physics.model import PhysicsModel, PhysicsState, make_state, put_model
from judo_tpu.physics.step import forward, rollout, step

__all__ = ["PhysicsModel", "PhysicsState", "forward", "make_state", "put_model", "rollout", "step"]
