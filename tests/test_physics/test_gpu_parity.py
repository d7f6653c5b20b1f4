"""On the card: the float32 leap_cube rollout against CPU MuJoCo's mj_step.

The reference trajectory is committed with the package
(judo_tpu/tasks/exported.py), so this runs where mujoco is not installed.
The bound is the CPU float64 test's (test_scene_parity.py): the f64 error
there (0.0097) is the solver's model difference from MuJoCo, and f32 adds
little to it. It is checked at the solve's own matmul precision, "highest"
(Controller._build_solve pins it; the GPU's default would allow TF32).
"""

import jax
import pytest

from judo_tpu.tasks.exported import rollout_parity_error

TOL = 0.03
PRECISION = "highest"  # the solve's (Controller._build_solve)


@pytest.mark.gpu
def test_leap_f32_rollout_matches_mj_step_on_gpu(gpu_device):
    with jax.default_device(gpu_device):
        err = rollout_parity_error("vmap", PRECISION)
    assert err < TOL, f"max |qpos| error {err} >= {TOL} at precision {PRECISION}"


def test_leap_f32_rollout_matches_mj_step_on_cpu():
    """The same check on the CPU."""
    err = rollout_parity_error("vmap", PRECISION)
    assert err < TOL, f"max |qpos| error {err} >= {TOL} at precision {PRECISION}"
