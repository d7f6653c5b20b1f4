"""Test fixtures.

Mirrors the reference test strategy (tests/conftest.py there) plus two
additions: tests run on a virtual 8-device CPU mesh so sharding paths are
exercised without accelerator hardware, and x64 is enabled so numeric parity
against CPU MuJoCo / scipy references can be checked tightly. Tests marked
``gpu`` need a CUDA device (``gpu_device`` fixture) and skip elsewhere;
``chip_smoke.py`` runs them on the card.
"""

import os

# Force CPU with 8 virtual devices so sharding tests exercise a real mesh,
# unless the run targets the GPU tests (JAX_PLATFORMS names another platform).
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = _flags + " --xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

# solve compiles dominate suite wall time; the package's persistent compile
# cache (judo_tpu.configure_compile_cache) keeps them across test processes
import judo_tpu  # noqa: E402, F401

from contextlib import contextmanager  # noqa: E402
from typing import Generator  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@contextmanager
def _temp_np_seed(seed: int) -> Generator[None, None, None]:
    """Seed numpy's global RNG, restoring prior state on exit.

    Parity with reference tests/conftest.py:12-26.
    """
    state = np.random.get_state()
    try:
        np.random.seed(seed)
        yield
    finally:
        np.random.set_state(state)


@pytest.fixture
def temp_np_seed():
    return _temp_np_seed


@pytest.fixture(autouse=True)
def _clear_override_registry():
    """Isolate the global config-override registry between tests."""
    from judo_tpu.config import clear_override_registry

    clear_override_registry()
    yield
    clear_override_registry()


@pytest.fixture
def task_text_xml_path(tmp_path):
    """Minimal inline MJCF used by index/task tests (no external assets).

    Same role as reference tests/conftest.py:29-69 (content written fresh).
    """
    xml = """
<mujoco model=\"test_box\">
  <option timestep=\"0.02\"/>
  <worldbody>
    <body name=\"box\" pos=\"0 0 0\">
      <joint name=\"jx\" type=\"slide\" axis=\"1 0 0\"/>
      <joint name=\"jy\" type=\"slide\" axis=\"0 1 0\"/>
      <joint name=\"jz\" type=\"slide\" axis=\"0 0 1\"/>
      <geom name=\"box_geom\" type=\"box\" size=\"0.1 0.1 0.1\" mass=\"1\"/>
      <site name=\"trace_site\" pos=\"0 0 0\" size=\"0.01\"/>
    </body>
  </worldbody>
  <actuator>
    <position name=\"ax\" joint=\"jx\" kp=\"10\" ctrlrange=\"-1 1\"/>
    <position name=\"ay\" joint=\"jy\" kp=\"10\" ctrlrange=\"-1 1\"/>
    <position name=\"az\" joint=\"jz\" kp=\"10\" ctrlrange=\"-1 1\"/>
  </actuator>
  <sensor>
    <framepos name=\"trace_site\" objtype=\"site\" objname=\"trace_site\"/>
  </sensor>
</mujoco>
"""
    p = tmp_path / "test_box.xml"
    p.write_text(xml)
    return str(p)


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test where JAX has none. Decided
    here, at run time, never at import, so every test worker collects the
    same tests."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a CUDA GPU (chip_smoke.py runs the gpu tests on the card)")
    return devices[0]
