"""chip_smoke.py and the GPU-only measurement guard refuse to run without a
GPU: no result line, non-zero exit."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from judo_tpu.utils.device import device_record, require_gpu

REPO = Path(__file__).resolve().parent.parent


def test_require_gpu_refuses_cpu():
    assert device_record()["platform"] == "cpu"
    with pytest.raises(RuntimeError, match="needs a GPU"):
        require_gpu()


def test_chip_smoke_fails_without_gpu():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
