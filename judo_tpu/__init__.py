"""judo_tpu: a sampling-based MPC framework on JAX.

A ground-up JAX/XLA rebuild of the capabilities of bdaiinstitute/judo. The
rollout+cost inner loop is a jitted, vmapped, mesh-sharded pure function
instead of CPU threads; physics is a batched JAX rigid-body engine (models
compiled host-side via MuJoCo's MJCF compiler, stepped on-device); optimizers
are pure sample/score/update transforms.

Reference entry point parity: judo/__init__.py (PACKAGE_ROOT / MODEL_PATH).
"""

import os
from pathlib import Path

import jax

PACKAGE_ROOT = Path(__file__).parent
MODEL_PATH = PACKAGE_ROOT / "models"
# compile-cache directory when JAX_COMPILATION_CACHE_DIR is unset (git-ignored)
DEFAULT_COMPILE_CACHE = PACKAGE_ROOT.parent / ".jax_cache"


def configure_compile_cache() -> Path | None:
    """Turn on JAX's persistent compile cache: contact-rich solve graphs take
    tens of seconds to compile, and the cache carries them across processes.

    JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself, so when it is set this
    sets nothing and returns None. Otherwise the cache goes to
    ``DEFAULT_COMPILE_CACHE``, which is returned. JAX keys cache entries by
    platform and compile options, so CPU and GPU processes share the
    directory safely."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_COMPILE_CACHE))
    return DEFAULT_COMPILE_CACHE


configure_compile_cache()

__version__ = "0.1.0"

__all__ = [
    "PACKAGE_ROOT", "MODEL_PATH", "DEFAULT_COMPILE_CACHE", "configure_compile_cache", "__version__",
]
