"""Profiling hooks (SURVEY §5.1; an addition over the reference).

The reference has plan-time telemetry only (perf_counter around
update_action, judo/app/dora/controller.py:138-142). Here:

- ``Controller.last_plan_timing`` gives the per-solve stage split
  (prep / device / sync) with no configuration;
- ``trace(logdir)`` wraps a block in a jax.profiler trace so the on-device
  timeline (per-fusion, per-kernel) can be inspected in
  TensorBoard/Perfetto — use around a few solves, not a whole benchmark;
- ``annotate(name)`` labels a host-side region inside a live trace.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator


@contextmanager
def trace(logdir: str) -> Iterator[None]:
    """jax.profiler trace around a block: ``with profiling.trace("/tmp/tr"):``"""
    import jax.profiler

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named host region inside an active trace (TraceAnnotation)."""
    import jax.profiler

    with jax.profiler.TraceAnnotation(name):
        yield
