"""Device-mesh data parallelism over the rollout batch — within and across hosts.

The reference's only parallel axis is the candidate-rollout batch, executed as
R CPU threads (judo/utils/mj_rollout_backend.py:32-88, SURVEY §2.2). Here the
same axis shards over the device mesh: the solver annotates candidate tensors
with a NamedSharding over the rollout axes and lets XLA/GSPMD partition the
batched physics and insert the reward-reduction collectives (argmax / softmax
normalization / top_k).

Scale-out story:

- 1 device: trivial 1-device mesh (or ``mesh=None``).
- 1 host, k devices: ``make_rollout_mesh()`` — 1D mesh, batch split k ways;
  one process drives all local devices and the reductions ride the
  device interconnect.
- N hosts: call ``initialize_distributed()`` first (jax.distributed bootstrap;
  one process per host), then ``make_rollout_mesh(hybrid=True)`` — a
  (hosts, devices/host) mesh whose HOST axis is outermost, so each host's
  shard of the candidate batch lives entirely on its local devices: the only
  cross-host traffic is the O(R) reward reduction and the O(N*nu) nominal
  update.

The solver code is mesh-shape agnostic: ``rollout_sharding`` shards the batch
over ALL mesh axes, so 1D single-host and 2D multi-host meshes use the same
jitted solve.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

ROLLOUT_AXIS = "rollouts"
HOST_AXIS = "hosts"


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Bootstrap jax.distributed for multi-host execution.

    One call per host process before any jax computation, with the
    coordinator's ``host:port``, the process count and this process's id
    (arguments, or the env vars JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID). Without a coordinator this is a no-op (single process:
    one process drives every local device). Idempotent: safe to call when
    already initialized.

    Replaces: nothing in the reference — judo is single-host by design
    (SURVEY §5.8); this is the multi-host scale-out entry point.
    """
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None and num_processes is None:
        return
    if num_processes is not None and coordinator_address is None:
        raise ValueError(
            "initialize_distributed: num_processes given without a "
            "coordinator_address (argument or JAX_COORDINATOR_ADDRESS env)."
        )
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:  # swallow only double-init; surface real failures
        if "already initialized" not in str(e).lower():
            raise


def make_rollout_mesh(
    n_devices: int | None = None,
    devices=None,
    hybrid: bool = False,
    devices_per_host: int | None = None,
) -> Mesh:
    """Mesh over the rollout-batch axis.

    ``hybrid=False``: 1D (rollouts,) mesh — single host.
    ``hybrid=True``:  2D (hosts, rollouts) mesh with the host axis outermost;
    ``devices_per_host`` defaults to ``jax.local_device_count()``. jax orders
    ``jax.devices()`` process-major, so reshaping to (hosts, local) puts each
    host's devices in one row and the batch shard for a host never crosses
    hosts except in the final reductions.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    devices = np.asarray(devices)
    if not hybrid:
        return Mesh(devices, (ROLLOUT_AXIS,))
    local = devices_per_host or jax.local_device_count()
    n_hosts = len(devices) // local
    assert n_hosts * local == len(devices), (
        f"{len(devices)} devices do not tile into hosts of {local}"
    )
    return Mesh(devices.reshape(n_hosts, local), (HOST_AXIS, ROLLOUT_AXIS))


def resolve_mesh(spec) -> Mesh | None:
    """User-facing mesh spec -> Mesh (the CLI/app-layer entry point).

    - ``None`` / ``"none"`` / ``""``: no mesh (single-device solve).
    - ``"auto"``: 1D mesh over all visible devices, or None when only one
      device is visible (so CLI defaults work unchanged on a laptop CPU or a
      single GPU).
    - ``"hybrid"``: (hosts, devices/host) mesh; call
      ``initialize_distributed()`` first on multi-host deployments.
    - a ``jax.sharding.Mesh``: passed through.

    Replaces: the reference's user-reachable parallelism knob
    (judo/utils/rollout_backend.py:10-47 — thread-count resize from the GUI).
    """
    if spec is None or spec in ("none", ""):
        return None
    if isinstance(spec, Mesh):
        return spec
    if spec == "auto":
        return make_rollout_mesh() if len(jax.devices()) > 1 else None
    if spec == "hybrid":
        initialize_distributed()
        return make_rollout_mesh(hybrid=True)
    raise ValueError(f"unknown mesh spec {spec!r} (expected none|auto|hybrid or a Mesh)")


def rollout_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for (R, ...) tensors: batch split over ALL mesh axes (a 1D
    mesh splits over local devices; a hybrid mesh splits hosts-outer,
    devices-inner)."""
    return NamedSharding(mesh, PartitionSpec(tuple(mesh.axis_names)))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())
