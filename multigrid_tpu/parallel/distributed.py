"""Multi-host initialization and scaling helpers.

The reference has no distributed backend (SURVEY.md §5 — multi-process
execution only via Ray actors in its example scripts). Here multi-host runs
use JAX's native runtime: ``initialize()`` wires up ``jax.distributed``
with an explicit coordinator, after which ``make_mesh()`` spans all hosts'
devices and the same ``VectorEnv``/PPO code runs unchanged — env shards
never communicate, and only the gradient all-reduce crosses hosts.
"""

from __future__ import annotations

import jax


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize multi-host JAX. No-ops on single-process runs.

    With no arguments, relies on the cluster environment (e.g. SLURM) like
    ``jax.distributed.initialize`` itself does; a plain multi-process run
    on one machine passes ``coordinator_address='localhost:<port>'``,
    ``num_processes`` and ``process_id``.
    """
    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_env_batch(per_chip_envs: int) -> int:
    """Total env batch across all chips of all hosts."""
    return per_chip_envs * jax.device_count()


def process_summary() -> dict:
    """Topology info for logs/metrics."""
    return {
        'process_index': jax.process_index(),
        'process_count': jax.process_count(),
        'local_devices': jax.local_device_count(),
        'global_devices': jax.device_count(),
        'device_kind': jax.devices()[0].device_kind,
    }
