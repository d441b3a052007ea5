"""Device-mesh helpers.

Environment batches shard over a data axis (``'env'``); learner parameters may
additionally shard over a model axis (``'model'``). The only collective the
env axis needs is the learner's gradient all-reduce; on one host's GPUs it
rides NVLink, which joins every pair of cards, so the device order of the
mesh does not matter.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_env_shards: int | None = None,
    n_model_shards: int = 1,
    *,
    devices: list | None = None,
) -> Mesh:
    """Create an ``(env, model)`` mesh over the available devices.

    With the defaults, all devices go to the env (data) axis — the natural
    layout for lockstep env batches, where the only cross-device communication
    is the learner's gradient ``psum``.
    """
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_env_shards is None:
        n_env_shards = n // n_model_shards
    assert n_env_shards * n_model_shards == n, (
        f'{n_env_shards} x {n_model_shards} != {n} devices'
    )
    dev_array = np.asarray(devices).reshape(n_env_shards, n_model_shards)
    return Mesh(dev_array, axis_names=('env', 'model'))


def env_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for per-env batched arrays: leading axis split over 'env'."""
    return NamedSharding(mesh, P('env'))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for replicated arrays (learner params, opt state)."""
    return NamedSharding(mesh, P())


def shard_batch(tree, mesh: Mesh):
    """Place a pytree of (E, ...) arrays with the leading axis sharded over
    the mesh's env axis."""
    sharding = env_sharding(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)
