"""Checkpoint / resume as one ``.npz`` of path-keyed leaves.

The reference delegates checkpointing entirely to RLlib's Tuner
(multigrid/scripts/train.py:184-195); here env state is a pytree of arrays,
so training state (params, optimizer state, env batch, RNG) checkpoints and
restores as a single atomic save — including mid-episode environment
state, which the reference cannot capture at all.

A checkpoint is a directory holding ``state.npz``: one array per leaf, keyed
by the leaf's path in the tree (``params/params/Dense_0/kernel``). The file
is written under a temporary name in the same directory and renamed into
place, so a reader never sees a partial checkpoint.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any

import jax
import numpy as np

_FILE = 'state.npz'


def _is_key(x) -> bool:
    return hasattr(x, 'dtype') and jax.dtypes.issubdtype(
        x.dtype, jax.dtypes.prng_key)


def _flatten(tree) -> tuple[list[str], list, Any]:
    with_path, treedef = jax.tree_util.tree_flatten_with_path(tree)
    return ([jax.tree_util.keystr(p, simple=True, separator='/')
             for p, _ in with_path],
            [x for _, x in with_path], treedef)


def _load(path: str) -> dict[str, np.ndarray]:
    f = os.path.join(os.path.abspath(path), _FILE)
    if not os.path.isfile(f):
        raise ValueError(
            f'{path} holds no {_FILE}: not a checkpoint written by '
            'save_checkpoint (checkpoints from before the .npz format do '
            'not load)')
    with np.load(f) as data:
        return {k: data[k] for k in data.files}


def save_checkpoint(path: str, state: Any) -> str:
    """Atomically save a pytree (TrainState or env state) to ``path``.

    Typed PRNG keys are stored as their raw key data (numpy cannot hold
    extended dtypes) and re-wrapped on restore.
    """
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    names, leaves, _ = _flatten(state)
    arrays = {
        n: np.asarray(jax.random.key_data(x) if _is_key(x) else x)
        for n, x in zip(names, leaves)
    }
    fd, tmp = tempfile.mkstemp(dir=path, suffix='.tmp')
    try:
        with os.fdopen(fd, 'wb') as f:
            np.savez(f, **arrays)
        os.replace(tmp, os.path.join(path, _FILE))
    except BaseException:
        os.unlink(tmp)
        raise
    return path


def _place(t, r: np.ndarray):
    """Restore one leaf against its target ``t`` (shape-checked)."""
    if _is_key(t):
        return jax.random.wrap_key_data(
            jax.numpy.asarray(r), impl=jax.random.key_impl(t))
    if t.size == 0 and r.size:
        # Box-free envs carry a zero-size (0, 0, 3) box_contents table; real
        # data here means the checkpoint was written under a different env
        # config (e.g. a uses_boxes=True env restored into a box-free one).
        raise ValueError(
            f'checkpoint/env-config mismatch: stored leaf has shape '
            f'{r.shape} but the restore target expects a zero-size array '
            f'(shape {t.shape}); the checkpoint was likely written under a '
            f'different environment configuration')
    if r.shape != t.shape:
        raise ValueError(
            f'checkpoint/env-config mismatch: stored leaf has shape '
            f'{r.shape} but the restore target expects {t.shape}; the '
            f'checkpoint was likely written under a different environment '
            f'configuration')
    return jax.device_put(jax.numpy.asarray(r)).astype(t.dtype)


def restore_checkpoint(path: str, target: Any) -> Any:
    """Restore a pytree saved by :func:`save_checkpoint`.

    ``target`` supplies the structure/dtypes (e.g. a freshly-initialized
    TrainState); every leaf of the checkpoint must match one of the
    target's by path and shape.
    """
    stored = _load(path)
    names, leaves, treedef = _flatten(target)
    missing = sorted(set(names) - set(stored))
    extra = sorted(set(stored) - set(names))
    if missing or extra:
        raise ValueError(
            f'checkpoint/env-config mismatch: {path} lacks leaves '
            f'{missing[:5]} and has unexpected leaves {extra[:5]}; the '
            f'checkpoint was likely written under a different configuration')
    return jax.tree_util.tree_unflatten(treedef, [
        _place(t, stored[n]) for n, t in zip(names, leaves)])


def restore_params(path: str, target_params: Any) -> Any:
    """Restore ONLY the model parameters from a TrainState checkpoint.

    Evaluation/visualization need the params, not the optimizer state —
    and the opt_state pytree structure depends on training-time optimizer
    config (``--lr-anneal`` wraps adam in a schedule, adding a state leaf),
    so a whole-TrainState restore would force eval-side flags to mirror
    irrelevant training flags. Reads the ``params/...`` leaves and places
    them against ``target_params`` (shape-checked like
    :func:`restore_checkpoint`).
    """
    stored = _load(path)
    if not any(k.startswith('params/') for k in stored):
        raise ValueError(
            f'{path} does not look like a TrainState checkpoint '
            f'(top-level keys: {sorted({k.split("/")[0] for k in stored})})')
    names, leaves, treedef = _flatten(target_params)
    missing = [n for n in names if 'params/' + n not in stored]
    if missing:
        raise ValueError(
            f'checkpoint/model mismatch: {path} has no parameters '
            f'{missing[:5]}')
    for n, t in zip(names, leaves):
        r = stored['params/' + n]
        if r.shape != t.shape:
            raise ValueError(
                f'checkpoint/model mismatch: stored parameter has shape '
                f'{r.shape} but the target expects {t.shape}')
    return jax.tree_util.tree_unflatten(treedef, [
        _place(t, stored['params/' + n]) for n, t in zip(names, leaves)])


def latest_checkpoint(directory: str) -> str | None:
    """Most recent ``step_*`` checkpoint under ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [
        d for d in os.listdir(directory)
        if d.startswith('step_') and d.split('_')[-1].isdigit()
    ]
    if not steps:
        return None
    best = max(steps, key=lambda d: int(d.split('_')[-1]))
    return os.path.join(directory, best)
