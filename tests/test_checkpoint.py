"""The .npz checkpoint format (utils/checkpoint.py): round trip, params-only
restore, and the errors for mismatched or foreign checkpoints."""

import os

import jax
import numpy as np
import pytest

from multigrid_tpu.envs import make
from multigrid_tpu.learn import PPOConfig, ppo_init
from multigrid_tpu.parallel import VectorEnv
from multigrid_tpu.utils.checkpoint import (
    restore_checkpoint, restore_params, save_checkpoint)


def _state(env_id='MultiGrid-RedBlueDoors-6x6-v0', seed=0, **cfg):
    venv = VectorEnv(make(env_id, agents=2), 4, packed_obs=True)
    state, *_ = ppo_init(venv, jax.random.key(seed),
                         config=PPOConfig(rollout_steps=2, **cfg),
                         net_kwargs=dict(encoder='mlp', hidden=8))
    return state


def _equal(a, b):
    def plain(x):
        if jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key):
            x = jax.random.key_data(x)
        return np.asarray(x)
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    return len(la) == len(lb) and all(
        plain(x).shape == plain(y).shape
        and np.array_equal(plain(x), plain(y)) for x, y in zip(la, lb))


def test_npz_roundtrip_keys_pool_and_zero_size_leaves(tmp_path):
    """A whole TrainState — typed PRNG keys, the reserve pool in extras and
    a box-free env's zero-size box_contents — restores bit-exactly; the
    write leaves one state.npz and no temporary file."""
    state = _state()
    assert state.env_state.box_contents.size == 0
    assert any('_vec:' in k for k in state.env_state.extras)
    path = save_checkpoint(str(tmp_path / 'step_1'), state)
    assert os.listdir(path) == ['state.npz']
    save_checkpoint(path, state)  # overwriting in place is atomic too
    assert os.listdir(path) == ['state.npz']
    restored = restore_checkpoint(path, _state(seed=1))
    assert _equal(restored, state)
    assert jax.dtypes.issubdtype(restored.key.dtype, jax.dtypes.prng_key)


def test_restore_params_from_centralized_per_agent_state(tmp_path):
    """Params-only restore picks the params/ leaves out of a whole-state
    checkpoint, whatever the optimizer state looks like."""
    state = _state(per_agent_policies=True, centralized_critic=True)
    path = save_checkpoint(str(tmp_path / 'best'), state)
    target = _state(seed=3, per_agent_policies=True,
                    centralized_critic=True).params
    assert not _equal(target, state.params)
    assert _equal(restore_params(path, target), state.params)


def test_mismatched_and_foreign_checkpoints_fail_loudly(tmp_path):
    path = save_checkpoint(str(tmp_path / 'step_1'), _state())
    # Another grid size: env-state leaves change shape.
    with pytest.raises(ValueError, match='env-config mismatch'):
        restore_checkpoint(path, _state('MultiGrid-RedBlueDoors-8x8-v0'))
    # Another net: a parameter changes shape.
    venv = VectorEnv(make('MultiGrid-RedBlueDoors-6x6-v0', agents=2), 4,
                     packed_obs=True)
    other, *_ = ppo_init(venv, jax.random.key(0),
                         net_kwargs=dict(encoder='mlp', hidden=16))
    with pytest.raises(ValueError, match='model mismatch'):
        restore_params(path, other.params)
    # A directory without state.npz (e.g. an old-format checkpoint).
    os.makedirs(tmp_path / 'old')
    with pytest.raises(ValueError, match='no state.npz'):
        restore_params(str(tmp_path / 'old'), other.params)
