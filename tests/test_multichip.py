"""Multi-device execution: sharded env batches and the PPO train step over
the (env, model) mesh — on the 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np

from multigrid_tpu.envs import make
from multigrid_tpu.learn import ActorCritic, PPOConfig, make_train_step, ppo_init
from multigrid_tpu.parallel import VectorEnv, make_mesh


def test_sharded_train_step():
    """Full PPO update with env batch sharded over 8 devices."""
    mesh = make_mesh()
    env = make('MultiGrid-Empty-5x5-v0', agents=2)
    venv = VectorEnv(env, 16, mesh=mesh)
    state, net, config, tx = ppo_init(
        venv, jax.random.key(0),
        net=ActorCritic(hidden=16), config=PPOConfig(rollout_steps=2))
    train_step = make_train_step(venv, net, config, tx)
    state, metrics = train_step(state)
    assert np.isfinite(float(metrics['loss']))
    assert int(state.update_count) == 1
    # Env state stays sharded over the env axis after the update.
    assert state.env_state.grid.sharding.num_devices == 8


def test_weak_scaling_consistency():
    """Same total batch, sharded vs unsharded → identical rollout results."""
    env = make('MultiGrid-Empty-8x8-v0', agents=2)
    v1 = VectorEnv(env, 16)
    v8 = VectorEnv(env, 16, mesh=make_mesh())
    _, s1 = v1.reset(jax.random.key(5))
    _, s8 = v8.reset(jax.random.key(5))
    acts = jnp.zeros((16, 2), jnp.int32).at[:, 0].set(2)
    for _ in range(4):
        o1, s1, r1, *_ = v1.step(s1, acts)
        o8, s8, r8, *_ = v8.step(s8, acts)
    np.testing.assert_array_equal(np.asarray(s1.grid), np.asarray(s8.grid))
    np.testing.assert_array_equal(np.asarray(o1['image']),
                                  np.asarray(o8['image']))
    np.testing.assert_array_equal(np.asarray(r1), np.asarray(r8))


def test_sharded_train_step_with_reset_pool():
    """Full PPO update over the mesh on a PROCEDURAL env: exercises the
    chunked reserve-pool refresh (venv.refresh_pool after the rollout scan)
    with pool state sharded over the env axis."""
    mesh = make_mesh()
    env = make('MultiGrid-BlockedUnlockPickup-v0', agents=2, max_steps=6)
    venv = VectorEnv(env, 16, mesh=mesh)
    assert venv.reset_pool
    config = PPOConfig(rollout_steps=4)
    state, net, config, tx = ppo_init(
        venv, jax.random.key(0), config=config,
        net_kwargs=dict(encoder='mlp', hidden=32))
    train_step = make_train_step(venv, net, config, tx)
    for _ in range(2):
        state, metrics = train_step(state)
    assert np.isfinite(float(metrics['loss']))
    assert int(state.update_count) == 2
