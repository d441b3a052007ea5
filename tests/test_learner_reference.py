"""The train step's loss and gradients against the plain float32 reference
(learn/reference.py), on one small batch per learner configuration."""

import jax
import jax.numpy as jnp
import pytest

from multigrid_tpu.envs import make
from multigrid_tpu.learn import PPOConfig, Rollout, make_train_step, ppo_init
from multigrid_tpu.learn.reference import (
    GRAD_RTOL, LOSS_RTOL, compare_with_reference, ppo_loss_f32)
from multigrid_tpu.parallel import VectorEnv


def _batch(venv, obs, key, t=3):
    """A (T, E, N) rollout of real observations with random actions,
    behaviour log-probs, advantages and value targets."""
    e, n = venv.num_envs, venv.num_agents
    ks = jax.random.split(key, 4)

    def tile(x):
        return jnp.broadcast_to(x, (t,) + x.shape)

    traj = Rollout(
        image=tile(obs['image']), direction=tile(obs['direction']),
        action=jax.random.randint(ks[0], (t, e, n), 0, 7),
        log_prob=jnp.log(jax.random.uniform(
            ks[1], (t, e, n), minval=0.05, maxval=0.4)),
        value=jnp.zeros((t, e, n)), reward=jnp.zeros((t, e, n)),
        done=jnp.zeros((t, e, n), bool), mission=(
            tile(obs['mission']) if 'mission' in obs else None))
    adv = jax.random.normal(ks[2], (t, e, n))
    tgt = jax.random.normal(ks[3], (t, e, n))
    return traj, adv, tgt


CASES = {
    'shared': ('MultiGrid-Empty-5x5-v0', 2, 'mlp', {}),
    'per_agent': ('MultiGrid-Empty-5x5-v0', 3, 'mlp',
                  dict(per_agent_policies=True)),
    'centralized': ('MultiGrid-Empty-5x5-v0', 2, 'mlp',
                    dict(per_agent_policies=True, centralized_critic=True)),
    'missions': ('MultiGrid-BlockedUnlockPickup-v0', 2, 'mlp', {}),
    'cnn': ('MultiGrid-Empty-5x5-v0', 2, 'cnn', {}),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_loss_and_grads_match_f32_reference(case):
    env_id, agents, encoder, cfg = CASES[case]
    venv = VectorEnv(make(env_id, agents=agents), 4, packed_obs=True)
    state, net, config, tx = ppo_init(
        venv, jax.random.key(0), config=PPOConfig(rollout_steps=2, **cfg),
        net_kwargs=dict(encoder=encoder, hidden=32))
    traj, adv, tgt = _batch(venv, state.last_obs, jax.random.key(1))
    train_step = make_train_step(venv, net, config, tx)
    out = compare_with_reference(
        train_step, net, config, state.params, traj, adv, tgt)
    assert out['loss_rel_err'] <= LOSS_RTOL, out
    assert out['grad_rel_err'] <= GRAD_RTOL, out
    assert out['ok']


def test_reference_is_exact_in_f32():
    """With the net computing in float32, the train step's loss equals the
    reference to float32 rounding: the two differ only in how they are
    written, not in what they compute."""
    import dataclasses
    venv = VectorEnv(make('MultiGrid-Empty-5x5-v0', agents=2), 4,
                     packed_obs=True)
    config = PPOConfig(rollout_steps=2, per_agent_policies=True)
    state, net, config, tx = ppo_init(
        venv, jax.random.key(2), config=config,
        net_kwargs=dict(encoder='mlp', hidden=16))
    net32 = dataclasses.replace(net, dtype=jnp.float32)
    traj, adv, tgt = _batch(venv, state.last_obs, jax.random.key(3))
    step = make_train_step(venv, net32, config, tx)
    with jax.default_matmul_precision('highest'):
        loss, _ = step.loss_fn(state.params, traj, adv, tgt)
        ref, _ = ppo_loss_f32(net32, config, state.params, traj, adv, tgt)
    assert abs(float(loss) - float(ref)) <= 1e-5 * abs(float(ref))
