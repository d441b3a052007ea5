"""Phase-level training-throughput profile on the device.

Times, at the flagship config, each nested stage of the PPO train step:

  A. env-only rollout (no policy)            — bench.py's number
  B. rollout with policy forward, no storage — adds the per-step net apply
  C. full rollout_phase (stores trajectory)  — adds the (T, ...) stacking
  D. rollout + GAE                           — adds the reverse scan
  E. full train_step (loss + backward + opt) — the trained number

Every stage is a jitted scan over enough steps to swamp per-call dispatch;
completion is a host transfer of a checksum that depends on the measured
computation.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multigrid_tpu.envs import make
from multigrid_tpu.learn import ActorCritic, PPOConfig, make_train_step, ppo_init
from multigrid_tpu.learn.ppo import make_train_loop
from multigrid_tpu.parallel import VectorEnv


def timed(fn, *args, reps=3):
    """Median wall time of fn(*args) with host-transfer completion."""
    out = fn(*args)
    jax.tree.map(lambda x: jnp.asarray(x).block_until_ready(), out)
    # honest barrier: pull one scalar to host
    leaf = jax.tree.leaves(out)[0]
    float(jnp.asarray(leaf).ravel()[0])
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        leaf = jax.tree.leaves(out)[0]
        float(jnp.asarray(leaf).ravel()[0])
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--num-envs', type=int, default=4096)
    p.add_argument('--agents', type=int, default=4)
    p.add_argument('--env-id', default='MultiGrid-Empty-16x16-v0')
    p.add_argument('--encoder', default='mlp', choices=['mlp', 'cnn'])
    p.add_argument('--rollout-steps', type=int, default=16)
    p.add_argument('--updates-per-call', type=int, default=8)
    p.add_argument('--stages', default='ABCE',
                   help='subset of stages to run (compile time adds up)')
    args = p.parse_args()

    env = make(args.env_id, agents=args.agents)
    venv = VectorEnv(env, args.num_envs)
    config = PPOConfig(rollout_steps=args.rollout_steps)
    net = ActorCritic(encoder=args.encoder)
    state, net, config, tx = ppo_init(
        venv, jax.random.key(0), net=net, config=config)

    upc = args.updates_per_call
    T = config.rollout_steps
    steps_per_call = T * upc
    agent_steps = args.num_envs * args.agents * steps_per_call

    results = {}

    def emit(k, rate):
        results[k] = rate
        print(f'{k:28s} {rate/1e6:8.1f} M agent-steps/s', flush=True)

    # ---- A: env-only --------------------------------------------------------
    if 'A' in args.stages:
        _, st = venv.reset(jax.random.key(1))
        def env_only(st):
            return venv.rollout_random(st, jax.random.key(2), steps_per_call)
        st, summary = env_only(st)
        int(summary['obs_sum'])
        t0 = time.perf_counter()
        st, summary = env_only(st)
        int(summary['obs_sum'])
        dt = time.perf_counter() - t0
        emit('A_env_only', agent_steps / dt)

    # ---- B/C/D/E: nested train-step stages ----------------------------------
    # Rebuild the internals the same way make_train_step does.
    from multigrid_tpu.learn import ppo as ppo_mod
    ts_full = make_train_loop(venv, net, config, tx, upc)

    def policy(params, obs):
        return net.apply(params, obs['image'], obs['direction'],
                         obs.get('mission'))

    @jax.jit
    def rollout_nostore(state):
        def body(carry, _):
            env_state, obs, key, acc = carry
            key, k_act = jax.random.split(key)
            logits, value = policy(state.params, obs)
            action = jax.random.categorical(k_act, logits)
            next_obs, env_state, reward, term, trunc, done, _ = venv.step(
                env_state, action.astype(jnp.int32))
            acc = acc + reward.sum() + value.sum()
            return (env_state, next_obs, key, acc), None
        (env_state, obs, key, acc), _ = jax.lax.scan(
            body, (state.env_state, state.last_obs, state.key,
                   jnp.zeros((), jnp.float32)),
            None, length=steps_per_call)
        return acc

    if 'B' in args.stages:
        dt = timed(rollout_nostore, state)
        emit('B_rollout_policy_nostore', agent_steps / dt)

    # C: full rollout_phase incl. storage (scan over upc rollouts)
    train_step_parts = ppo_mod.make_train_step(venv, net, config, tx)

    @jax.jit
    def rollout_store(state):
        def body(s, _):
            # reuse rollout via a train step with zero SGD work: compute
            # trajectory + GAE but skip the update by summing them.
            s2, traj, last_value = _rollout(s)
            acc = traj.reward.sum() + traj.value.sum() + last_value.sum()
            return s2, acc
        state2, accs = jax.lax.scan(body, state, None, length=upc)
        return accs.sum()

    # grab rollout_phase via closure surgery: rebuild it here identically
    def _rollout(state):
        def body(carry, _):
            env_state, obs, key = carry
            key, k_act = jax.random.split(key)
            logits, value = policy(state.params, obs)
            action = jax.random.categorical(k_act, logits)
            log_prob = jnp.take_along_axis(
                jax.nn.log_softmax(logits), action[..., None], axis=-1
            ).squeeze(-1)
            next_obs, env_state, reward, term, trunc, done, _ = venv.step(
                env_state, action.astype(jnp.int32))
            step_data = ppo_mod.Rollout(
                image=obs['image'], direction=obs['direction'],
                action=action, log_prob=log_prob, value=value,
                reward=reward, done=done[:, None] | term,
                mission=obs.get('mission'))
            return (env_state, next_obs, key), step_data
        (env_state, last_obs, key), traj = jax.lax.scan(
            body, (state.env_state, state.last_obs, state.key),
            None, length=T)
        _, last_value = policy(state.params, last_obs)
        state = state.replace(env_state=env_state, last_obs=last_obs, key=key)
        return state, traj, last_value

    if 'C' in args.stages:
        dt = timed(rollout_store, state)
        emit('C_rollout_stored', agent_steps / dt)

    # E: the full fused train loop
    if 'E' in args.stages:
        def full(state):
            s, metrics = ts_full(state)
            return metrics['loss']
        dt = timed(full, state)
        emit('E_full_train', agent_steps / dt)

    print(json.dumps({k: round(v) for k, v in results.items()}), flush=True)


if __name__ == '__main__':
    main()
