"""Minimal trained-throughput measurement.

One warmup call (compile), then `--repeats` timed calls; each timed call
ends with a host transfer of a scalar that depends on the whole update
(params checksum + metrics), so the time includes all device work. Prints
one JSON line.
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


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--env', default='MultiGrid-Empty-16x16-v0')
    p.add_argument('--num-agents', type=int, default=4)
    p.add_argument('--num-envs', type=int, default=4096)
    p.add_argument('--encoder', default='mlp')
    p.add_argument('--rollout-steps', type=int, default=16)
    p.add_argument('--updates-per-call', type=int, default=8)
    p.add_argument('--repeats', type=int, default=3)
    p.add_argument('--calls-per-repeat', type=int, default=4)
    p.add_argument('--hidden', type=int, default=128)
    p.add_argument('--minibatches', type=int, default=1)
    p.add_argument('--epochs', type=int, default=1)
    p.add_argument('--no-packed-obs', action='store_true')
    p.add_argument('--per-agent-policies', action='store_true',
                   help="independent policy_{i} parameters per agent (the "
                        "reference example's scheme)")
    p.add_argument('--platform', default=None, choices=['cpu', 'gpu'],
                   help='force a jax platform; default: jax default')
    p.add_argument('--mode', default='full',
                   choices=['full', 'policy-nostore', 'store-nopolicy',
                            'rollout', 'env-only'],
                   help='isolation modes: rollout with policy but no '
                        'trajectory storage / random actions with storage / '
                        'policy AND full trajectory storage, no learner')
    args = p.parse_args()
    if args.platform:
        jax.config.update('jax_platforms', args.platform)

    from multigrid_tpu.envs import make
    from multigrid_tpu.learn import PPOConfig, make_train_loop, ppo_init
    from multigrid_tpu.parallel import VectorEnv

    env = make(args.env, agents=args.num_agents)
    venv = VectorEnv(env, args.num_envs, packed_obs=not args.no_packed_obs)
    config = PPOConfig(rollout_steps=args.rollout_steps,
                       minibatches=args.minibatches, epochs=args.epochs,
                       per_agent_policies=args.per_agent_policies)
    state, net, config, tx = ppo_init(
        venv, jax.random.key(0), config=config,
        net_kwargs=dict(encoder=args.encoder, hidden=args.hidden))
    if args.mode == 'full':
        loop = make_train_loop(venv, net, config, tx, args.updates_per_call)
    else:
        steps = args.rollout_steps * args.updates_per_call

        @jax.jit
        def loop(state):
            def body(carry, _):
                env_state, obs, key, acc = carry
                key, k = jax.random.split(key)
                if args.mode == 'policy-nostore':
                    logits, value = net.apply(
                        state.params, obs['image'], obs['direction'],
                        obs.get('mission'))
                    action = jax.random.categorical(k, logits).astype(
                        jnp.int32)
                    acc = acc + value.sum()
                    ys = None
                elif args.mode == 'rollout':
                    # The real rollout_phase payload: policy forward,
                    # sampled action + its log-prob, and the full Rollout
                    # tuple stacked across T (what the learner consumes).
                    logits, value = net.apply(
                        state.params, obs['image'], obs['direction'],
                        obs.get('mission'))
                    action = jax.random.categorical(k, logits).astype(
                        jnp.int32)
                    from multigrid_tpu.learn.ppo import _select_log_prob
                    logp = _select_log_prob(logits, action)
                    ys = (obs['image'], obs['direction'], action, logp,
                          value)
                elif args.mode == 'env-only':
                    # Random actions, no trajectory stacking: the same scan
                    # harness as the other modes, so (this - store-nopolicy)
                    # isolates the cost of stacking obs into the T-buffer.
                    action = jax.random.randint(
                        k, (venv.num_envs, venv.num_agents), 0, 7, jnp.int32)
                    acc = acc + jnp.sum(obs['image'][0].astype(jnp.float32))
                    ys = None
                else:
                    action = jax.random.randint(
                        k, (venv.num_envs, venv.num_agents), 0, 7, jnp.int32)
                    ys = (obs['image'], obs['direction'], action)
                obs2, env_state, reward, term, trunc, done, _ = venv.step(
                    env_state, action, refresh=not venv.reset_pool)
                if args.mode == 'rollout':
                    ys = ys + (reward, done[:, None] | term)
                return (env_state, obs2, key, acc + reward.sum()), ys

            (env_state, obs, key, acc), ys = jax.lax.scan(
                body, (state.env_state, state.last_obs, state.key,
                       jnp.zeros(())),
                None, length=steps)
            if venv.reset_pool:
                # Mirror the production rollout's chunked pool refresh.
                env_state = venv.refresh_pool(env_state, steps)
            if ys is not None:
                acc = acc + sum(jnp.sum(y).astype(jnp.float32) for y in
                                jax.tree.leaves(ys))
            return state.replace(env_state=env_state, last_obs=obs, key=key), \
                {'loss': acc}

    @jax.jit
    def checksum(state, metrics):
        # One scalar that depends on the updated params, the env state and
        # the metrics — pulling it to host is the completion barrier.
        s = sum(jnp.sum(l.astype(jnp.float32))
                for l in jax.tree.leaves(state.params))
        s = s + jnp.sum(state.env_state.step_count.astype(jnp.float32))
        return s + metrics['loss']

    steps_per_call = (args.num_envs * args.num_agents
                      * args.rollout_steps * args.updates_per_call)

    t0 = time.perf_counter()
    state, metrics = loop(state)
    float(checksum(state, metrics))
    compile_s = time.perf_counter() - t0

    rates = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        for _ in range(args.calls_per_repeat):
            state, metrics = loop(state)
        float(checksum(state, metrics))
        dt = time.perf_counter() - t0
        rates.append(args.calls_per_repeat * steps_per_call / dt)
    rates.sort()

    print(json.dumps({
        'encoder': args.encoder,
        'hidden': args.hidden,
        'packed_obs': not args.no_packed_obs,
        'minibatches': args.minibatches,
        'epochs': args.epochs,
        'rollout_steps': args.rollout_steps,
        'updates_per_call': args.updates_per_call,
        'trained_agent_steps_per_sec': round(rates[-1]),
        'median': round(rates[len(rates) // 2]),
        'compile_s': round(compile_s, 1),
        'platform': jax.devices()[0].platform,
        'device_kind': jax.devices()[0].device_kind,
        'device_count': jax.device_count(),
    }), flush=True)


if __name__ == '__main__':
    main()
