"""Evaluate a trained policy's EXACT task completion over many episodes.

Rolls the policy over a lockstep VectorEnv batch and reports the fraction
of completed episodes whose final pre-reset state satisfied the env's
exact task-completion predicate (``MultiGridEnv.success`` — all doors
unlocked / target box carried / agent on goal), plus mean episodic return.
The evaluation analogue of the reference's visualize loop
(multigrid/scripts/visualize.py:37-71), at throughput: a whole VectorEnv
batch of episodes per jitted call.

Examples
--------
python scripts/evaluate.py --env MultiGrid-LockedHallway-2Rooms-v0 \\
    --num-agents 2 --encoder mlp --checkpoint ckpt/lh2/best \\
    --num-envs 4096 --num-steps 100000000
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args() -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description='Evaluate exact task completion of a trained policy.')
    p.add_argument('--env', default='MultiGrid-Empty-8x8-v0')
    p.add_argument('--num-agents', type=int, default=2)
    p.add_argument('--env-config', type=json.loads, default={})
    p.add_argument('--num-envs', type=int, default=4096)
    p.add_argument('--num-steps', type=int, default=10_000_000,
                   help='total agent-steps of evaluation')
    p.add_argument('--checkpoint', default=None,
                   help='explicit checkpoint path (e.g. <save-dir>/best); '
                        'with --load-dir, the latest step_* is used')
    p.add_argument('--load-dir', default=None)
    p.add_argument('--hidden', type=int, default=128)
    p.add_argument('--encoder', default='cnn', choices=['cnn', 'mlp'])
    p.add_argument('--per-agent-policies', action='store_true')
    p.add_argument('--critic', default='local',
                   choices=['local', 'centralized'],
                   help='must match the training run (affects the '
                        'checkpoint parameter structure)')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--platform', default=None, choices=['cpu', 'gpu'])
    return p.parse_args()


def evaluate(args: argparse.Namespace) -> dict:
    if args.platform:
        jax.config.update('jax_platforms', args.platform)
    from multigrid_tpu.envs import make
    from multigrid_tpu.learn import PPOConfig, ppo_init
    from multigrid_tpu.parallel import VectorEnv
    from multigrid_tpu.utils.checkpoint import (
        latest_checkpoint, restore_params)

    env = make(args.env, agents=args.num_agents, **args.env_config)
    venv = VectorEnv(env, args.num_envs, packed_obs=True)
    config = PPOConfig(per_agent_policies=args.per_agent_policies,
                       centralized_critic=args.critic == 'centralized')
    tmp_state, net, config, _ = ppo_init(
        venv, jax.random.key(args.seed), config=config,
        net_kwargs=dict(hidden=args.hidden, encoder=args.encoder))

    ckpt = args.checkpoint or (
        latest_checkpoint(args.load_dir) if args.load_dir else None)
    assert ckpt, 'pass --checkpoint or --load-dir'
    try:
        # Params-only restore: optimizer state and env batch are training
        # concerns, so eval flags need not mirror --lr-anneal/--num-envs.
        params = restore_params(ckpt, tmp_state.params)
    except Exception as exc:
        raise SystemExit(
            f'failed to restore {ckpt}: {exc}\n'
            'Hint: --per-agent-policies, --critic, --hidden, --encoder '
            'and --num-agents must match the training run.'
        ) from exc
    aparams = params['actor'] if config.centralized_critic else params
    print(f'loaded policy from {ckpt}')

    if config.per_agent_policies:
        def logits_fn(obs):
            img = jnp.moveaxis(obs['image'], -2, 0)
            dirn = jnp.moveaxis(obs['direction'], -1, 0)
            mis = (jnp.moveaxis(obs['mission'], -1, 0)
                   if net.num_missions and 'mission' in obs else None)
            if mis is None:
                lg, _ = jax.vmap(
                    lambda p, i, d: net.apply(p, i, d))(aparams, img, dirn)
            else:
                lg, _ = jax.vmap(net.apply)(aparams, img, dirn, mis)
            return jnp.moveaxis(lg, 0, -2)
    else:
        def logits_fn(obs):
            mis = obs.get('mission') if net.num_missions else None
            lg, _ = net.apply(aparams, obs['image'], obs['direction'], mis)
            return lg

    steps_per_iter = 256

    @jax.jit
    def run(state, key):
        def body(carry, _):
            st, obs, k, ep_acc, acc = carry
            k, ka = jax.random.split(k)
            action = jax.random.categorical(ka, logits_fn(obs))
            obs, st, rew, _, _, done, success = venv.step(
                st, action.astype(jnp.int32), refresh=not venv.reset_pool)
            ep_acc = ep_acc + rew.sum(-1)
            acc = (
                acc[0] + done.sum(),                      # episodes
                acc[1] + (done & success).sum(),          # exact successes
                acc[2] + jnp.where(done, ep_acc, 0.).sum(),  # banked return
            )
            ep_acc = jnp.where(done, 0.0, ep_acc)
            return (st, obs, k, ep_acc, acc), None

        obs = venv.observe(state)
        zero = (jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
                jnp.zeros((), jnp.float32))
        (state, _, _, _, acc), _ = jax.lax.scan(
            body,
            (state, obs, key, jnp.zeros((venv.num_envs,), jnp.float32),
             zero),
            None, length=steps_per_iter)
        if venv.reset_pool:
            state = venv.refresh_pool(state, steps_per_iter)
        return state, acc

    key = jax.random.key(args.seed + 1)
    key, rk = jax.random.split(key)
    _, env_state = venv.reset(rk)
    total = np.zeros(3)
    steps_done = 0
    t0 = time.perf_counter()
    while steps_done < args.num_steps:
        key, k = jax.random.split(key)
        env_state, acc = run(env_state, k)
        total += np.array([float(a) for a in acc])
        steps_done += steps_per_iter * args.num_envs * args.num_agents
    dt = time.perf_counter() - t0
    episodes, successes, ret = total
    out = {
        'checkpoint': ckpt,
        'agent_steps': steps_done,
        'episodes': int(episodes),
        'success_rate_exact': round(successes / max(episodes, 1), 5),
        'mean_episode_return': round(ret / max(episodes, 1), 4),
        'eval_agent_steps_per_sec': round(steps_done / dt),
    }
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    evaluate(parse_args())
