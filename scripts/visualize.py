"""Visualize trained agents (or random policies) in MultiGrid environments.

Counterpart of the reference's ``scripts/visualize.py``: rolls out episodes,
collects full-environment frames, optionally saves a GIF.

Examples
--------
python scripts/visualize.py --env MultiGrid-Empty-8x8-v0 --num-agents 2 \\
    --load-dir checkpoints/run1 --gif out.gif
python scripts/visualize.py --env MultiGrid-BlockedUnlockPickup-v0 --gif bup
"""

from __future__ import annotations

import argparse
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args() -> argparse.Namespace:
    p = argparse.ArgumentParser(description='Visualize MultiGrid agents.')
    p.add_argument('--env', default='MultiGrid-Empty-8x8-v0')
    p.add_argument('--num-agents', type=int, default=2)
    p.add_argument('--num-episodes', type=int, default=2)
    p.add_argument('--max-steps', type=int, default=200)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--load-dir', default=None,
                   help='checkpoint directory from scripts/train.py; random '
                        'policy when omitted')
    p.add_argument('--hidden', type=int, default=128)
    p.add_argument('--encoder', default='cnn', choices=['cnn', 'mlp'])
    p.add_argument('--per-agent-policies', action='store_true',
                   help='must match the flag the checkpoint was trained with')
    p.add_argument('--critic', default='local',
                   choices=['local', 'centralized'],
                   help='must match the training run (affects the '
                        'checkpoint parameter structure)')
    p.add_argument('--checkpoint', default=None,
                   help='explicit checkpoint path (e.g. <save-dir>/best) '
                        'instead of the latest step_* under --load-dir')
    p.add_argument('--gif', default=None, help='output GIF path')
    p.add_argument('--tile-size', type=int, default=32)
    p.add_argument('--platform', default=None, choices=['cpu', 'gpu'],
                   help='force a jax platform; default: jax default')
    return p.parse_args()


def visualize(args: argparse.Namespace) -> list[np.ndarray]:
    if args.platform:
        # Must land before any device is touched.
        jax.config.update('jax_platforms', args.platform)
    from multigrid_tpu.envs import make
    from multigrid_tpu.render import render_state

    env = make(args.env, agents=args.num_agents)

    policy = None
    if args.load_dir or args.checkpoint:
        from multigrid_tpu.learn import PPOConfig, ppo_init
        from multigrid_tpu.parallel import VectorEnv
        from multigrid_tpu.utils.checkpoint import (
            latest_checkpoint, restore_params)
        config = PPOConfig(per_agent_policies=args.per_agent_policies,
                           centralized_critic=args.critic == 'centralized')
        # Build the net through ppo_init so num_missions auto-sizes from the
        # env's mission space, exactly as scripts/train.py did — restoring a
        # mission-conditioned checkpoint then just works. The single-env
        # rollout below feeds unpacked obs, so mirror the trainer's params
        # with an unpacked-format net (parameter shapes are identical).
        tmp_state, net, _, _ = ppo_init(
            VectorEnv(env, 1), jax.random.key(0), config=config,
            net_kwargs=dict(hidden=args.hidden, encoder=args.encoder))
        ckpt = args.checkpoint or latest_checkpoint(args.load_dir)
        assert ckpt, f'no checkpoint under {args.load_dir}'
        try:
            # Params-only restore: tolerant of training-side optimizer
            # config (--lr-anneal changes the opt_state structure) and
            # --num-envs, neither of which matters for a rollout.
            params = restore_params(ckpt, tmp_state.params)
        except Exception as exc:
            raise SystemExit(
                f'failed to restore {ckpt}: {exc}\n'
                'Hint: --per-agent-policies, --critic, --hidden, --encoder '
                'and --num-agents must match the training run (mission '
                'conditioning and obs format are sized automatically).'
            ) from exc
        if config.centralized_critic:
            params = params['actor']  # rollouts only need the actors
        print(f'loaded policy from {ckpt}')

        @jax.jit
        def policy(key, obs):
            mission = obs.get('mission') if net.num_missions else None
            if args.per_agent_policies:
                # obs arrays are (N, ...): one parameter slice per agent.
                if mission is None:
                    logits, _ = jax.vmap(
                        lambda p, i, d: net.apply(p, i, d)
                    )(params, obs['image'], obs['direction'])
                else:
                    logits, _ = jax.vmap(net.apply)(
                        params, obs['image'], obs['direction'], mission)
            else:
                logits, _ = net.apply(
                    params, obs['image'], obs['direction'], mission)
            return jax.random.categorical(key, logits).astype(jnp.int32)

    frames: list[np.ndarray] = []
    key = jax.random.key(args.seed)
    for ep in range(args.num_episodes):
        key, reset_key = jax.random.split(key)
        obs, state = env.reset(reset_key)
        frames.append(render_state(env, state, tile_size=args.tile_size))
        total = np.zeros(env.num_agents)
        for t in range(args.max_steps):
            key, act_key = jax.random.split(key)
            if policy is None:
                actions = jax.random.randint(
                    act_key, (env.num_agents,), 0, 7, dtype=jnp.int32)
            else:
                actions = policy(act_key, obs)
            obs, state, rew, term, trunc = env.step(state, actions)
            frames.append(render_state(env, state, tile_size=args.tile_size))
            total += np.asarray(rew)
            if bool(jnp.all(term)) or bool(jnp.any(trunc)):
                break
        print(f'episode {ep}: {t + 1} steps, rewards {total.tolist()}')

    if args.gif:
        from PIL import Image
        path = args.gif if args.gif.endswith('.gif') else args.gif + '.gif'
        imgs = [Image.fromarray(f) for f in frames]
        imgs[0].save(path, save_all=True, append_images=imgs[1:],
                     duration=100, loop=0)
        print(f'saved {len(frames)} frames -> {path}')
    return frames


if __name__ == '__main__':
    visualize(parse_args())
