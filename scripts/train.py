"""Train PPO agents on MultiGrid environments.

The counterpart of the reference's RLlib example (multigrid/scripts/train.py)
with the Ray process topology replaced by one jit-compiled program: thousands
of lockstep envs and the PPO learner co-located on the device mesh.

Examples
--------
python scripts/train.py --algo PPO --framework jax \\
    --env MultiGrid-Empty-8x8-v0 --num-agents 2 --num-envs 1024 \\
    --num-timesteps 1000000 --save-dir ~/ray_results/

python scripts/train.py --env MultiGrid-BlockedUnlockPickup-v0 \\
    --num-agents 2 --num-envs 4096 --lr 0.0003 --load-dir ckpts/run1
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description='Train PPO agents on MultiGrid.')
    # Flags mirror the reference CLI (scripts/train.py:203-242) where they
    # still make sense; Ray-specific ones are accepted and ignored.
    p.add_argument('--algo', default='PPO', choices=['PPO'],
                   help='RL algorithm (PPO only)')
    p.add_argument('--framework', default='jax', help='ignored (always jax)')
    p.add_argument('--env', default='MultiGrid-Empty-8x8-v0')
    p.add_argument('--env-config', type=json.loads, default={},
                   help='JSON dict of environment kwargs')
    p.add_argument('--num-agents', type=int, default=2)
    p.add_argument('--num-envs', type=int, default=1024,
                   help='lockstep parallel envs (the reference uses '
                        '--num-workers Ray processes instead)')
    p.add_argument('--num-workers', type=int, default=None,
                   help='compat alias: treated as a hint for --num-envs')
    p.add_argument('--num-gpus', type=int, default=0, help='ignored')
    p.add_argument('--num-timesteps', type=int, default=1_000_000)
    p.add_argument('--rollout-steps', type=int, default=16)
    p.add_argument('--epochs', type=int, default=1,
                   help='PPO epochs per batch')
    p.add_argument('--minibatches', type=int, default=1,
                   help='SGD minibatches per epoch (RLlib-style shuffled '
                        'minibatch SGD; 1 = whole-batch updates)')
    p.add_argument('--lr', type=float, default=3e-4)
    p.add_argument('--gamma', type=float, default=0.99)
    p.add_argument('--ent-coef', type=float, default=0.01)
    p.add_argument('--hidden', type=int, default=128)
    p.add_argument('--encoder', default='cnn', choices=['cnn', 'mlp'],
                   help="'cnn' matches the reference example; 'mlp' is the "
                        'throughput encoder')
    p.add_argument('--updates-per-call', type=int, default=1,
                   help='PPO updates fused per jitted call (amortizes '
                        'per-call dispatch overhead)')
    p.add_argument('--per-agent-policies', action='store_true',
                   help='independent parameters per agent (the reference '
                        "example's policy_{i}); default is shared self-play")
    p.add_argument('--critic', default='local',
                   choices=['local', 'centralized'],
                   help="'centralized' = MAPPO-style joint-observation "
                        'value function (actors stay partial) — fixes '
                        'independent-PPO on coordination chains under a '
                        'joint reward (per-agent BUP, docs/LEARNING.md)')
    p.add_argument('--lr-anneal', action='store_true',
                   help='linearly decay lr to 0 over --num-timesteps')
    p.add_argument('--ent-anneal', action='store_true',
                   help='linearly decay the entropy bonus to 0 over '
                        '--num-timesteps (late-training exploitation — '
                        'closes oscillating task-completion curves)')
    p.add_argument('--save-best', default=None, metavar='METRIC',
                   help="additionally keep the best checkpoint by this "
                        "logged metric (e.g. 'success_rate'): evaluated at "
                        'every log point over the window, saved to '
                        '<save-dir>/best when it improves')
    p.add_argument('--save-best-min-episodes', type=int, default=256,
                   help='ignore log windows that completed fewer episodes '
                        'than this when comparing --save-best metrics (a '
                        'near-empty early window can fluke success_rate=1.0 '
                        'on 1-2 random completions and poison the best '
                        'checkpoint for the whole run)')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--save-dir', default='checkpoints',
                   help='checkpoint directory (saved every --save-interval '
                        'updates, reference checkpoints every 20 iterations)')
    p.add_argument('--save-interval', type=int, default=20)
    p.add_argument('--load-dir', default=None,
                   help='resume from the latest checkpoint in this directory')
    p.add_argument('--log-interval', type=int, default=10,
                   help='log metrics every N updates')
    p.add_argument('--log-jsonl', default=None,
                   help='append per-update metrics as JSON lines')
    p.add_argument('--mesh', action='store_true',
                   help='shard the env batch over all local devices')
    p.add_argument('--platform', default=None, choices=['cpu', 'gpu'],
                   help='force a jax platform; default: jax default')
    p.add_argument('--no-packed-obs', action='store_true',
                   help='store rollouts as (vs, vs, 3) channel triples '
                        'instead of the default bit-packed int32 cells '
                        '(packed carries 1/3 the HBM traffic)')
    return p.parse_args(argv)


def train(args: argparse.Namespace):
    """Run the training loop; returns the final TrainState."""
    if args.platform:
        # Must land before any device is touched.
        jax.config.update('jax_platforms', args.platform)
    from multigrid_tpu.utils.compile_cache import enable_compilation_cache
    enable_compilation_cache()
    from multigrid_tpu.envs import make
    from multigrid_tpu.learn import (
        PPOConfig, make_train_loop, make_train_step, ppo_init)
    from multigrid_tpu.parallel import VectorEnv, make_mesh
    from multigrid_tpu.utils.checkpoint import (
        latest_checkpoint, restore_checkpoint, save_checkpoint)
    from multigrid_tpu.utils.profiling import PhaseTimer, force_completion

    env = make(args.env, agents=args.num_agents, **args.env_config)
    mesh = make_mesh() if args.mesh else None
    venv = VectorEnv(env, args.num_envs, mesh=mesh,
                     packed_obs=not args.no_packed_obs)
    config = PPOConfig(
        rollout_steps=args.rollout_steps, lr=args.lr, gamma=args.gamma,
        ent_coef=args.ent_coef, epochs=args.epochs,
        minibatches=args.minibatches,
        per_agent_policies=args.per_agent_policies,
        centralized_critic=args.critic == 'centralized',
    )
    lr_schedule = None
    if args.lr_anneal:
        # Continuous linear decay to 0 — an optax schedule costs nothing
        # per update (it lives in the optimizer).
        total_updates = max(1, args.num_timesteps // (
            args.num_envs * args.num_agents * args.rollout_steps))
        import optax
        lr_schedule = optax.linear_schedule(args.lr, 0.0, total_updates)
    # The net is constructed inside ppo_init so num_missions auto-sizes from
    # the env's mission space (BlockedUnlockPickup etc. condition on the
    # mission index) and the obs format matches the VectorEnv.
    state, net, config, tx = ppo_init(
        venv, jax.random.key(args.seed), config=config,
        net_kwargs=dict(hidden=args.hidden, encoder=args.encoder),
        lr_schedule=lr_schedule)

    if args.load_dir:
        ckpt = latest_checkpoint(args.load_dir)
        if ckpt:
            try:
                state = restore_checkpoint(ckpt, state)
            except Exception as exc:
                raise SystemExit(
                    f'failed to restore {ckpt}: {exc}\n'
                    'Hint: --per-agent-policies, --hidden, --encoder, '
                    '--num-agents and --num-envs must match the values the '
                    'checkpoint was trained with.'
                ) from exc
            print(f'resumed from {ckpt} (update {int(state.update_count)})')

    upc = max(1, args.updates_per_call)

    def build_step(cfg):
        if upc > 1:
            return make_train_loop(venv, net, cfg, tx, upc)
        return make_train_step(venv, net, cfg, tx)

    steps_per_update = (
        args.num_envs * args.num_agents * config.rollout_steps * upc)
    num_updates = max(1, args.num_timesteps // steps_per_update)

    # Entropy anneal runs stage-wise (4 linear-decay stages): ent_coef is a
    # constant of the compiled train step, so each stage compiles once.
    ENT_STAGES = 4

    def stage_config(update):
        if not args.ent_anneal:
            return config
        stage = min(update * ENT_STAGES // max(num_updates, 1),
                    ENT_STAGES - 1)
        return config.replace(
            ent_coef=args.ent_coef * (1.0 - stage / ENT_STAGES))

    train_step = build_step(stage_config(0))
    current_ent = stage_config(0).ent_coef
    timer = PhaseTimer()

    print(f'training {args.env}: {args.num_agents} agents x '
          f'{args.num_envs} envs, {num_updates} updates of '
          f'{steps_per_update} agent-steps on {jax.devices()[0].device_kind}')

    log_f = open(args.log_jsonl, 'a') if args.log_jsonl else None
    t_start = time.perf_counter()
    t_last, steps_last = t_start, 0
    best_val = None
    for update in range(int(state.update_count) // upc, num_updates):
        cfg = stage_config(update)
        if cfg.ent_coef != current_ent:
            current_ent = cfg.ent_coef
            train_step = build_step(cfg)
            print(f'ent-anneal stage: ent_coef -> {current_ent:g}')
        sync = (
            (update + 1) % args.log_interval == 0
            or (update + 1) % args.save_interval == 0
            or update == num_updates - 1
        )
        with timer.phase('update'):
            state, metrics = train_step(state)
            if sync:
                # Wait for the device ONLY at log/checkpoint points: between
                # syncs the async dispatch queue keeps the device fed.
                force_completion(metrics)
        if (update + 1) % args.save_interval == 0 or update == num_updates - 1:
            path = save_checkpoint(
                os.path.join(args.save_dir, f'step_{update + 1}'), state)
            print(f'checkpoint -> {path}')
        if (update + 1) % args.log_interval == 0 or update == num_updates - 1:
            now = time.perf_counter()
            steps_done = (update + 1) * steps_per_update
            # Cumulative rate includes jit compilation (the first window);
            # the window rate is the steady-state training throughput.
            rate = steps_done / (now - t_start)
            window_rate = (steps_done - steps_last) / max(now - t_last, 1e-9)
            t_last, steps_last = now, steps_done
            row = {
                'update': update + 1,
                'agent_steps': steps_done,
                'agent_steps_per_sec': round(rate),
                'steps_per_sec_window': round(window_rate),
                'reward_per_step': float(metrics['reward_per_step']),
                'loss': float(metrics['loss']),
                'entropy': float(metrics['entropy']),
                'episode_reward': float(metrics.get('episode_reward', float('nan'))),
                'episodes_in_batch': float(metrics.get('episodes_in_batch', 0)),
                'success_rate': float(metrics.get('success_rate', float('nan'))),
            }
            print(json.dumps(row))
            if log_f:
                log_f.write(json.dumps(row) + '\n')
                log_f.flush()
            if args.save_best:
                val = row.get(args.save_best)
                # Episode-rate metrics are meaningless on near-empty windows
                # (1-2 random completions can fluke success_rate=1.0 and
                # poison the best checkpoint for the rest of the run).
                if args.save_best in ('success_rate', 'episode_reward') and \
                        row.get('episodes_in_batch', 0) < \
                        args.save_best_min_episodes:
                    val = None
                # NaN-safe improvement test (success_rate is NaN on windows
                # with no completed episodes).
                if val is not None and val == val and (
                        best_val is None or val > best_val):
                    best_val = val
                    path = save_checkpoint(
                        os.path.join(args.save_dir, 'best'), state)
                    print(f'best {args.save_best}={val:.4f} -> {path}')
    if log_f:
        log_f.close()
    print('timing:', json.dumps(timer.summary()))
    return state


if __name__ == '__main__':
    train(parse_args())
