"""Throughput benchmark: lockstep batched env stepping on one GPU.

Measures agent-steps/sec on the BASELINE.json headline config
(4096 parallel envs, Empty-16x16, 4 agents, auto-reset, random actions,
full observation generation every step) and prints ONE JSON line naming
the device it ran on. Exits non-zero when JAX finds no GPU, unless
``--platform cpu`` asks for a CPU run.

``vs_baseline`` is relative to the reference implementation's measured
throughput (~4,469 agent-steps/s: MultiGrid-Empty-8x8-v0, 2 agents, random
policy, single env, single CPU core, numba shimmed off — see BASELINE.md;
the reference publishes no numbers of its own).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import jax

REFERENCE_AGENT_STEPS_PER_SEC = 4469.0


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument('--env-id', default='MultiGrid-Empty-16x16-v0')
    parser.add_argument('--agents', type=int, default=4)
    parser.add_argument('--env-config', type=json.loads, default={},
                        help='JSON dict of env constructor overrides '
                             '(e.g. \'{"size": 32}\' — operating-envelope '
                             'benches beyond the registered configs)')
    parser.add_argument('--num-envs', type=int, default=4096)
    parser.add_argument('--steps', type=int, default=256)
    parser.add_argument('--repeats', type=int, default=3)
    parser.add_argument('--mesh', action='store_true',
                        help='shard the env batch over all local devices '
                             '(weak-scaling mode)')
    parser.add_argument('--platform', default=None, choices=['cpu', 'gpu'],
                        help='force a jax platform; without it the run '
                             'fails unless the default backend is a GPU')
    args = parser.parse_args()

    if args.platform:
        jax.config.update('jax_platforms', args.platform)
    if args.platform != 'cpu' and jax.default_backend() != 'gpu':
        sys.exit(f'bench.py: no GPU found (default backend: '
                 f'{jax.default_backend()}); pass --platform cpu for a '
                 f'CPU run')

    from multigrid_tpu.envs import make
    from multigrid_tpu.parallel import VectorEnv, make_mesh
    from multigrid_tpu.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    env = make(args.env_id, agents=args.agents, **args.env_config)
    mesh = make_mesh() if args.mesh else None
    venv = VectorEnv(env, args.num_envs, mesh=mesh)

    key = jax.random.key(0)
    _, state = venv.reset(key)

    # Warmup: compile + one full rollout, then the short program too.
    state, summary = venv.rollout_random(state, jax.random.key(1), args.steps)
    jax.block_until_ready(summary)
    steps_short = max(1, args.steps // 4)
    state, s0 = venv.rollout_random(state, jax.random.key(99), steps_short)
    jax.block_until_ready(s0)

    # Per-call fixed costs (dispatch, the rollout's prologue) are cancelled
    # by LENGTH DIFFERENCING: each repeat times a short and a long rollout,
    # and the rate is marginal steps over the difference of the two groups'
    # median times.
    t_short, t_long = [], []
    for r in range(args.repeats):
        t0 = time.perf_counter()
        state, s_short = venv.rollout_random(
            state, jax.random.key(5000 + r), steps_short)
        jax.block_until_ready(s_short)
        t1 = time.perf_counter()
        state, summary = venv.rollout_random(
            state, jax.random.key(2 + r), args.steps)
        jax.block_until_ready(summary)
        t_short.append(t1 - t0)
        t_long.append(time.perf_counter() - t1)
    t_short.sort()
    t_long.sort()
    marginal_steps = args.num_envs * args.agents * (args.steps - steps_short)

    def rate(ts, tl):
        return marginal_steps / max(1e-9, tl - ts)

    median = rate(t_short[len(t_short) // 2], t_long[len(t_long) // 2])
    # Best CONSISTENT window: fastest long run against the fastest short
    # run (same-direction selection). Still optimistic — median is the
    # number of record.
    best = rate(t_short[0], t_long[0])

    dev = jax.devices()[0]
    print(json.dumps({
        'metric': 'agent_steps_per_sec_per_chip',
        'value': round(median),
        'unit': 'agent-steps/s',
        'vs_baseline': round(median / REFERENCE_AGENT_STEPS_PER_SEC, 2),
        'median': round(median),
        'best_window': round(best),
        'platform': dev.platform,
        'device_kind': dev.device_kind,
        'device_count': jax.device_count(),
    }))


if __name__ == '__main__':
    main()
