"""Isolate the env step's phase costs on the device (obs / dynamics /
procedural reset / full step).

Each probe is a long scan whose carry feeds the measured computation (XLA
hoists loop-invariant work out of timing scans), ends in a host transfer of
a checksum that depends on the whole scan, and subtracts a one-step
baseline of the same program to cancel per-call fixed costs. Prints one
JSON line per phase.

Usage::

    python scripts/profile_env.py --env-id MultiGrid-Playground-v0 \
        --agents 4 --num-envs 4096 --steps 512
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timed(fn, *args, repeats=3):
    """Median wall-clock of fn(*args) → host-transferred scalar."""
    outs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        int(fn(*args))
        outs.append(time.perf_counter() - t0)
    outs.sort()
    return outs[len(outs) // 2]


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--env-id', default='MultiGrid-Playground-v0')
    p.add_argument('--agents', type=int, default=4)
    p.add_argument('--num-envs', type=int, default=4096)
    p.add_argument('--steps', type=int, default=512)
    p.add_argument('--reset-pool-period', type=int, default=None)
    p.add_argument(
        '--phases',
        default='full,noreset,pool1024,obs,dynamics,reset')
    args = p.parse_args()

    from multigrid_tpu.envs import make
    from multigrid_tpu.ops.step import sample_order
    from multigrid_tpu.parallel import VectorEnv

    env = make(args.env_id, agents=args.agents)
    venv = VectorEnv(env, args.num_envs,
                     reset_pool_period=args.reset_pool_period)
    e, n = args.num_envs, args.agents
    _, state0 = venv.reset(jax.random.key(0))

    def emit(phase, dt_total, dt_base):
        per_step = (dt_total - dt_base) / args.steps
        print(json.dumps({
            'phase': phase,
            'ms_per_step': round(per_step * 1e3, 4),
            'agent_steps_per_sec': round(e * n / per_step),
        }), flush=True)

    # Dispatch baseline: the same program at 1 step.
    def run_full(state, steps):
        state, s = venv.rollout_random(state, jax.random.key(1), steps)
        return s['obs_sum']

    full = jax.jit(run_full, static_argnums=1, donate_argnums=0)
    # NOTE: each call donates state — rebind via closure-free re-reset.
    def fresh():
        _, st = venv.reset(jax.random.key(0))
        return st

    if 'full' in args.phases:
        int(full(fresh(), args.steps))  # compile
        base = timed(lambda: full(fresh(), 1))
        tot = timed(lambda: full(fresh(), args.steps))
        emit('full_step', tot, base)

    # --- the same rollout without auto-reset: full − this = the reset
    # machinery (reserve roll + done-select + refresh slice).
    if 'noreset' in args.phases:
        vnr = VectorEnv(env, args.num_envs, auto_reset=False)

        def run_nr(steps):
            _, st = vnr.reset(jax.random.key(0))
            st, s = vnr.rollout_random(st, jax.random.key(1), steps)
            return s['obs_sum']

        int(run_nr(args.steps))
        base = timed(lambda: run_nr(1))
        tot = timed(lambda: run_nr(args.steps))
        emit('full_no_autoreset', tot, base)

    # --- longer refresh period: isolates the small-batch layout-regen slice
    # (c = E/period envs per step) from the fixed roll+select cost.
    if 'pool1024' in args.phases and getattr(env, 'procedural_reset', False):
        vp = VectorEnv(env, args.num_envs, reset_pool_period=1024)

        def run_p(steps):
            _, st = vp.reset(jax.random.key(0))
            st, s = vp.rollout_random(st, jax.random.key(1), steps)
            return s['obs_sum']

        int(run_p(args.steps))
        base = timed(lambda: run_p(1))
        tot = timed(lambda: run_p(args.steps))
        emit('full_pool_period1024', tot, base)

    # --- obs only: state mutated per iteration through the carry so
    # the kernel stays inside the loop (serial dependency via the checksum).
    if 'obs' in args.phases:
        @functools.partial(jax.jit, static_argnums=1)
        def obs_only(state, steps):
            def body(carry, _):
                d, acc = carry
                st = state.replace(
                    agent_dir=(state.agent_dir + d) % 4)
                st, _pool = venv._strip_pool(st)
                obs = venv._gen_obs_batched(st)
                s = obs['image'].sum(dtype=jnp.int32)
                return ((d + s % 3 + 1) % 4, acc + s), None
            (_, acc), _ = jax.lax.scan(
                body, (jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32)),
                None, length=steps)
            return acc

        int(obs_only(state0, args.steps))
        base = timed(obs_only, state0, 1)
        tot = timed(obs_only, state0, args.steps)
        emit('obs', tot, base)

    # --- dynamics only: vmapped step_core + done reduction, no obs, no
    # auto-reset regeneration (actions evolve with the carry).
    if 'dynamics' in args.phases:
        @functools.partial(jax.jit, static_argnums=1)
        def dyn_only(state, steps):
            state, _pool = venv._strip_pool(state)

            def body(carry, _):
                st, key, acc = carry
                key, k = jax.random.split(key)
                actions = jax.random.randint(k, (e, n), 0, 7, jnp.int32)

                def one(s, a):
                    ok, rng = jax.random.split(s.rng)
                    order = sample_order(ok, n)
                    return env.step_core(
                        s.replace(rng=rng), a, order, None)

                _, st2, rew, term, trunc = jax.vmap(one)(st, actions)
                done = jnp.all(term, -1) | jnp.any(trunc, -1)
                # Clear step_count/terminated where done so the batch keeps
                # stepping (stands in for the reset select without layout
                # regeneration).
                st2 = st2.replace(
                    step_count=jnp.where(done, 0, st2.step_count),
                    agent_terminated=jnp.where(
                        done[:, None], False, st2.agent_terminated))
                return (st2, key, acc + rew.sum() + done.sum()), None

            (st, _, acc), _ = jax.lax.scan(
                body, (state, jax.random.key(2), jnp.zeros(())),
                None, length=steps)
            return acc.astype(jnp.int32) + st.step_count.sum()

        int(dyn_only(state0, args.steps))
        base = timed(dyn_only, state0, 1)
        tot = timed(dyn_only, state0, args.steps)
        emit('dynamics', tot, base)

    # --- procedural reset: the per-step reserve-pool refresh slice cost is
    # (E / period) reset_cores; measure a full E-batch reset_core and scale.
    if 'reset' in args.phases:
        @functools.partial(jax.jit, static_argnums=1)
        def reset_batch(key, reps):
            def body(carry, _):
                k, acc = carry
                k, kk = jax.random.split(k)
                st = jax.vmap(env.reset_core)(jax.random.split(kk, e))
                return (k, acc + st.grid.sum() + st.agent_pos.sum()), None
            (_, acc), _ = jax.lax.scan(
                body, (key, jnp.zeros((), jnp.int32)), None, length=reps)
            return acc

        reps = max(1, args.steps // 16)
        int(reset_batch(jax.random.key(3), reps))
        base = timed(reset_batch, jax.random.key(3), 1)
        tot = timed(reset_batch, jax.random.key(4), reps)
        per_reset_env = (tot - base) / (reps * e)
        period = venv.reset_pool_period if venv.reset_pool else None
        print(json.dumps({
            'phase': 'reset_core',
            'us_per_env_reset': round(per_reset_env * 1e6, 3),
            'pool_ms_per_step_at_period': (
                round(per_reset_env * e / period * 1e3, 4)
                if period else None),
            'period': period,
        }), flush=True)


if __name__ == '__main__':
    main()
