"""Smoke test of the system on an NVIDIA GPU, through its normal entry points.

Run from the root of the checkout::

    python chip_smoke.py               # one GPU: env, trainer, learner math
    python chip_smoke.py --four-cards  # four GPUs: the sharded paths only

Phases (one process; each prints one JSON line with its timings):

* ``env`` — 64 steps of ``VectorEnv.rollout_random`` at 4096 envs on
  Empty-16x16 (4 agents, exact auto-reset) and BlockedUnlockPickup (2
  agents, reserve pool), episodes cut to :data:`ENV_MAX_STEPS`. The final
  state, the per-step obs checksum and the final observations must equal,
  bit for bit, the same jitted program run on the CPU backend of this
  process, and one more step of a slice of envs must equal the vmapped
  single-env ``env.step``.
* ``train`` — ``scripts/train.py``'s ``train()`` on the production recipe
  (BlockedUnlockPickup, 2 agents, 4096 envs, T=128, 2 epochs × 4
  minibatches, mlp encoder, packed obs): 3 updates with finite losses and a
  checkpoint that restores to the trained parameters; then 3 updates each
  of per-agent policies with the centralized critic, and of the cnn encoder.
* ``learner`` — the train step's loss and gradients on one recipe-size
  minibatch against the float32 reference (``learn/reference.py``) under
  ``jax.default_matmul_precision('highest')``: bf16 compute with f32
  accumulation matches it to ``LOSS_RTOL`` on the loss and ``GRAD_RTOL``
  on the whole gradient.
* ``four_cards`` (``--four-cards`` only) — the BlockedUnlockPickup rollout
  sharded over a 4-GPU ``make_mesh()`` must equal the 1-GPU result bit for
  bit, with every env-state leaf spread over all 4 devices; one recipe PPO
  update with per-agent policies, the centralized critic and the reserve
  pool must agree with the same global batch on 1 GPU within
  :data:`MESH_RTOL` (metrics) and :data:`UPDATE_RTOL` (parameter update).

The last line printed is ``{"ok": true, "device": {...}}``; any failed check
exits non-zero before it. Without a GPU the script exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

#: The env configurations of the ``env`` phase: (env id, agents).
ENV_CASES = (('MultiGrid-Empty-16x16-v0', 4),
             ('MultiGrid-BlockedUnlockPickup-v0', 2))

#: Episode horizon of the env-phase rollouts: every env truncates once in
#: the 64 steps, so the comparisons cover the auto-reset select (and the
#: reserve pool's consumption) too; the envs' own horizons (1024 and 576
#: steps) would never end an episode of a random policy within 64 steps.
ENV_MAX_STEPS = 40

#: The production PPO recipe (scripts/train.py flags).
RECIPE = dict(env='MultiGrid-BlockedUnlockPickup-v0', agents=2,
              num_envs=4096, rollout_steps=128, epochs=2, minibatches=4,
              hidden=128)

#: Tolerances of the 4-GPU PPO update against the 1-GPU update. Sharding
#: changes the batch each matmul sees and the order of the gradient
#: all-reduce, which moves logits and gradients in their last bits. The
#: loss metrics are means over the whole batch: MESH_RTOL. Adam's
#: normalized step turns last-bit differences of near-zero gradient entries
#: into differences of up to one step (lr) in those entries, so the
#: parameter update (||Δ4 - Δ1|| / ||Δ1||) gets UPDATE_RTOL; a dropped or
#: doubled all-reduce, or a mis-split batch, changes it by O(1).
MESH_RTOL = 2e-2
UPDATE_RTOL = 1e-1


class SmokeError(RuntimeError):
    """A check of the smoke test failed."""


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeError(msg)


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def _timed(fn, *args):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


# ------------------------------------------------------------ comparisons


def _plain(x) -> np.ndarray:
    if jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key):
        x = jax.random.key_data(x)
    return np.asarray(x)


def compare_trees(a, b, rtol: float = 0.0) -> dict:
    """Leaf-by-leaf comparison of two pytrees of arrays.

    Integer, bool and key leaves must be equal. Float leaves must agree to
    ``rtol`` of their largest magnitude; ``floats_bitequal`` says whether
    they were equal too. Returns ``equal`` (every check held),
    ``mismatched`` (paths of failing leaves) and ``float_max_rel_err``.
    """
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = jax.tree.leaves(b)
    _check(len(la) == len(lb), 'trees differ in structure')
    mismatched, bitequal, max_err = [], True, 0.0
    for (path, x), y in zip(la, lb):
        x, y = _plain(x), _plain(y)
        name = jax.tree_util.keystr(path)
        if x.shape != y.shape:
            mismatched.append(name)
            continue
        if np.issubdtype(x.dtype, np.floating):
            same = np.array_equal(x, y, equal_nan=True)
            bitequal &= same
            if not same:
                x64, y64 = x.astype(np.float64), y.astype(np.float64)
                scale = max(np.abs(y64).max(initial=0.0), 1e-30)
                err = float(np.abs(x64 - y64).max() / scale)
                max_err = max(max_err, err)
                if err > rtol:
                    mismatched.append(name)
        elif not np.array_equal(x, y):
            mismatched.append(name)
    return {'equal': not mismatched, 'mismatched': mismatched[:8],
            'floats_bitequal': bool(bitequal), 'float_max_rel_err': max_err}


def _rollout(venv, steps: int, seed: int):
    """Reset + ``rollout_random`` from fixed keys; returns
    ``(final state, summary, final observations)``."""
    _, state = venv.reset(jax.random.key(seed))
    state, summary = venv.rollout_random(
        state, jax.random.key(seed + 1), steps)
    return state, summary, venv.observe(state)


def single_env_check(venv, state, key, k: int) -> dict:
    """One more lockstep step against ``jax.vmap(env.step)`` on the first
    ``k`` envs. Rewards and termination flags are compared for all ``k``;
    observations and state where the episode did not end (auto-reset
    replaces the others). Consumes ``state`` (the step donates it)."""
    env = venv.env
    actions = jax.random.randint(
        key, (venv.num_envs, venv.num_agents), 0, 7, dtype=jnp.int32)
    sliced, _ = venv._strip_pool(state)
    sliced = jax.tree.map(lambda x: x[:k], sliced)
    obs1, st1, rew1, term1, trunc1 = jax.vmap(env.step)(sliced, actions[:k])
    obs, st, rew, term, trunc, done, _ = venv.step(state, actions)
    st, _ = venv._strip_pool(st)
    running = ~np.asarray(done[:k])

    def run(tree):
        return jax.tree.map(lambda x: _plain(x)[running], tree)

    flags = compare_trees((rew[:k], term[:k], trunc[:k]),
                          (rew1, term1, trunc1))
    obs_cmp = compare_trees(run(jax.tree.map(lambda x: x[:k], obs)),
                            run(obs1))
    st_cmp = compare_trees(run(jax.tree.map(lambda x: x[:k], st)), run(st1))
    return {'envs': k, 'running': int(running.sum()),
            'equal': flags['equal'] and obs_cmp['equal'] and st_cmp['equal'],
            'mismatched': flags['mismatched'] + obs_cmp['mismatched']
            + st_cmp['mismatched']}


# ----------------------------------------------------------------- phases


def env_phase(env_id: str, agents: int, num_envs: int, steps: int,
              ref_device, slice_envs: int = 256, seed: int = 0,
              max_steps: int = ENV_MAX_STEPS) -> dict:
    """Rollout on the default device, bit-compared with ``ref_device`` and
    with the single-env step. Raises :class:`SmokeError` on a mismatch."""
    from multigrid_tpu.envs import make
    from multigrid_tpu.parallel import VectorEnv

    venv = VectorEnv(make(env_id, agents=agents, max_steps=max_steps),
                     num_envs)
    first, compile_s = _timed(_rollout, venv, steps, seed)
    again, run_s = _timed(_rollout, venv, steps, seed)
    repeat = compare_trees(first, again)
    with jax.default_device(ref_device):
        ref, ref_s = _timed(_rollout, venv, steps, seed)
    # The reward sum is a float reduction whose order differs by backend.
    vs_ref = compare_trees(first, ref, rtol=1e-5)
    single = single_env_check(
        venv, again[0], jax.random.key(seed + 2), min(slice_envs, num_envs))
    record = {
        'phase': 'env', 'env': env_id, 'agents': agents,
        'num_envs': num_envs, 'steps': steps, 'max_steps': max_steps,
        'reset_pool': venv.reset_pool,
        'compile_s': compile_s - run_s,
        'steady_s_per_step': run_s / steps,
        'agent_steps_per_s': num_envs * agents * steps / run_s,
        'ref_device': str(ref_device), 'ref_s': ref_s,
        'repeat_equal': repeat['equal'],
        'equal_to_ref': vs_ref['equal'],
        'floats_bitequal_to_ref': vs_ref['floats_bitequal'],
        'ref_float_max_rel_err': vs_ref['float_max_rel_err'],
        'ref_mismatched': vs_ref['mismatched'],
        'single_env': single,
        'episodes': int(first[1]['episodes']),
    }
    emit(record)
    _check(repeat['equal'], f'{env_id}: two identical runs differ')
    _check(vs_ref['equal'],
           f'{env_id}: differs from {ref_device}: {vs_ref["mismatched"]}')
    _check(single['equal'],
           f'{env_id}: differs from the single-env step: '
           f'{single["mismatched"]}')
    return record


def _load_train_script():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        'train_script', os.path.join(REPO, 'scripts', 'train.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def train_run(out_dir: str, name: str, extra: list[str],
              recipe: dict = RECIPE, updates: int = 3):
    """``updates`` updates of scripts/train.py's ``train()`` on the recipe,
    logged every update. Returns ``(record, final state, checkpoint dir)``;
    the record's steady time is the second update's (the first compiles,
    the last also writes the checkpoint)."""
    script = _load_train_script()
    os.makedirs(out_dir, exist_ok=True)
    save_dir = os.path.join(out_dir, f'ckpt_{name}')
    log = os.path.join(out_dir, f'{name}.jsonl')
    shutil.rmtree(save_dir, ignore_errors=True)
    if os.path.exists(log):
        os.remove(log)
    per_update = (recipe['num_envs'] * recipe['agents']
                  * recipe['rollout_steps'])
    args = script.parse_args([
        '--env', recipe['env'], '--num-agents', str(recipe['agents']),
        '--num-envs', str(recipe['num_envs']),
        '--rollout-steps', str(recipe['rollout_steps']),
        '--epochs', str(recipe['epochs']),
        '--minibatches', str(recipe['minibatches']),
        '--hidden', str(recipe['hidden']), '--encoder', 'mlp',
        '--num-timesteps', str(updates * per_update),
        '--save-dir', save_dir, '--save-interval', str(updates),
        '--log-interval', '1', '--log-jsonl', log, *extra])
    state = script.train(args)
    with open(log) as f:
        rows = [json.loads(line) for line in f]
    secs = [per_update / r['steps_per_sec_window'] for r in rows]
    record = {
        'phase': 'train', 'run': name, 'updates': len(rows),
        'compile_s': secs[0] - secs[1],
        'steady_s_per_update': secs[1],
        'trained_agent_steps_per_s': per_update / secs[1],
        'losses': [r['loss'] for r in rows],
        'finite': all(np.isfinite(r['loss']) for r in rows),
    }
    return record, state, save_dir


def trainer_phase(out_dir: str, recipe: dict = RECIPE) -> None:
    """The recipe through scripts/train.py, its checkpoint round trip, and
    the per-agent/centralized and cnn variants."""
    from multigrid_tpu.utils.checkpoint import (
        latest_checkpoint, restore_params)

    record, state, save_dir = train_run(out_dir, 'recipe', [], recipe)
    ckpt = latest_checkpoint(save_dir)
    restored = restore_params(ckpt, state.params)
    record['checkpoint_equal'] = compare_trees(
        restored, state.params)['equal']
    emit(record)
    _check(record['finite'], f'recipe: non-finite loss {record["losses"]}')
    _check(record['checkpoint_equal'],
           'recipe: restored checkpoint differs from the trained params')
    shutil.rmtree(save_dir, ignore_errors=True)
    for name, extra in (
            ('per_agent_centralized',
             ['--per-agent-policies', '--critic', 'centralized']),
            ('cnn', ['--encoder', 'cnn'])):
        record, _, save_dir = train_run(out_dir, name, extra, recipe)
        emit(record)
        _check(record['finite'], f'{name}: non-finite loss')
        shutil.rmtree(save_dir, ignore_errors=True)


def learner_phase(recipe: dict = RECIPE, seed: int = 0) -> dict:
    """Loss and gradients of one recipe minibatch against the float32
    reference."""
    from multigrid_tpu.envs import make
    from multigrid_tpu.learn import PPOConfig, make_train_step, ppo_init
    from multigrid_tpu.learn.reference import (
        GRAD_RTOL, LOSS_RTOL, compare_with_reference)
    from multigrid_tpu.parallel import VectorEnv

    venv = VectorEnv(make(recipe['env'], agents=recipe['agents']),
                     recipe['num_envs'], packed_obs=True)
    config = PPOConfig(rollout_steps=recipe['rollout_steps'],
                       epochs=recipe['epochs'],
                       minibatches=recipe['minibatches'])
    state, net, config, tx = ppo_init(
        venv, jax.random.key(seed), config=config,
        net_kwargs=dict(encoder='mlp', hidden=recipe['hidden']))
    step = make_train_step(venv, net, config, tx)

    @jax.jit
    def batch(state):
        _, traj, last_value, _ = step.rollout_phase(state)
        adv, tgt = step.compute_gae(traj, last_value)
        c = venv.num_envs // config.minibatches   # minibatch 0's env block
        return jax.tree.map(lambda x: x[:, :c], (traj, adv, tgt))

    (traj, adv, tgt), batch_s = _timed(batch, state)
    t0 = time.perf_counter()
    out = compare_with_reference(
        step, net, config, state.params, traj, adv, tgt)
    record = {'phase': 'learner', 'samples': int(np.prod(adv.shape)),
              'batch_s': batch_s, 'compare_s': time.perf_counter() - t0,
              'loss_rtol': LOSS_RTOL, 'grad_rtol': GRAD_RTOL, **out}
    emit(record)
    _check(out['ok'], f'learner differs from the f32 reference: {out}')
    return record


def _spans(leaf, n: int) -> bool:
    return len(leaf.sharding.device_set) == n


def four_card_phase(devices, recipe: dict = RECIPE, steps: int = 64,
                    seed: int = 0) -> None:
    """The sharded env rollout and PPO update on ``devices`` against one
    device."""
    from multigrid_tpu.envs import make
    from multigrid_tpu.learn import PPOConfig, make_train_step, ppo_init
    from multigrid_tpu.parallel import VectorEnv, make_mesh

    n = len(devices)
    mesh = make_mesh(devices=devices)
    e = recipe['num_envs']
    # The pool env: its refresh writes slices of sharded leaves.
    for env_id, agents in ENV_CASES[1:]:
        env = make(env_id, agents=agents, max_steps=ENV_MAX_STEPS)
        sharded, s_time = _timed(
            _rollout, VectorEnv(env, e, mesh=mesh), steps, seed)
        with jax.default_device(devices[0]):
            single, one_time = _timed(_rollout, VectorEnv(env, e), steps,
                                      seed)
        cmp = compare_trees(sharded, single, rtol=1e-5)
        # Zero-size leaves (box-free envs' box_contents) hold no data.
        leaves = [x for x in jax.tree.leaves(sharded[0]) if x.size]
        spread = all(_spans(x, n) for x in leaves)
        split = all(x.sharding.shard_shape(x.shape)[0] == e // n
                    for x in leaves)
        emit({'phase': 'four_cards_env', 'env': env_id, 'agents': agents,
              'num_envs': e, 'steps': steps, 'devices': n,
              'sharded_s': s_time, 'single_s': one_time,
              'equal_to_single': cmp['equal'],
              'floats_bitequal': cmp['floats_bitequal'],
              'mismatched': cmp['mismatched'],
              'state_leaves': len(leaves),
              'every_leaf_spans_all_devices': spread,
              'env_axis_split': split})
        _check(cmp['equal'], f'{env_id}: sharded rollout differs from 1 '
                             f'device: {cmp["mismatched"]}')
        _check(spread and split,
               f'{env_id}: an env-state leaf is not split over {n} devices')

    env = make(recipe['env'], agents=recipe['agents'])
    config = PPOConfig(rollout_steps=recipe['rollout_steps'],
                       epochs=recipe['epochs'],
                       minibatches=recipe['minibatches'],
                       per_agent_policies=True, centralized_critic=True)
    results = {}
    for label, m in (('sharded', mesh), ('single', None)):
        venv = VectorEnv(env, e, mesh=m, packed_obs=True)
        _check(venv.reset_pool, 'the recipe env must use the reserve pool')
        with jax.default_device(devices[0]):
            state, net, cfg, tx = ppo_init(
                venv, jax.random.key(seed), config=config,
                net_kwargs=dict(encoder='mlp', hidden=recipe['hidden']))
            step = make_train_step(venv, net, cfg, tx)
            before = state.params
            (state, metrics), secs = _timed(step, state)
        delta = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                             state.params, before)
        results[label] = (metrics, delta, secs, state)
    (m4, d4, s4, st4), (m1, d1, s1, _) = results['sharded'], results['single']
    metric_err = {k: abs(float(m4[k]) - float(m1[k]))
                  / max(abs(float(m1[k])), 1e-6)
                  for k in ('loss', 'pg_loss', 'vf_loss', 'entropy')}
    num = sum(np.sum((a - b) ** 2) for a, b in zip(
        jax.tree.leaves(d4), jax.tree.leaves(d1)))
    den = sum(np.sum(b ** 2) for b in jax.tree.leaves(d1))
    update_err = float(np.sqrt(num / den))
    spread = all(_spans(x, n) for x in jax.tree.leaves(st4.env_state)
                 if x.size)
    emit({'phase': 'four_cards_ppo', 'devices': n, 'num_envs': e,
          'sharded_update_s': s4, 'single_update_s': s1,
          'metric_rel_err': metric_err, 'metric_rtol': MESH_RTOL,
          'param_update_rel_err': update_err, 'update_rtol': UPDATE_RTOL,
          'env_state_spans_all_devices': spread})
    _check(max(metric_err.values()) <= MESH_RTOL,
           f'sharded PPO metrics differ: {metric_err}')
    _check(update_err <= UPDATE_RTOL,
           f'sharded PPO update differs: {update_err}')
    _check(spread, 'the env state left the mesh after the update')


# ------------------------------------------------------------------- main


def _gpu_lines() -> list[str]:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--four-cards', action='store_true',
                   help='run only the sharded paths, on 4 GPUs')
    p.add_argument('--out', default=os.path.join(
        REPO, 'chiprun_out', 'chip_smoke'),
        help='directory for checkpoints and training logs')
    args = p.parse_args(argv)

    # The env phase compares against this process's CPU backend, so keep it
    # available when JAX_PLATFORMS names only the GPU.
    platforms = jax.config.jax_platforms
    if platforms and 'cpu' not in platforms.split(','):
        jax.config.update('jax_platforms', platforms + ',cpu')
    if jax.default_backend() != 'gpu':
        print(f'chip_smoke: no GPU found (JAX default backend: '
              f'{jax.default_backend()}); this script needs a GPU',
              file=sys.stderr)
        return 2
    want = 4 if args.four_cards else 1
    if len(jax.devices()) < want:
        print(f'chip_smoke: needs {want} GPUs, found {len(jax.devices())}',
              file=sys.stderr)
        return 2

    from multigrid_tpu.utils.compile_cache import enable_compilation_cache
    cache = enable_compilation_cache()
    for line in _gpu_lines():
        print(f'nvidia-smi: {line}', flush=True)
    print(f'jax {jax.__version__}, compilation cache {cache}', flush=True)

    t0 = time.perf_counter()
    if args.four_cards:
        four_card_phase(jax.devices()[:4])
    else:
        cpu = jax.devices('cpu')[0]
        for env_id, agents in ENV_CASES:
            env_phase(env_id, agents, 4096, 64, cpu)
        trainer_phase(args.out)
        learner_phase()
    print(f'total {time.perf_counter() - t0:.1f} s', flush=True)

    dev = jax.devices()[0]
    print(json.dumps({'ok': True, 'device': {
        'platform': dev.platform, 'kind': dev.device_kind,
        'count': len(jax.devices())}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
