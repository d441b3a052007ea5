"""chip_smoke.py off the GPU: it refuses to run without one, and its
comparison helpers and phases work at tiny sizes on the CPU."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_exits_nonzero_without_gpu():
    env = {**os.environ, 'JAX_PLATFORMS': 'cpu'}
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, 'chip_smoke.py')],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert res.returncode != 0
    assert 'no GPU' in res.stderr
    assert '"ok"' not in res.stdout


def test_compare_trees():
    key = jax.random.key(0)
    a = {'i': jnp.arange(4), 'f': jnp.ones(3), 'k': key}
    same = chip_smoke.compare_trees(a, jax.tree.map(lambda x: x, a))
    assert same['equal'] and same['floats_bitequal']
    # One integer off is a mismatch, whatever the tolerance.
    b = {**a, 'i': jnp.arange(4).at[2].set(7)}
    out = chip_smoke.compare_trees(a, b, rtol=1.0)
    assert not out['equal'] and out['mismatched'] == ["['i']"]
    # Floats within rtol agree but are reported as not bit-equal.
    c = {**a, 'f': jnp.ones(3) * (1 + 1e-7)}
    out = chip_smoke.compare_trees(a, c, rtol=1e-5)
    assert out['equal'] and not out['floats_bitequal']
    assert not chip_smoke.compare_trees(a, c)['equal']
    # Typed PRNG keys compare by their key data.
    d = {**a, 'k': jax.random.key(1)}
    assert chip_smoke.compare_trees(a, d)['mismatched'] == ["['k']"]


def test_env_phase_tiny(capsys):
    """The env phase's three comparisons (repeat, another device, the
    single-env step) on a tiny batch, another CPU device standing in for
    the reference backend."""
    rec = chip_smoke.env_phase('MultiGrid-Empty-5x5-v0', 2, 8, 12,
                               jax.devices()[1], slice_envs=4)
    assert rec['repeat_equal'] and rec['equal_to_ref']
    assert rec['single_env']['equal'] and rec['single_env']['envs'] == 4
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line['phase'] == 'env' and line['num_envs'] == 8


def test_learner_phase_tiny():
    recipe = dict(chip_smoke.RECIPE, num_envs=8, rollout_steps=4, hidden=16)
    rec = chip_smoke.learner_phase(recipe)
    assert rec['ok'] and rec['samples'] == 4 * 2 * 2
    assert np.isfinite(rec['loss'])


def test_failed_check_raises():
    with pytest.raises(chip_smoke.SmokeError, match='boom'):
        chip_smoke._check(False, 'boom')
