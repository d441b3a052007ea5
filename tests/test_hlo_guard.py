"""HLO regression guard: no scatter/gather on the hot path.

Per-env traced indexed reads/writes (``grid[fx, fy]``, ``.at[i].set``,
``jnp.take``) lower to gathers/scatters under vmap; the hot path is written
as one-hot masked arithmetic instead (see ops/step.py, ops/place.py), which
XLA fuses across the env batch. Whether gathers would pay on the GPU is an
open question (ROADMAP S6); until it is measured, this guard keeps the one
form. Even *constant-index* ``.at[].set`` re-lowers to a scatter under
vmap, so the whole hot path is written scatter-free and this test pins it at
ZERO scatter/gather ops in the jitted ``VectorEnv.step`` StableHLO for every env
family and the wrapper chain.

If this test fails after a change, rewrite the offending indexed access as a
one-hot masked select (ops/place.py:set_cell is the pattern) instead of
whitelisting it.
"""

import jax
import jax.numpy as jnp
import pytest

from multigrid_tpu.envs import make
from multigrid_tpu.parallel import VectorEnv
from multigrid_tpu.wrappers import FullyObsWrapper, OneHotObsWrapper

CASES = {
    'empty': lambda: make('MultiGrid-Empty-16x16-v0', agents=4),
    'empty_random': lambda: make('MultiGrid-Empty-Random-6x6-v0', agents=2),
    'blockedunlockpickup': lambda: make(
        'MultiGrid-BlockedUnlockPickup-v0', agents=2),
    'locked_hallway': lambda: make(
        'MultiGrid-LockedHallway-4Rooms-v0', agents=2),
    'playground': lambda: make('MultiGrid-Playground-v0', agents=2),
    'redbluedoors': lambda: make('MultiGrid-RedBlueDoors-6x6-v0', agents=2),
    'fully_obs': lambda: FullyObsWrapper(
        make('MultiGrid-Empty-16x16-v0', agents=2)),
    'one_hot': lambda: OneHotObsWrapper(
        make('MultiGrid-Empty-8x8-v0', agents=2)),
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_step_lowering_has_no_scatter_gather(name):
    env = CASES[name]()
    venv = VectorEnv(env, 8)
    _, state = venv.reset(jax.random.key(0))
    actions = jnp.zeros((8, env.num_agents), dtype=jnp.int32)
    lowered = jax.jit(
        VectorEnv.step.__wrapped__, static_argnums=0, donate_argnums=1
    ).lower(venv, state, actions)
    txt = lowered.as_text()
    n_scatter = txt.count('stablehlo.scatter')
    n_gather = txt.count('"stablehlo.gather"')
    assert n_scatter == 0 and n_gather == 0, (
        f'{name}: VectorEnv.step lowering contains {n_scatter} scatter / '
        f'{n_gather} gather ops — a traced-index access reached the hot '
        f'path; rewrite it as a one-hot masked select (see module docstring)'
    )
