"""VectorEnv's batched observations against the single-env path.

``VectorEnv.step`` generates observations once per step for the whole batch
(after merging auto-resets), optionally packed into int32 cells. Without
auto-reset, every env's observation must equal what the vmapped single-env
``env.step`` returns for the same state and actions, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multigrid_tpu.envs import make
from multigrid_tpu.parallel import VectorEnv

E = 8


def _pack(image):
    p = (image[..., 0] << 8) | (image[..., 1] << 4) | image[..., 2]
    return p.reshape(p.shape[:-2] + (-1,))


def _check_against_single(env, packed: bool, steps: int, seed: int):
    venv = VectorEnv(env, E, auto_reset=False, packed_obs=packed)
    # Layouts without observations: observation generation compiles once,
    # inside ``both`` (its compile time grows steeply with the view size).
    state = jax.vmap(env.reset_core)(
        jax.random.split(jax.random.key(seed), E))

    @jax.jit
    def both(state, acts):
        obs, new_state, *_ = venv.step(state, acts)
        want, want_state, *_ = jax.vmap(env.step)(state, acts)
        return obs, new_state, want, want_state

    key = jax.random.key(seed + 1)
    for _ in range(steps):
        key, ak = jax.random.split(key)
        acts = jax.random.randint(ak, (E, env.num_agents), 0, 7, jnp.int32)
        obs, state, want, want_state = both(state, acts)
        want_img = _pack(want['image']) if packed else want['image']
        np.testing.assert_array_equal(np.asarray(obs['image']),
                                      np.asarray(want_img))
        np.testing.assert_array_equal(np.asarray(obs['direction']),
                                      np.asarray(want['direction']))
        if 'mission' in want:
            np.testing.assert_array_equal(np.asarray(obs['mission']),
                                          np.asarray(want['mission']))
        np.testing.assert_array_equal(np.asarray(state.grid),
                                      np.asarray(want_state.grid))


@pytest.mark.parametrize('packed', [False, True])
@pytest.mark.parametrize('env_id,agents,stw', [
    ('MultiGrid-Empty-8x8-v0', 2, False),
    ('MultiGrid-BlockedUnlockPickup-v0', 3, True),
    ('MultiGrid-Empty-16x16-v0', 1, True),
    ('MultiGrid-LockedHallway-6Rooms-v0', 2, False),  # 13x25 grid
])
def test_batched_obs_match_single_env(env_id, agents, stw, packed):
    env = make(env_id, agents=agents, see_through_walls=stw)
    _check_against_single(env, packed, steps=3, seed=0)


@pytest.mark.parametrize('view_size', [3, 5, 9, 11, 13])
def test_batched_obs_view_sizes(view_size):
    """Odd view sizes from 3 to 13; at 11 and above the view reaches past
    the grid's far walls. Those two see through walls: the visibility
    flood fill's unrolled chains take minutes to compile at such views on
    XLA:CPU, and what the large views add is the crop past the grid."""
    env = make('MultiGrid-Empty-8x8-v0', agents=2,
               agent_view_size=view_size,
               see_through_walls=view_size >= 11)
    _check_against_single(env, packed=view_size % 4 == 1, steps=2, seed=4)
