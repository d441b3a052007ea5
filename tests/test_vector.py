"""VectorEnv: lockstep batching, auto-reset, sharding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multigrid_tpu.envs import make
from multigrid_tpu.parallel import VectorEnv, make_mesh


def test_batch_matches_single():
    """Batched step == per-env step (same keys)."""
    env = make('MultiGrid-Empty-5x5-v0', agents=2)
    venv = VectorEnv(env, 4, auto_reset=False)
    key = jax.random.key(0)
    obs, state = venv.reset(key)

    keys = jax.random.split(key, 4)
    for e in range(4):
        obs_e, state_e = env.reset(keys[e])
        np.testing.assert_array_equal(obs['image'][e], obs_e['image'])
        np.testing.assert_array_equal(state.grid[e], state_e.grid)

    actions = jnp.tile(jnp.array([[2, 1]], dtype=jnp.int32), (4, 1))
    obs, state, rew, term, trunc, done, success = venv.step(state, actions)
    assert obs['image'].shape == (4, 2, 7, 7, 3)
    assert rew.shape == (4, 2) and done.shape == (4,)


def test_auto_reset():
    """An env whose episode ends is replaced by a fresh layout in-kernel."""
    env = make('MultiGrid-Empty-5x5-v0', agents=1)  # agent at (1,1) facing right
    venv = VectorEnv(env, 2, auto_reset=True)
    obs, state = venv.reset(jax.random.key(1))

    # Env 0 drives to the goal at (3, 3): forward x2, turn right, forward x2.
    plan = [2, 2, 1, 2, 2]
    for t, a in enumerate(plan):
        actions = jnp.array([[a], [6]], dtype=jnp.int32)  # env 1 idles
        obs, state, rew, term, trunc, done, success = venv.step(state, actions)
        if t < len(plan) - 1:
            assert not bool(done[0])
    assert bool(done[0]) and not bool(done[1])
    assert bool(success[0])  # reached the goal = exact task completion
    assert float(rew[0, 0]) > 0
    # After auto-reset the agent is back at the start, episode counter cleared.
    assert int(state.step_count[0]) == 0
    np.testing.assert_array_equal(np.asarray(state.agent_pos[0]), [[1, 1]])
    assert not bool(state.agent_terminated[0, 0])
    # Env 1 kept stepping.
    assert int(state.step_count[1]) == len(plan)


def test_truncation_auto_reset():
    env = make('MultiGrid-Empty-5x5-v0', agents=1, max_steps=3)
    venv = VectorEnv(env, 2, auto_reset=True)
    _, state = venv.reset(jax.random.key(2))
    for _ in range(3):
        actions = jnp.zeros((2, 1), dtype=jnp.int32)  # spin in place
        obs, state, rew, term, trunc, done, success = venv.step(state, actions)
    assert bool(done.all())
    assert not bool(success.any())  # truncation is not task completion
    assert int(state.step_count[0]) == 0


def test_sharded_vector_env():
    """Env axis sharded over the 8 virtual CPU devices."""
    mesh = make_mesh()
    assert mesh.devices.size == 8
    env = make('MultiGrid-BlockedUnlockPickup-v0', agents=2)
    venv = VectorEnv(env, 16, mesh=mesh)
    obs, state = venv.reset(jax.random.key(3))
    assert state.grid.sharding.is_equivalent_to(
        jax.NamedSharding(mesh, jax.P('env')), state.grid.ndim
    )
    actions = jnp.zeros((16, 2), dtype=jnp.int32)
    obs, state, *_ = venv.step(state, actions)
    assert obs['image'].shape == (16, 2, 7, 7, 3)


def test_rollout_random():
    env = make('MultiGrid-Empty-8x8-v0', agents=2)
    venv = VectorEnv(env, 8)
    _, state = venv.reset(jax.random.key(4))
    state, summary = venv.rollout_random(state, jax.random.key(5), 64)
    assert int(summary['episodes']) >= 0
    assert state.grid.shape == (8, 8, 8, 3)


# ----------------------------------------------------- amortized reset pool


def test_reset_pool_defaults():
    """RoomGrid families opt into the pool; cheap layouts stay exact."""
    assert VectorEnv(make('MultiGrid-Playground-v0', agents=2), 4).reset_pool
    assert VectorEnv(
        make('MultiGrid-RedBlueDoors-6x6-v0', agents=2), 4).reset_pool
    assert not VectorEnv(make('MultiGrid-Empty-8x8-v0', agents=1), 4).reset_pool


def test_reset_pool_auto_reset():
    """Done envs swap in a pregenerated (valid, fresh) layout."""
    from multigrid_tpu.core.constants import TYPE_DOOR

    env = make('MultiGrid-Playground-v0', agents=2, max_steps=3)
    venv = VectorEnv(env, 4, reset_pool_period=2)
    _, state = venv.reset(jax.random.key(0))
    first_grid = np.asarray(state.grid)
    for _ in range(3):
        actions = jnp.zeros((4, 2), dtype=jnp.int32)
        _, state, rew, term, trunc, done, success = venv.step(state, actions)
    assert bool(done.all())  # truncation at max_steps=3
    assert int(state.step_count.max()) == 0
    grid = np.asarray(state.grid)
    # The swapped-in layouts are real Playground layouts: connected rooms
    # mean every env has doors; agents are placed on empty cells.
    assert (grid[..., 0] == TYPE_DOOR).any(axis=(1, 2)).all()
    assert (np.asarray(state.agent_pos) >= 0).all()
    # And they are fresh draws, not the original layouts.
    assert (grid != first_grid).any()


def test_reset_pool_determinism_and_refresh():
    """Same seed/actions → identical trajectories; consecutive episodes get
    different layouts once the refresh cycle has passed."""
    env = make('MultiGrid-BlockedUnlockPickup-v0', agents=2, max_steps=4)
    grids = []
    for _ in range(2):
        venv = VectorEnv(env, 4, reset_pool_period=2)
        _, state = venv.reset(jax.random.key(7))
        seen = []
        for t in range(12):
            actions = jnp.full((4, 2), 6, dtype=jnp.int32)  # idle
            _, state, *_, done, _success = venv.step(state, actions)
            if bool(done.all()):
                seen.append(np.asarray(state.grid).copy())
        grids.append(seen)
    assert len(grids[0]) == 3  # episodes of length 4 in 12 steps
    for a, b in zip(grids[0], grids[1]):
        np.testing.assert_array_equal(a, b)  # deterministic under fixed seed
    # Layouts differ between consecutive episodes (pool refreshed in time).
    assert (grids[0][0] != grids[0][1]).any()
    assert (grids[0][1] != grids[0][2]).any()


def test_reset_pool_no_replay_for_short_episodes():
    """Episodes far shorter than the refresh period must still get a fresh
    layout every reset: consumption reads the reserve through a rotating
    offset, so consecutive episode ends of one env land on different slots
    (trained policies finish in tens of steps — the regime that previously
    replayed one reserve layout repeatedly)."""
    env = make('MultiGrid-BlockedUnlockPickup-v0', agents=2, max_steps=10)
    venv = VectorEnv(env, 8, reset_pool_period=128)
    assert venv.reset_pool and venv.reset_pool_period == 128
    _, state = venv.reset(jax.random.key(3))
    layouts = [np.asarray(state.grid).copy()]
    for t in range(30):  # 3 consecutive 10-step episodes, period 128
        actions = jnp.full((8, 2), 6, dtype=jnp.int32)  # idle
        _, state, *_, done, _success = venv.step(state, actions)
        if bool(done.all()):
            layouts.append(np.asarray(state.grid).copy())
    assert len(layouts) == 4
    for a, b in zip(layouts, layouts[1:]):
        # Every env's consecutive layouts differ (BUP layouts draw random
        # door/key/ball colors and positions; equality would mean replay).
        per_env_equal = (a == b).all(axis=(1, 2, 3))
        assert not per_env_equal.any(), (
            f'layout replay in envs {np.where(per_env_equal)[0]}')


def test_reset_pool_rotation_determinism():
    """The rotating consumption offset stays bit-deterministic under a fixed
    seed (same seed + actions → identical layout sequences)."""
    env = make('MultiGrid-RedBlueDoors-6x6-v0', agents=2, max_steps=5)
    seqs = []
    for _ in range(2):
        venv = VectorEnv(env, 8, reset_pool=True, reset_pool_period=64)
        _, state = venv.reset(jax.random.key(11))
        seen = []
        for t in range(15):
            actions = jnp.full((8, 2), 6, dtype=jnp.int32)
            _, state, *_, done, _success = venv.step(state, actions)
            if bool(done.all()):
                seen.append(np.asarray(state.grid).copy())
        seqs.append(seen)
    assert len(seqs[0]) == 3
    for a, b in zip(*seqs):
        np.testing.assert_array_equal(a, b)


def test_packed_obs_equivalence():
    """packed_obs=True returns bit-packed cells equal to packing the default
    triples; nets one-hot them to identical features (learn/nets.py)."""
    env = make('MultiGrid-Empty-8x8-v0', agents=2)
    v_plain = VectorEnv(env, 8)
    v_packed = VectorEnv(env, 8, packed_obs=True)
    obs_p, st_p = v_plain.reset(jax.random.key(5))
    obs_k, st_k = v_packed.reset(jax.random.key(5))
    repack = (
        (obs_p['image'][..., 0].astype(jnp.int32) << 8)
        | (obs_p['image'][..., 1].astype(jnp.int32) << 4)
        | obs_p['image'][..., 2].astype(jnp.int32))
    repack = repack.reshape(repack.shape[:-2] + (-1,))  # flat cell axis
    np.testing.assert_array_equal(np.asarray(obs_k['image']),
                                  np.asarray(repack))
    for t in range(5):
        actions = jnp.full((8, 2), t % 7, dtype=jnp.int32)
        obs_p, st_p, *rest_p = v_plain.step(st_p, actions)
        obs_k, st_k, *rest_k = v_packed.step(st_k, actions)
        repack = (
            (obs_p['image'][..., 0].astype(jnp.int32) << 8)
            | (obs_p['image'][..., 1].astype(jnp.int32) << 4)
            | obs_p['image'][..., 2].astype(jnp.int32))
        repack = repack.reshape(repack.shape[:-2] + (-1,))
        np.testing.assert_array_equal(np.asarray(obs_k['image']),
                                      np.asarray(repack))

    # one_hot_image(packed) == one_hot_image(triples)
    from multigrid_tpu.learn.nets import one_hot_image
    a = one_hot_image(obs_p['image'], dtype=jnp.float32)
    b = one_hot_image(obs_k['image'], dtype=jnp.float32, packed=True)
    # triples give (..., vs, vs, 21), packed (..., vs*vs, 21): same features
    # in the same cell-major order, different view.
    np.testing.assert_array_equal(
        np.asarray(a).reshape(np.asarray(b).shape), np.asarray(b))

    # Wrapped envs must refuse the packed format.
    from multigrid_tpu.wrappers import OneHotObsWrapper
    with pytest.raises(AssertionError):
        VectorEnv(OneHotObsWrapper(env), 8, packed_obs=True)


def test_ppo_trains_with_packed_obs():
    """The PPO stack runs end-to-end on the packed format (the default for
    scripts/train.py) and matches parameter shapes with the unpacked net."""
    from multigrid_tpu.learn import PPOConfig, make_train_step, ppo_init
    env = make('MultiGrid-Empty-5x5-v0', agents=2)
    venv = VectorEnv(env, 8, packed_obs=True)
    state, net, config, tx = ppo_init(
        venv, jax.random.key(0), config=PPOConfig(rollout_steps=4),
        net_kwargs=dict(encoder='mlp'))
    assert net.packed_obs
    step = make_train_step(venv, net, config, tx)
    state, metrics = step(state)
    assert np.isfinite(float(metrics['loss']))
    assert int(state.update_count) == 1


def test_reset_pool_chunked_refresh_no_replay():
    """Chunked mode (step(refresh=False) x K + one refresh_pool(K)) keeps
    the pool's freshness contract: the consumption offset still advances
    every step (consecutive episode ends of one env land on different
    slots) and every slot is regenerated within ~period steps."""
    env = make('MultiGrid-BlockedUnlockPickup-v0', agents=2, max_steps=10)
    venv = VectorEnv(env, 8, reset_pool_period=128)
    _, state = venv.reset(jax.random.key(3))
    layouts = [np.asarray(state.grid).copy()]
    K = 10
    for chunk in range(3):  # 3 consecutive 10-step episodes, chunked refresh
        for t in range(K):
            actions = jnp.full((8, 2), 6, dtype=jnp.int32)  # idle
            _, state, *_, done, _suc = venv.step(
                state, actions, refresh=False)
        state = venv.refresh_pool(state, K)
        assert bool(done.all())
        layouts.append(np.asarray(state.grid).copy())
    assert len(layouts) == 4
    for a, b in zip(layouts, layouts[1:]):
        per_env_equal = (a == b).all(axis=(1, 2, 3))
        assert not per_env_equal.any(), (
            f'layout replay in envs {np.where(per_env_equal)[0]}')


def test_reset_pool_chunked_refresh_regenerates_slots():
    """refresh_pool(K) actually rewrites K steps' worth of reserve slots."""
    from multigrid_tpu.parallel.vector import _RESERVE
    env = make('MultiGrid-RedBlueDoors-6x6-v0', agents=2)
    venv = VectorEnv(env, 8, reset_pool_period=4)  # c=2 slots/step
    _, state = venv.reset(jax.random.key(5))
    before = np.asarray(state.extras[_RESERVE].grid)
    # 4 steps of debt → one chunk-4 refresh regenerates ceil(8/4)*4 = 8 slots.
    for t in range(4):
        _, state, *_ = venv.step(
            state, jnp.full((8, 2), 6, jnp.int32), refresh=False)
    state = venv.refresh_pool(state, 4)
    after = np.asarray(state.extras[_RESERVE].grid)
    # The pool stores its grid bit-packed (one flat int32 plane per env) —
    # compare per-slot regardless of the storage layout.
    changed = (before != after).reshape(before.shape[0], -1).any(axis=1)
    assert changed.all(), f'unrefreshed slots: {np.where(~changed)[0]}'


def test_pool_pack_roundtrip():
    """The reserve pool's bit-packed storage format round-trips exactly
    (grid and box_contents through one flat int32 plane)."""
    env = make('MultiGrid-BlockedUnlockPickup-v0', agents=2)
    venv = VectorEnv(env, 8)
    assert venv._pool_packed
    state = jax.vmap(env.reset_core)(jax.random.split(jax.random.key(3), 8))
    assert state.box_contents.size  # BUP layouts contain a Box
    packed = venv._pool_pack(state)
    assert packed.grid.ndim == 2 and packed.box_contents.size == 0
    back = venv._pool_unpack(packed, state)
    np.testing.assert_array_equal(np.asarray(back.grid),
                                  np.asarray(state.grid))
    np.testing.assert_array_equal(np.asarray(back.box_contents),
                                  np.asarray(state.box_contents))
