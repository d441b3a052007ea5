"""The plain-JAX networks (learn/nets.py) against flax.linen definitions of
the same architecture: same parameter tree and shapes, bit-equal outputs on
identical parameters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multigrid_tpu.learn import nets


@pytest.fixture(scope='module')
def linen():
    return pytest.importorskip('flax.linen')


def _flax_nets(nn):
    """The networks as flax.linen modules (the definitions the plain-JAX
    ones replaced)."""

    class ActorCritic(nn.Module):
        num_actions: int = 7
        hidden: int = 128
        encoder: str = 'cnn'
        dtype: jnp.dtype = jnp.bfloat16
        num_missions: int = 0
        packed_obs: bool = False

        @nn.compact
        def __call__(self, image, direction, mission=None):
            theta = direction.astype(self.dtype) * (jnp.pi / 2)
            dir_feats = jnp.stack([jnp.cos(theta), jnp.sin(theta)], axis=-1)
            if self.num_missions > 0 and mission is not None:
                dir_feats = jnp.concatenate([
                    dir_feats, jax.nn.one_hot(
                        mission, self.num_missions, dtype=self.dtype)], -1)
            if self.encoder == 'cnn':
                if self.packed_obs:
                    vs = int(round(image.shape[-1] ** 0.5))
                    image = image.reshape(image.shape[:-1] + (vs, vs))
                x = nets.one_hot_image(image, self.dtype,
                                       packed=self.packed_obs)
                h = nn.Conv(16, (3, 3), padding='VALID', dtype=self.dtype)(x)
                d = nn.Dense(16, use_bias=False, dtype=self.dtype)(dir_feats)
                x = nn.relu(h + d[..., None, None, :])
                for feat in (32, 64):
                    x = nn.relu(nn.Conv(feat, (3, 3), padding='VALID',
                                        dtype=self.dtype)(x))
                x = x.reshape(x.shape[:-3] + (-1,))
            else:
                c = (image.shape[-1] if self.packed_obs
                     else image.shape[-2] * image.shape[-3])
                w = self.param('img_kernel', nn.initializers.lecun_normal(),
                               (c * 21, self.hidden), jnp.float32)
                x = nets.one_hot_image(image, self.dtype,
                                       packed=self.packed_obs)
                lead = 2 if self.packed_obs else 3
                h = x.reshape(x.shape[:-lead] + (-1,)) @ w.astype(self.dtype)
                d = nn.Dense(self.hidden, dtype=self.dtype)(dir_feats)
                x = nn.relu(h + d)
            x = nn.relu(nn.Dense(self.hidden, dtype=self.dtype)(x))
            logits = nn.Dense(
                self.num_actions, dtype=self.dtype)(x).astype(jnp.float32)
            value = nn.Dense(1, dtype=self.dtype)(x).astype(jnp.float32)
            return logits, value.squeeze(-1)

    class CentralizedCritic(nn.Module):
        hidden: int = 128
        dtype: jnp.dtype = jnp.bfloat16
        num_missions: int = 0
        packed_obs: bool = False

        @nn.compact
        def __call__(self, images, directions, mission=None):
            x = nets.one_hot_image(images, self.dtype, packed=self.packed_obs)
            lead = 3 if self.packed_obs else 4
            x = x.reshape(x.shape[:-lead] + (-1,))
            theta = directions.astype(self.dtype) * (jnp.pi / 2)
            dirf = jnp.stack([jnp.cos(theta), jnp.sin(theta)], axis=-1)
            dirf = dirf.reshape(dirf.shape[:-2] + (-1,))
            if self.num_missions > 0 and mission is not None:
                dirf = jnp.concatenate([dirf, jax.nn.one_hot(
                    mission[..., 0], self.num_missions, dtype=self.dtype)],
                    axis=-1)
            h = nn.Dense(self.hidden, dtype=self.dtype)(x)
            d = nn.Dense(self.hidden, use_bias=False, dtype=self.dtype)(dirf)
            x = nn.relu(h + d)
            x = nn.relu(nn.Dense(self.hidden, dtype=self.dtype)(x))
            value = nn.Dense(1, dtype=self.dtype)(x).astype(jnp.float32)
            return value.squeeze(-1)

    return ActorCritic, CentralizedCritic


def _inputs(packed: bool, missions: bool, lead=(5, 3)):
    k = jax.random.split(jax.random.key(0), 3)
    if packed:
        t = jax.random.randint(k[0], lead + (49,), 0, 11)
        image = (t << 8) | ((t % 6) << 4) | (t % 4)
    else:
        image = jax.random.randint(k[0], lead + (7, 7, 3), 0, 6)
    direction = jax.random.randint(k[1], lead, 0, 4)
    mission = jax.random.randint(k[2], lead, 0, 12) if missions else None
    return image, direction, mission


def _assert_same_tree(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    assert ([x.shape for x in jax.tree.leaves(a)]
            == [x.shape for x in jax.tree.leaves(b)])
    assert all(x.dtype == jnp.float32 for x in jax.tree.leaves(b))


@pytest.mark.parametrize('missions', [False, True])
@pytest.mark.parametrize('packed', [False, True])
@pytest.mark.parametrize('encoder', ['cnn', 'mlp'])
def test_actor_critic_matches_flax(linen, encoder, packed, missions):
    flax_ac, _ = _flax_nets(linen)
    kw = dict(encoder=encoder, packed_obs=packed, hidden=32,
              num_missions=12 if missions else 0, dtype=jnp.float32)
    image, direction, mission = _inputs(packed, missions)
    one = (image[0, 0], direction[0, 0],
           None if mission is None else mission[0, 0])
    ref_params = flax_ac(**kw).init(jax.random.key(1), *one)
    params = nets.ActorCritic(**kw).init(jax.random.key(1), *one)
    _assert_same_tree(ref_params, params)
    # Bit-equal in float32 on the same parameters, at any batch shape.
    want = flax_ac(**kw).apply(ref_params, image, direction, mission)
    got = nets.ActorCritic(**kw).apply(ref_params, image, direction, mission)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize('packed', [False, True])
def test_centralized_critic_matches_flax(linen, packed):
    _, flax_cc = _flax_nets(linen)
    kw = dict(packed_obs=packed, hidden=32, num_missions=12,
              dtype=jnp.float32)
    image, direction, mission = _inputs(packed, True)
    ref_params = flax_cc(**kw).init(
        jax.random.key(2), image[0], direction[0], mission[0])
    params = nets.CentralizedCritic(**kw).init(
        jax.random.key(2), image[0], direction[0], mission[0])
    _assert_same_tree(ref_params, params)
    want = flax_cc(**kw).apply(ref_params, image, direction, mission)
    got = nets.CentralizedCritic(**kw).apply(
        ref_params, image, direction, mission)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_init_is_lecun_normal_with_zero_biases():
    """Kernels are lecun-normal (std 1/sqrt(fan_in), drawn from a normal
    truncated at 2 of its own σ and rescaled by 1/0.8796 so the std comes
    out right), biases zero, and the bf16 net keeps float32 parameters."""
    net = nets.ActorCritic(encoder='mlp', packed_obs=True, hidden=64)
    image, direction, _ = _inputs(True, False, lead=())
    params = net.init(jax.random.key(3), image, direction)['params']
    w = np.asarray(params['img_kernel'])
    assert w.dtype == np.float32
    assert abs(w.std() * np.sqrt(w.shape[0]) - 1.0) < 0.05
    assert np.abs(w).max() <= 2.0 / 0.8796 / np.sqrt(w.shape[0])
    for name in ('Dense_0', 'Dense_1', 'Dense_2', 'Dense_3'):
        assert not np.asarray(params[name]['bias']).any()
    logits, value = net.apply({'params': params}, image, direction)
    assert logits.dtype == value.dtype == jnp.float32
