"""Policy/value networks for gridworld observations.

The architecture mirrors the reference's RLlib module — a 3-layer CNN encoder
over the one-hot observation image with the direction broadcast-concatenated
as (cos, sin) feature planes (multigrid/scripts/train.py:56-83), feeding
independent actor and critic heads (scripts/train.py:86-120) — written as
plain JAX with bfloat16 compute and float32 parameters.

A network is a frozen dataclass of hyperparameters with two pure functions:
``init(key, *example_inputs) -> params`` and ``apply(params, *inputs)``.
Parameters are a nested dict ``{'params': {layer: {'kernel', 'bias'}}}``
whose layer names (``Conv_i``, ``Dense_i``, ``img_kernel``) number each layer
kind in the order the forward pass creates it. Kernels are lecun-normal,
biases zero.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from ..core.constants import Color, State, Type

#: One-hot channel widths per encoding slot: type, color, max(state, direction)
#: (multigrid/wrappers.py:139-147).
OBS_CHANNELS = (len(Type), len(Color), max(len(State), 4))

#: One-hot feature channels per observed cell.
_NCH = sum(OBS_CHANNELS)

_lecun_normal = jax.nn.initializers.lecun_normal()


def one_hot_image(
    image: jax.Array, dtype=jnp.bfloat16, packed: bool = False
) -> jax.Array:
    """Observation image → one-hot feature planes.

    ``packed=False``: (..., vs, vs, 3) int channel triples →
    (..., vs, vs, 21) planes.
    ``packed=True``: (..., vs·vs) bit-packed int32 cells
    (``type<<8 | color<<4 | state``; storing rollouts packed carries 1/3 the
    memory traffic of the triples) → (..., vs·vs, 21) planes, same
    cell-major feature order once flattened.

    The construction is ONE fused elementwise comparison against per-channel
    (shift, mask, value) constants — building three per-field one-hots and
    concatenating them materializes the 21-channel tensor three times over,
    which XLA does not fuse away.
    """
    widths = OBS_CHANNELS
    edges = (widths[0], widths[0] + widths[1])
    ch = jnp.arange(sum(widths), dtype=jnp.int32)
    if packed:
        shift = jnp.where(ch < edges[0], 8, jnp.where(ch < edges[1], 4, 0))
        mask = jnp.where(ch < edges[0], -1, 15)
        cmp = ch - jnp.where(
            ch < edges[0], 0, jnp.where(ch < edges[1], edges[0], edges[1]))
        return (
            ((image[..., None] >> shift) & mask) == cmp
        ).astype(dtype)
    field = jnp.where(
        ch < edges[0], 0, jnp.where(ch < edges[1], 1, 2))
    cmp = ch - jnp.where(
        ch < edges[0], 0, jnp.where(ch < edges[1], edges[0], edges[1]))
    return (jnp.take(image, field, axis=-1) == cmp).astype(dtype)


class _Layers:
    """Parameter access for one forward pass.

    Applying reads layers from ``params``; initializing (``key`` given)
    creates each layer from the shape of its input, as it is reached.
    """

    def __init__(self, params: dict, dtype, key: jax.Array | None = None):
        self.params = params
        self.dtype = dtype
        self.key = key
        self._count: dict[str, int] = {}

    def _layer(self, kind: str) -> str:
        i = self._count.get(kind, 0)
        self._count[kind] = i + 1
        return f'{kind}_{i}'

    def _get(self, name: str, shapes: dict[str, tuple]) -> dict:
        if self.key is None:
            return self.params[name]
        k = jax.random.fold_in(self.key, len(self.params))
        layer = {}
        for leaf, shape in shapes.items():
            layer[leaf] = (_lecun_normal(k, shape, jnp.float32)
                           if leaf == 'kernel'
                           else jnp.zeros(shape, jnp.float32))
        self.params[name] = layer
        return layer

    def kernel(self, name: str, shape: tuple) -> jax.Array:
        """A bare float32 weight matrix named ``name``."""
        if self.key is None:
            return self.params[name]
        k = jax.random.fold_in(self.key, len(self.params))
        self.params[name] = _lecun_normal(k, shape, jnp.float32)
        return self.params[name]

    def dense(self, x: jax.Array, features: int,
              use_bias: bool = True) -> jax.Array:
        shapes = {'kernel': (x.shape[-1], features)}
        if use_bias:
            shapes['bias'] = (features,)
        p = self._get(self._layer('Dense'), shapes)
        x = x.astype(self.dtype)
        y = jax.lax.dot_general(
            x, p['kernel'].astype(self.dtype),
            (((x.ndim - 1,), (0,)), ((), ())))
        if use_bias:
            y = y + p['bias'].astype(self.dtype)
        return y

    def conv3x3(self, x: jax.Array, features: int) -> jax.Array:
        """3×3 VALID convolution over (..., H, W, C) inputs (NHWC/HWIO)."""
        p = self._get(self._layer('Conv'), {
            'kernel': (3, 3, x.shape[-1], features), 'bias': (features,)})
        batch = x.shape[:-3]
        x = x.reshape((-1,) + x.shape[-3:]).astype(self.dtype)
        y = jax.lax.conv_general_dilated(
            x, p['kernel'].astype(self.dtype), (1, 1), 'VALID',
            dimension_numbers=('NHWC', 'HWIO', 'NHWC'))
        y = y + p['bias'].astype(self.dtype)
        return y.reshape(batch + y.shape[1:])


@dataclasses.dataclass(frozen=True)
class _Net:
    """``init``/``apply`` over a ``_forward(layers, *inputs)`` definition."""

    def init(self, key: jax.Array, *inputs) -> dict:
        layers = _Layers({}, self.dtype, key)
        self._forward(layers, *inputs)
        return {'params': layers.params}

    def apply(self, params: dict, *inputs):
        return self._forward(_Layers(params['params'], self.dtype), *inputs)


@dataclasses.dataclass(frozen=True)
class ActorCritic(_Net):
    """Encoder + categorical actor + value critic.

    Inputs are a single agent's observation dict pieces; batching over agents
    and envs is the caller's ``vmap``/leading-axes concern.

    Encoders:

    * ``'cnn'`` (default) — the reference example's architecture: 3×Conv+ReLU
      over one-hot feature planes with (cos, sin) direction channels
      (multigrid/scripts/train.py:56-83).
    * ``'mlp'`` — the throughput encoder: the same one-hot features flattened
      into one wide Dense layer, one (batch, 49·21)×(49·21, hidden) matmul in
      place of three small convolutions.
    """

    num_actions: int = 7
    hidden: int = 128
    encoder: str = 'cnn'
    dtype: Any = jnp.bfloat16
    #: Size of the env's mission space; 0 disables mission conditioning.
    #: Mission-parameterized envs (e.g. BlockedUnlockPickup) surface the
    #: per-episode mission index in the obs dict (the reference's obs carry
    #: the mission string, base.py:368-376) — it enters the encoder as a
    #: one-hot feature vector.
    num_missions: int = 0
    #: Expect bit-packed observation images (``VectorEnv(packed_obs=True)``)
    #: instead of (vs, vs, 3) triples.
    packed_obs: bool = False

    def _forward(self, layers: _Layers, image: jax.Array,
                 direction: jax.Array, mission: jax.Array | None = None):
        """Returns ``(logits, value)``: (..., num_actions) and (...,) f32."""
        theta = direction.astype(self.dtype) * (jnp.pi / 2)
        dir_feats = jnp.stack([jnp.cos(theta), jnp.sin(theta)], axis=-1)
        if self.num_missions > 0 and mission is not None:
            dir_feats = jnp.concatenate([
                dir_feats,
                jax.nn.one_hot(mission, self.num_missions, dtype=self.dtype),
            ], axis=-1)

        # The direction/mission features enter the first layer as an ADDITIVE
        # dense contribution instead of a channel concat: concatenating a
        # 2-channel plane onto the (vs, vs, 21) one-hot forces a full copy of
        # the feature tensor per step (and broadcasting constant planes, as
        # the reference does at scripts/train.py:56-63, is mathematically a
        # per-position bias — W·[x; d] == W_x·x + W_d·d).
        if self.encoder == 'cnn':
            if self.packed_obs:
                # Restore the (vs, vs) spatial view the convs need; packed
                # images carry a flat cell axis.
                vs = int(round(image.shape[-1] ** 0.5))
                image = image.reshape(image.shape[:-1] + (vs, vs))
            x = one_hot_image(image, self.dtype, packed=self.packed_obs)
            h = layers.conv3x3(x, 16)
            d = layers.dense(dir_feats, 16, use_bias=False)
            x = jax.nn.relu(h + d[..., None, None, :])
            for feat in (32, 64):
                x = jax.nn.relu(layers.conv3x3(x, feat))
            x = x.reshape(x.shape[:-3] + (-1,))
        else:
            if self.packed_obs:
                c = image.shape[-1]
            else:
                c = image.shape[-2] * image.shape[-3]
            w = layers.kernel('img_kernel', (c * _NCH, self.hidden))
            x = one_hot_image(image, self.dtype, packed=self.packed_obs)
            # Packed images carry (…, vs², 21) planes (flat cell axis),
            # triples (…, vs, vs, 21); either way features flatten
            # cell-major.
            lead = 2 if self.packed_obs else 3
            h = x.reshape(x.shape[:-lead] + (-1,)) @ w.astype(self.dtype)
            d = layers.dense(dir_feats, self.hidden)
            x = jax.nn.relu(h + d)
        # The wide dense layer is the natural tensor-parallel shard point;
        # the training step constrains its output over the 'model' mesh axis.
        x = jax.nn.relu(layers.dense(x, self.hidden))

        # Heads compute in bf16 like the trunk (f32 head compute makes the
        # backward materialize f32 (batch, hidden) tensors — 2x the traffic
        # of the entire bf16 trunk); only the small outputs are promoted, so
        # log-softmax and the value loss still run in f32.
        logits = layers.dense(x, self.num_actions).astype(jnp.float32)
        value = layers.dense(x, 1).astype(jnp.float32)
        return logits, value.squeeze(-1)


@dataclasses.dataclass(frozen=True)
class CentralizedCritic(_Net):
    """Joint-observation value function for MAPPO-style training.

    Conditions on ALL agents' observations and directions at once (the
    actors stay partial): V(o_1..o_N) instead of per-agent V(o_i). This is
    the fix for the independent-PPO failure mode on coordination chains
    (BlockedUnlockPickup with per-agent policies: independently normalized
    advantages under a joint reward de-correlate the agents' credit —
    docs/LEARNING.md) — a capability the reference example does not have
    (its ``policy_{i}`` modules are fully independent,
    multigrid/scripts/train.py:154-158).

    Inputs are one env's joint observation; batching is the caller's
    leading-axes concern (the module is written elementwise over the
    trailing (N, cells) axes).
    """

    hidden: int = 128
    dtype: Any = jnp.bfloat16
    num_missions: int = 0
    packed_obs: bool = False

    def _forward(self, layers: _Layers, images: jax.Array,
                 directions: jax.Array,
                 mission: jax.Array | None = None) -> jax.Array:
        """images: (..., N, vs·vs) packed or (..., N, vs, vs, 3) triples;
        directions: (..., N); mission: (..., N) episode mission indices
        (identical across agents — agent 0's is used). Returns (...,)."""
        x = one_hot_image(images, self.dtype, packed=self.packed_obs)
        lead = 3 if self.packed_obs else 4  # (N, cells[, vs], channels)
        x = x.reshape(x.shape[:-lead] + (-1,))
        theta = directions.astype(self.dtype) * (jnp.pi / 2)
        dirf = jnp.stack([jnp.cos(theta), jnp.sin(theta)], axis=-1)
        dirf = dirf.reshape(dirf.shape[:-2] + (-1,))  # (..., 2N)
        if self.num_missions > 0 and mission is not None:
            dirf = jnp.concatenate([
                dirf,
                jax.nn.one_hot(mission[..., 0], self.num_missions,
                               dtype=self.dtype),
            ], axis=-1)
        h = layers.dense(x, self.hidden)
        d = layers.dense(dirf, self.hidden, use_bias=False)
        x = jax.nn.relu(h + d)
        x = jax.nn.relu(layers.dense(x, self.hidden))
        value = layers.dense(x, 1).astype(jnp.float32)
        return value.squeeze(-1)
