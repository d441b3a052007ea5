"""PPO with env + learner co-located on one device mesh.

One jitted ``train_step``: rollout ``T`` lockstep steps across the sharded env
batch (scan of policy-forward + env-step, all on device), compute GAE, then a
clipped-PPO update. With envs sharded over the mesh's ``'env'`` axis and
parameters replicated, the only cross-chip traffic is the gradient
all-reduce XLA inserts at the update, which can overlap with the backward
pass.

Functional equivalent of the reference's RLlib PPO example
(multigrid/scripts/train.py:126-199), minus the Ray process topology: where
the reference ships observations between env-runner workers and a torch
learner through Ray's object store, here "shipping" is a sharding constraint.
All agents share one policy by default (self-play); set
``PPOConfig(per_agent_policies=True)`` for the reference's independent
``policy_{i}`` scheme (scripts/train.py:154-158) — a stacked parameter
pytree with a leading agent axis, vmapped at apply time.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
import optax

from ..parallel.vector import VectorEnv
from ..utils import struct
from .nets import ActorCritic, CentralizedCritic


def make_centralized_critic(net: ActorCritic) -> CentralizedCritic:
    """The joint-observation critic matched to an actor net's attributes."""
    return CentralizedCritic(
        hidden=net.hidden, dtype=net.dtype,
        num_missions=net.num_missions, packed_obs=net.packed_obs)


@struct.dataclass
class PPOConfig:
    rollout_steps: int = struct.field(pytree_node=False, default=16)
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    epochs: int = struct.field(pytree_node=False, default=1)
    #: SGD minibatches per epoch (RLlib PPO reuses the batch in shuffled
    #: minibatches; 1 = whole-batch updates). Minibatches are contiguous env
    #: blocks (unbiased — envs are iid) with a per-epoch T-permutation and
    #: env-axis roll; no batch-wide gather, and nothing crosses the sharded
    #: env axis on a mesh.
    minibatches: int = struct.field(pytree_node=False, default=1)
    #: Independent parameters per agent (the reference's policy_{i}).
    per_agent_policies: bool = struct.field(pytree_node=False, default=False)
    #: MAPPO-style centralized critic: the value function conditions on ALL
    #: agents' observations (actors stay partial). The remedy for
    #: independent-PPO's failure on coordination chains under a joint
    #: reward (per-agent BUP, docs/LEARNING.md) — beyond the reference's
    #: capability (its policy_{i} modules are fully independent).
    centralized_critic: bool = struct.field(pytree_node=False, default=False)


@struct.dataclass
class TrainState:
    params: Any
    opt_state: Any
    env_state: Any
    last_obs: Any
    key: jax.Array
    update_count: jax.Array
    #: (E,) running return of each env's current episode (all agents summed)
    #: — carried across update boundaries so the episode_reward metric is
    #: the exact mean episodic return (RLlib's episode_reward_mean), not a
    #: window estimate biased by episodes straddling rollout windows.
    ep_return_acc: jax.Array = None


@struct.dataclass
class Rollout:
    """(T, E, N, ...) trajectory slices."""
    image: jax.Array
    direction: jax.Array
    action: jax.Array
    log_prob: jax.Array
    value: jax.Array
    reward: jax.Array
    done: jax.Array
    #: Mission indices for mission-parameterized envs (None otherwise).
    mission: jax.Array | None = None


def _select_log_prob(logits: jax.Array, action: jax.Array) -> jax.Array:
    """log softmax(logits)[action] as a one-hot contraction: the masked sum
    fuses with the log-softmax, where ``take_along_axis`` would lower to a
    gather."""
    log_probs = jax.nn.log_softmax(logits)
    onehot = jax.nn.one_hot(
        action, logits.shape[-1], dtype=log_probs.dtype)
    return jnp.sum(log_probs * onehot, axis=-1)


def clip_by_global_norm_per_agent(max_norm: float):
    """Like ``optax.clip_by_global_norm`` but with an independent norm per
    leading-axis (agent) parameter slice, so one agent's gradient spike does
    not rescale every other agent's update."""

    def init_fn(params):
        del params
        return optax.EmptyState()

    def update_fn(updates, state, params=None):
        del params
        sq = sum(
            jnp.sum(jnp.square(g), axis=tuple(range(1, g.ndim)))
            for g in jax.tree.leaves(updates)
        )  # (N,)
        norm = jnp.sqrt(sq)
        scale = jnp.minimum(1.0, max_norm / (norm + 1e-16))

        def apply(g):
            s = scale.reshape(scale.shape + (1,) * (g.ndim - 1))
            return g * s

        return jax.tree.map(apply, updates), state

    return optax.GradientTransformation(init_fn, update_fn)


def ppo_init(
    venv: VectorEnv,
    key: jax.Array,
    *,
    net: ActorCritic | None = None,
    config: PPOConfig | None = None,
    per_agent_policies: bool | None = None,
    net_kwargs: dict | None = None,
    lr_schedule=None,
):
    """Initialize (train_state, net, config, optimizer).

    Prefer ``net_kwargs`` (e.g. ``dict(hidden=128, encoder='cnn')``) over a
    prebuilt ``net``: the net is then constructed here with
    ``num_missions`` sized from the env's mission space and ``packed_obs``
    matched to the VectorEnv's observation format. A prebuilt ``net`` is
    honored as-is — with a loud warning if the env surfaces a mission index
    the net cannot condition on.

    ``PPOConfig(per_agent_policies=True)`` gives each agent its own
    parameters (the reference example trains an independent ``policy_{i}``
    per agent, multigrid/scripts/train.py:154-158) — a stacked parameter
    pytree with a leading agent axis, vmapped at apply time, clipped per
    agent slice. Default is shared-parameter self-play. (The keyword
    argument is a deprecated alias for the config field.)
    """
    config = config or PPOConfig()
    if per_agent_policies is not None:
        config = config.replace(per_agent_policies=per_agent_policies)
    k_env, k_net, k_train = jax.random.split(key, 3)
    obs, env_state = venv.reset(k_env)
    # Mission-parameterized envs surface an index in the obs — size the
    # conditioning one-hot from the env's mission space automatically.
    num_missions = len(venv.env.mission_space) if 'mission' in obs else 0
    packed = bool(getattr(venv, 'packed_obs', False))
    if net is None:
        net = ActorCritic(
            num_missions=num_missions, packed_obs=packed,
            **(net_kwargs or {}))
    else:
        assert not net_kwargs, 'pass either net or net_kwargs, not both'
        if num_missions and net.num_missions == 0:
            import warnings
            warnings.warn(
                f'{type(venv.env).__name__} surfaces a mission index but '
                'the supplied net has num_missions=0 — mission conditioning '
                'is OFF. Construct the net via ppo_init(net_kwargs=...) to '
                'auto-size it.', stacklevel=2)
        assert net.packed_obs == packed, (
            f'net.packed_obs={net.packed_obs} does not match '
            f'VectorEnv(packed_obs={packed})')
    mission0 = obs['mission'][0, 0] if 'mission' in obs else None
    if config.per_agent_policies:
        net_keys = jax.random.split(k_net, venv.num_agents)
        params = jax.vmap(
            lambda k: net.init(
                k, obs['image'][0, 0], obs['direction'][0, 0], mission0)
        )(net_keys)
        clip = clip_by_global_norm_per_agent(config.max_grad_norm)
    else:
        params = net.init(
            k_net, obs['image'][0, 0], obs['direction'][0, 0], mission0
        )
        clip = optax.clip_by_global_norm(config.max_grad_norm)
    if config.centralized_critic:
        # The critic module is reconstructed deterministically from the
        # actor net's attributes here and in make_train_step (nets are
        # stateless definitions).
        critic = make_centralized_critic(net)
        cparams = critic.init(
            jax.random.fold_in(k_net, 1), obs['image'][0],
            obs['direction'][0], obs['mission'][0] if 'mission' in obs
            else None)
        params = {'actor': params, 'critic': cparams}
        clip = optax.multi_transform(
            {'actor': clip, 'critic': optax.clip_by_global_norm(
                config.max_grad_norm)},
            lambda p: {
                'actor': jax.tree.map(lambda _: 'actor', p['actor']),
                'critic': jax.tree.map(lambda _: 'critic', p['critic']),
            })
    tx = optax.chain(clip, optax.adam(
        config.lr if lr_schedule is None else lr_schedule))
    state = TrainState(
        params=params,
        opt_state=tx.init(params),
        env_state=env_state,
        last_obs=obs,
        key=k_train,
        update_count=jnp.zeros((), jnp.int32),
        ep_return_acc=jnp.zeros((venv.num_envs,), jnp.float32),
    )
    return state, net, config, tx


def make_train_step(
    venv: VectorEnv,
    net: ActorCritic,
    config: PPOConfig,
    tx: optax.GradientTransformation,
    per_agent_policies: bool | None = None,
) -> Callable[[TrainState], tuple[TrainState, dict]]:
    """Build the jitted PPO update: rollout + GAE + clipped surrogate step.

    With ``config.per_agent_policies`` the parameter pytree carries a leading
    agent axis (see :func:`ppo_init`) and each agent's observations route
    through its own parameters via ``vmap`` — the reference's independent
    ``policy_{i}`` scheme (multigrid/scripts/train.py:154-158). The keyword
    argument is a deprecated alias for the config field.
    """
    if per_agent_policies is not None:
        config = config.replace(per_agent_policies=per_agent_policies)

    centralized = config.centralized_critic
    critic = make_centralized_critic(net) if centralized else None

    def actor_params(params):
        return params['actor'] if centralized else params

    def central_value(params, image, direction, mission):
        """(..., N) broadcast of the joint-observation value V(o_1..o_N)."""
        v = critic.apply(params['critic'], image, direction, mission)
        return jnp.broadcast_to(v[..., None], direction.shape)

    if config.per_agent_policies:
        # The image's agent axis depends on the obs format: packed images
        # are (..., N, vs²) flat cells, triples are (..., N, vs, vs, 3).
        _img_agent_axis = -2 if getattr(net, 'packed_obs', False) else -4

        def apply_net(params, image, direction, mission=None):
            # Agent axis to front, one net application per agent's
            # parameter slice.
            img = jnp.moveaxis(image, _img_agent_axis, 0)
            dirn = jnp.moveaxis(direction, -1, 0)
            mis = None if mission is None else jnp.moveaxis(mission, -1, 0)
            if mis is None:
                logits, value = jax.vmap(
                    lambda p, i, d: net.apply(p, i, d))(params, img, dirn)
            else:
                logits, value = jax.vmap(net.apply)(params, img, dirn, mis)
            return jnp.moveaxis(logits, 0, -2), jnp.moveaxis(value, 0, -1)
    else:
        apply_net = net.apply

    def policy(params, obs):
        # obs arrays are (E, N, ...): agents ride the leading batch axes.
        logits, value = apply_net(
            actor_params(params), obs['image'], obs['direction'],
            obs.get('mission'))
        if centralized:
            value = central_value(
                params, obs['image'], obs['direction'], obs.get('mission'))
        return logits, value

    def sample_policy(params, obs, k_act):
        """(action, log_prob, value), each (E, N)."""
        logits, value = policy(params, obs)
        action = jax.random.categorical(k_act, logits)
        return action, _select_log_prob(logits, action), value

    def rollout_phase(state: TrainState):
        def body(carry, _):
            env_state, obs, key, ep_acc, ep_sum, ep_cnt, ep_suc = carry
            key, k_act = jax.random.split(key)
            action, log_prob, value = sample_policy(state.params, obs, k_act)
            # refresh=False: the reserve pool's launch-bound layout chain
            # runs ONCE per rollout (refresh_pool(T) below), not per step.
            next_obs, env_state, reward, term, trunc, done, success = \
                venv.step(env_state, action.astype(jnp.int32),
                          refresh=not venv.reset_pool)
            # Exact episodic-return bookkeeping (all agents summed per
            # episode — RLlib's episode_reward_mean convention): accumulate
            # across update boundaries, bank on episode end. An episode
            # counts as a success when the env's exact task-completion
            # predicate holds on its final pre-reset state
            # (MultiGridEnv.success) — not the old positive-return proxy,
            # which credited partial progress on multi-goal envs
            # (LockedHallway banks reward per unlocked door).
            ep_acc = ep_acc + reward.sum(-1)
            ep_sum = ep_sum + jnp.where(done, ep_acc, 0.0).sum()
            ep_cnt = ep_cnt + done.sum()
            ep_suc = ep_suc + (done & success).sum()
            ep_acc = jnp.where(done, 0.0, ep_acc)
            step_data = Rollout(
                image=obs['image'], direction=obs['direction'],
                action=action, log_prob=log_prob, value=value,
                reward=reward, done=done[:, None] | term,
                mission=obs.get('mission'),
            )
            return (env_state, next_obs, key, ep_acc, ep_sum, ep_cnt,
                    ep_suc), step_data

        ep_acc0 = state.ep_return_acc
        if ep_acc0 is None:  # restored from a pre-metric checkpoint
            ep_acc0 = jnp.zeros((venv.num_envs,), jnp.float32)
        (env_state, last_obs, key, ep_acc, ep_sum, ep_cnt, ep_suc), traj = \
            jax.lax.scan(
                body,
                (state.env_state, state.last_obs, state.key, ep_acc0,
                 jnp.zeros((), jnp.float32), jnp.zeros((), jnp.int32),
                 jnp.zeros((), jnp.int32)),
                None, length=config.rollout_steps,
            )
        if venv.reset_pool:
            # The rollout's deferred pool-refresh debt: regenerate T steps'
            # worth of reserve slots in one burst (same freshness contract).
            env_state = venv.refresh_pool(env_state, config.rollout_steps)
        _, last_value = policy(state.params, last_obs)
        state = state.replace(
            env_state=env_state, last_obs=last_obs, key=key,
            ep_return_acc=ep_acc)
        return state, traj, last_value, (ep_sum, ep_cnt, ep_suc)

    def compute_gae(traj: Rollout, last_value: jax.Array):
        def body(carry, step):
            gae, next_value = carry
            value, reward, done = step
            not_done = 1.0 - done.astype(jnp.float32)
            delta = reward + config.gamma * next_value * not_done - value
            gae = delta + config.gamma * config.gae_lambda * not_done * gae
            return (gae, value), gae

        (_, _), advantages = jax.lax.scan(
            body,
            (jnp.zeros_like(last_value), last_value),
            (traj.value, traj.reward, traj.done),
            reverse=True,
            # The body is a handful of elementwise ops on (E, N) slices;
            # a device loop pays a fixed per-iteration cost that dwarfs the
            # math. Past T=32 a partial unroll keeps the amortization with
            # bounded program size (full unroll at T=128 inflates compile).
            unroll=True if config.rollout_steps <= 32 else 16,
        )
        return advantages, advantages + traj.value

    def loss_fn(params, traj: Rollout, advantages, targets):
        logits, value = apply_net(
            actor_params(params), traj.image, traj.direction, traj.mission)
        if centralized:
            # Joint-observation value broadcast to every agent; the actor
            # net's own value head receives zero gradient and goes unused.
            value = central_value(
                params, traj.image, traj.direction, traj.mission)
        log_probs = jax.nn.log_softmax(logits)
        log_prob = _select_log_prob(logits, traj.action)
        ratio = jnp.exp(log_prob - traj.log_prob)
        if config.per_agent_policies:
            # Normalize within each agent's own batch — pooling the stats
            # across agents would couple the 'independent' policies through
            # each other's reward statistics. (Batch axes = all but the
            # trailing agent axis, so this works on both (T, E, N) rollouts
            # and flattened (B, N) minibatches.)
            axes = tuple(range(advantages.ndim - 1))
            mu = advantages.mean(axis=axes, keepdims=True)
            sd = advantages.std(axis=axes, keepdims=True)
        else:
            mu = advantages.mean()
            sd = advantages.std()
        adv = (advantages - mu) / (sd + 1e-8)
        pg_loss = -jnp.minimum(
            ratio * adv,
            jnp.clip(ratio, 1 - config.clip_eps, 1 + config.clip_eps) * adv,
        ).mean()
        vf_loss = 0.5 * jnp.square(value - targets).mean()
        entropy = -(jnp.exp(log_probs) * log_probs).sum(-1).mean()
        loss = pg_loss + config.vf_coef * vf_loss - config.ent_coef * entropy
        return loss, {
            'loss': loss, 'pg_loss': pg_loss, 'vf_loss': vf_loss,
            'entropy': entropy,
        }

    def sgd_step(params, opt_state, traj, advantages, targets):
        grads, metrics = jax.grad(loss_fn, has_aux=True)(
            params, traj, advantages, targets)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, metrics

    @jax.jit
    def train_step(state: TrainState) -> tuple[TrainState, dict]:
        state, traj, last_value, (ep_sum, ep_cnt, ep_suc) = \
            rollout_phase(state)
        advantages, targets = compute_gae(traj, last_value)

        params, opt_state = state.params, state.opt_state
        if config.minibatches == 1:
            # Whole-batch epochs: no permutation, no data movement.
            metrics = None
            for _ in range(config.epochs):
                params, opt_state, metrics = sgd_step(
                    params, opt_state, traj, advantages, targets)
        else:
            # RLlib-style minibatched SGD (multigrid/scripts/train.py:126-169)
            # without the full-batch permutation gather: a random permutation
            # over the flattened (T·E) rows costs a B-row gather per epoch
            # and crosses the sharded env axis on a mesh (all-to-all). The
            # envs are iid, so partitioning minibatches as contiguous env
            # blocks is already an unbiased sample; shuffling needs only to
            # break (a) intra-env time ordering — a T-axis permutation
            # (16-row coarse gather, never touches the env axis) — and
            # (b) block composition across epochs — an env-axis roll (a ring
            # shift; on a mesh a cheap collective permute, never all-to-all).
            t, e = advantages.shape[:2]
            assert e % config.minibatches == 0, (
                f'env batch {e} not divisible by '
                f'{config.minibatches} minibatches')
            key, k_perm = jax.random.split(state.key)
            state = state.replace(key=key)
            batch = (traj, advantages, targets)

            def epoch_body(carry, ek):
                params, opt_state = carry
                k_t, k_e = jax.random.split(ek)
                perm_t = jax.random.permutation(k_t, t)
                off_e = jax.random.randint(k_e, (), 0, e)
                c = e // config.minibatches

                def shuffle(x):
                    x = jnp.take(x, perm_t, axis=0)
                    x = jnp.roll(x, off_e, axis=1)
                    # (T, M, c, ...) → (M, T, c, ...): minibatch m is all T
                    # steps of its env block.
                    x = x.reshape((t, config.minibatches, c) + x.shape[2:])
                    return jnp.swapaxes(x, 0, 1)

                mb = jax.tree.map(shuffle, batch)

                def mb_body(carry, data):
                    params, opt_state = carry
                    tr, adv, tg = data
                    params, opt_state, m = sgd_step(
                        params, opt_state, tr, adv, tg)
                    return (params, opt_state), m

                (params, opt_state), ms = jax.lax.scan(
                    mb_body, (params, opt_state), mb)
                return (params, opt_state), jax.tree.map(
                    lambda x: x[-1], ms)

            (params, opt_state), ms = jax.lax.scan(
                epoch_body, (params, opt_state),
                jax.random.split(k_perm, config.epochs),
            )
            metrics = jax.tree.map(lambda x: x[-1], ms)

        metrics['reward_per_step'] = traj.reward.mean()
        # Exact mean episodic return (all agents' rewards summed per episode,
        # the RLlib episode_reward_mean convention) over episodes *completed*
        # this update — the per-env accumulator carries across update
        # boundaries, so straddling episodes are fully credited when they
        # finish rather than biasing the window estimate.
        metrics['episodes_in_batch'] = ep_cnt.astype(jnp.float32)
        metrics['episode_reward'] = jnp.where(
            ep_cnt > 0, ep_sum / jnp.maximum(ep_cnt, 1), jnp.nan)
        # Fraction of completed episodes whose final state satisfied the
        # env's exact task-completion predicate (MultiGridEnv.success) — the
        # success-rate readout for sparse-reward envs (RedBlueDoors, BUP,
        # LockedHallway's all-doors-unlocked).
        metrics['success_rate'] = jnp.where(
            ep_cnt > 0, ep_suc / jnp.maximum(ep_cnt, 1), jnp.nan)
        state = state.replace(
            params=params, opt_state=opt_state,
            update_count=state.update_count + 1,
        )
        return state, metrics

    # Phase handles for profiling/ablation harnesses (scripts/measure_train.py
    # times each stage in situ through these; they are the very closures
    # train_step composes, so a stage probe measures the production code).
    train_step.rollout_phase = rollout_phase
    train_step.compute_gae = compute_gae
    train_step.loss_fn = loss_fn
    train_step.sgd_step = sgd_step
    return train_step


def make_train_loop(
    venv: VectorEnv,
    net: ActorCritic,
    config: PPOConfig,
    tx: optax.GradientTransformation,
    updates_per_call: int,
    per_agent_policies: bool | None = None,
) -> Callable[[TrainState], tuple[TrainState, dict]]:
    """``updates_per_call`` PPO updates fused into one jitted scan.

    Amortizes per-call dispatch overhead and lets XLA pipeline consecutive
    updates. Returned metrics are the mean over the scanned updates.
    """
    train_step = make_train_step(
        venv, net, config, tx, per_agent_policies=per_agent_policies)

    @jax.jit
    def train_loop(state: TrainState) -> tuple[TrainState, dict]:
        def body(s, _):
            s, metrics = train_step(s)
            return s, metrics

        state, metrics = jax.lax.scan(
            body, state, None, length=updates_per_call)
        # nanmean: episode_reward is NaN for updates whose rollout window
        # completed no episodes.
        return state, jax.tree.map(lambda m: jnp.nanmean(m), metrics)

    return train_loop
