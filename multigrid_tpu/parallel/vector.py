"""Lockstep batched environments with on-device auto-reset.

``VectorEnv`` lifts a functional :class:`~multigrid_tpu.envs.env.MultiGridEnv`
to a batch of ``num_envs`` independent instances running in lockstep under one
``jit``. Episode boundaries are handled *inside* the step: whenever an env
is done (all agents terminated, or truncated — multigrid/base.py:534-539),
a fresh layout is generated from that env's PRNG stream and swapped in with a
predicated select, so stepping never leaves the device and never recompiles.

The reference has no vectorized execution at all — it delegates rollout
parallelism to Ray env-runner worker processes
(multigrid/scripts/train.py:147-151). Here the env batch is a device-mesh
axis: pass a ``Mesh`` (or let :meth:`shard` build one) and batched state is
laid out with the leading axis split over the ``'env'`` axis; XLA then runs
the same program on every chip with zero cross-chip communication in the env
step itself.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ..core.actions import NUM_ACTIONS
from ..core.state import MultiGridState
from ..envs.env import MultiGridEnv
from ..ops.obs import gen_obs
from ..ops.step import sample_order
from .mesh import env_sharding, make_mesh

#: Keys the VectorEnv smuggles through ``state.extras`` for the amortized
#: reset pool; stripped before any per-env vmapped code sees the state.
_RESERVE = '_vec:reserve'
_GSTEP = '_vec:gstep'
_RKEY = '_vec:rkey'


class VectorEnv:
    """``num_envs`` lockstep copies of an environment, as pure functions.

    Usage::

        venv = VectorEnv(make('MultiGrid-Empty-8x8-v0', agents=2), 4096)
        obs, state = venv.reset(jax.random.key(0))
        obs, state, rew, term, trunc, done, success = venv.step(state, actions)

    All returned arrays have a leading ``(num_envs, ...)`` axis. ``done`` is
    ``(num_envs,)`` — True where the *previous* episode ended this step and
    the returned obs/state belong to a freshly reset episode (the standard
    lockstep auto-reset contract; final-step rewards/terminations are the
    ending episode's). ``success`` is ``(num_envs,)`` — the env's exact
    task-completion predicate (:meth:`MultiGridEnv.success`) evaluated on
    the final *pre-reset* state; meaningful where ``done`` is True.
    """

    def __init__(
        self,
        env: MultiGridEnv,
        num_envs: int,
        *,
        auto_reset: bool = True,
        mesh: Mesh | None = None,
        reset_pool: bool | None = None,
        reset_pool_period: int | None = None,
        packed_obs: bool = False,
    ):
        self.env = env
        self.num_envs = num_envs
        self.auto_reset = auto_reset
        self.mesh = mesh
        self._sharding = env_sharding(mesh) if mesh is not None else None
        if packed_obs:
            # Packed images are a training-throughput format: int32 cells
            # (type<<8|color<<4|state) carry 1/3 the rollout-storage
            # traffic of the channel triples.
            # Observation wrappers expect channel triples, so only base envs
            # qualify; 4-bit fields bound color/state indices.
            from ..core.constants import Color, State
            assert type(env).transform_obs is MultiGridEnv.transform_obs, (
                'packed_obs requires an unwrapped env (observation wrappers '
                'operate on (vs, vs, 3) channel triples)')
            assert len(Color) <= 16 and len(State) <= 16
        self.packed_obs = packed_obs
        if reset_pool is None:
            # Procedurally generated layouts (RoomGrid families) are far too
            # expensive to regenerate for every env every step — amortize
            # them through the reserve pool. Cheap layouts (Empty) keep the
            # exact every-step reset.
            reset_pool = bool(getattr(env, 'procedural_reset', False))
        self.reset_pool = reset_pool and auto_reset
        # Pool bit-packing needs every field to fit its 4-bit lane
        # (extensible enums can outgrow them — fall back to raw storage).
        from ..core.constants import Color as _Color
        from ..core.constants import State as _State
        from ..core.constants import Type as _Type
        self._pool_packed = (
            len(_Color) <= 16 and len(_State) <= 16 and len(_Type) <= 16)
        if reset_pool_period is None:
            # Longest refresh period with zero layout replay for episodes of
            # at least ``period`` steps (every reserve slot is regenerated
            # between consecutive truncation-driven consumptions), capped so
            # early-terminating envs don't grow arbitrarily stale. Larger
            # periods are faster (fewer layouts regenerated per step).
            reset_pool_period = min(128, max(1, env.cfg.max_steps))
        assert reset_pool_period >= 1
        self.reset_pool_period = reset_pool_period

    @classmethod
    def sharded(cls, env: MultiGridEnv, num_envs: int, **kwargs) -> 'VectorEnv':
        """VectorEnv over all local devices (env axis = full device mesh)."""
        return cls(env, num_envs, mesh=make_mesh(), **kwargs)

    # ------------------------------------------------------------- pure fns

    @property
    def num_agents(self) -> int:
        return self.env.num_agents

    def _constrain(self, tree):
        if self._sharding is None:
            return tree
        return jax.lax.with_sharding_constraint(tree, self._sharding)

    @functools.partial(jax.jit, static_argnums=0)
    def reset(self, key: jax.Array):
        """Reset all envs. Returns ``(obs, state)`` with leading (E, ...)."""
        key, pool_key = jax.random.split(key)
        keys = jax.random.split(key, self.num_envs)
        if self._sharding is not None:
            keys = jax.lax.with_sharding_constraint(keys, self._sharding)
        obs, state = jax.vmap(self.env.reset)(keys)
        if self.packed_obs:
            obs = self._pack_obs(obs)
        if self.reset_pool:
            state = self._attach_pool(state, pool_key)
        return self._constrain((obs, state))

    # -------------------------------------------------- amortized reset pool
    #
    # Pool storage format: the reserve's grid (and box_contents) leaves are
    # bit-packed into ONE flat int32 plane (t<<8|c<<4|s, box contents in
    # bits 12-23). The pool's per-step moves — the rotating-offset roll and
    # the consumption select's reserve read — stream 3-6x fewer bytes than
    # the raw (E, W, H, 3) triples; the unpack is elementwise and fuses
    # into the select.

    def _pool_pack(self, s: MultiGridState) -> MultiGridState:
        """Pack grid (+ box_contents) into one flat int32 leaf."""
        if not self._pool_packed:
            return s
        g = s.grid
        p = (g[..., 0] << 8) | (g[..., 1] << 4) | g[..., 2]
        p = p.reshape(p.shape[:-2] + (-1,))
        if s.box_contents.size:
            b = s.box_contents
            bp = (b[..., 0] << 8) | (b[..., 1] << 4) | b[..., 2]
            p = p | (bp.reshape(p.shape) << 12)
            s = s.replace(box_contents=jnp.zeros(
                b.shape[:-3] + (0, 0, 3), jnp.int32))
        return s.replace(grid=p)

    def _pool_unpack(self, s: MultiGridState,
                     like: MultiGridState) -> MultiGridState:
        """Inverse of :meth:`_pool_pack`; ``like`` supplies the raw shapes."""
        if not self._pool_packed:
            return s
        p = s.grid
        w, h = like.grid.shape[-3], like.grid.shape[-2]
        g12 = p & 0xFFF
        grid = jnp.stack([g12 >> 8, (g12 >> 4) & 15, g12 & 15], axis=-1)
        grid = grid.reshape(p.shape[:-1] + (w, h, 3))
        s = s.replace(grid=grid)
        if like.box_contents.size:
            b12 = (p >> 12) & 0xFFF
            bc = jnp.stack([b12 >> 8, (b12 >> 4) & 15, b12 & 15], axis=-1)
            s = s.replace(
                box_contents=bc.reshape(p.shape[:-1] + (w, h, 3)))
        return s

    #
    # Procedural layout generation (RoomGrid's connect_all + sequential
    # placements) dominates the step when recomputed for every env every
    # step. The pool amortizes it: each env carries a pregenerated "next
    # layout" (the reserve); auto-reset consumes it with the same free
    # predicated select, and every step only ``num_envs / reset_pool_period``
    # reserves are regenerated (a rotating slice — one dynamic_update_slice,
    # not per-env scatters). Each slot's layout is a fresh independent draw
    # (fold of the slot's key stream with the refresh counter).
    #
    # Consumption reads the reserve through a rotating offset: at global
    # step g, env i consumes slot (i + g) mod E. Consecutive episode ends of
    # the same env therefore always land on *different* slots — an env never
    # replays the layout it just played, no matter how short its episodes
    # (trained policies finish BUP/RedBlueDoors in tens of steps, far under
    # the refresh period). The residual deviation from exact per-episode
    # resets: a slot's layout can be consumed by up to ``reset_pool_period``
    # *different* envs (one per step) before its refresh — duplicate layouts
    # across the batch at different times, bounded by done-rate × period,
    # instead of the temporally-correlated within-env replay that biased
    # on-policy training. The rolled read fuses into the consumption select,
    # which already streams the full reserve.

    def _attach_pool(self, state: MultiGridState, key: jax.Array):
        """Generate the initial reserve and stash pool state in extras."""
        k_res, k_stream = jax.random.split(key)
        reserve = self._pool_pack(jax.vmap(self.env.reset_core)(
            jax.random.split(k_res, self.num_envs)))
        # Store key material as raw uint32 so pool leaves support
        # dynamic_update_slice during refresh.
        reserve = reserve.replace(rng=jax.random.key_data(reserve.rng))
        return state.replace(extras={
            **state.extras,
            _RESERVE: reserve,
            _GSTEP: jnp.zeros((self.num_envs,), jnp.int32),
            _RKEY: jax.random.key_data(
                jax.random.split(k_stream, self.num_envs)),
        })

    @staticmethod
    def _strip_pool(state: MultiGridState):
        """Detach pool entries so per-env vmapped code never sees them."""
        extras = dict(state.extras)
        pool = {
            k: extras.pop(k) for k in (_RESERVE, _GSTEP, _RKEY)
            if k in extras
        }
        if pool:
            state = state.replace(extras=extras)
        return state, pool

    def _refresh_pool(self, pool: dict, new_state: MultiGridState,
                      chunk: int = 1):
        """Regenerate a rotating slice of the reserve covering ``chunk``
        steps' worth of slots.

        (A ``lax.cond``-gated "big slice every K steps" variant keeps a
        conditional inside the rollout scan, which defeats buffer aliasing
        for the carried pool, so per-step refresh stays unconditional. The
        *chunked* form instead moves the refresh OUT of the step scan
        entirely: rollout loops call :meth:`refresh_pool` once per chunk of
        ``refresh=False`` steps. The win is not traffic but program latency:
        the procedural layout chain (sequential placements with reductions
        between) is launch-bound at any slice width.)
        """
        e = self.num_envs
        # ceil: the rotation must cover all slots within the period.
        c = min(e, max(1, -(-e // self.reset_pool_period)) * chunk)
        n_slices = -(-e // c)
        g0 = pool[_GSTEP][0]
        cursor = g0 if chunk == 1 else g0 // chunk
        start = (cursor % n_slices) * c  # dynamic_slice clamps the tail
        keys = jax.random.wrap_key_data(
            jax.lax.dynamic_slice_in_dim(pool[_RKEY], start, c, 0))
        fresh_keys = jax.vmap(lambda k: jax.random.fold_in(k, g0))(keys)
        fresh = self._pool_pack(jax.vmap(self.env.reset_core)(fresh_keys))
        fresh = fresh.replace(rng=jax.random.key_data(fresh.rng))
        reserve = jax.tree.map(
            lambda r, f: jax.lax.dynamic_update_slice_in_dim(r, f, start, 0),
            pool[_RESERVE], fresh,
        )
        return {_RESERVE: reserve, _GSTEP: pool[_GSTEP] + (1 if chunk == 1
                                                           else 0),
                _RKEY: pool[_RKEY]}

    @functools.partial(jax.jit, static_argnums=(0, 2), donate_argnums=1)
    def refresh_pool(self, state: MultiGridState, chunk: int):
        """Regenerate ``chunk`` steps' worth of reserve slots in one burst.

        Pair with ``step(..., refresh=False)``: a rollout loop that steps
        ``chunk`` times without per-step regeneration and then calls this
        once preserves the pool's freshness contract (every slot
        regenerated within ``reset_pool_period`` steps, consumption offset
        still advancing every step) while paying the launch-bound layout
        chain once per chunk instead of once per step.
        """
        state, pool = self._strip_pool(state)
        if not pool:
            return state
        pool = self._refresh_pool(pool, state, chunk=chunk)
        return state.replace(extras={**state.extras, **pool})

    @functools.partial(jax.jit, static_argnums=0,
                       static_argnames=('refresh',), donate_argnums=1)
    def step(self, state: MultiGridState, actions: jax.Array,
             *, refresh: bool = True):
        """Step all envs; auto-reset finished episodes inside the step.

        ``refresh=False`` skips the per-step reserve-pool regeneration (the
        consumption offset still advances); the caller then owes one
        :meth:`refresh_pool` per chunk of such steps. Rollout loops
        (``rollout_random``, the PPO train step) use this automatically —
        the procedural layout chain is launch-bound, so it runs once per
        chunk instead of once per step.

        Observation generation — the most expensive part — runs exactly
        once, on the post-auto-reset merged state: finished envs observe
        their fresh layout, running envs their post-action pre-hook state
        (the reference generates obs before subclass step() hooks run,
        base.py:337).

        Parameters
        ----------
        state : batched MultiGridState (leading E axis; donated)
        actions : (E, N) int32

        Returns
        -------
        (obs, state, rewards, terminations, truncations, done, success)
        """

        state, pool = self._strip_pool(state)

        def one(s, a):
            order_key, rng = jax.random.split(s.rng)
            order = sample_order(order_key, self.env.cfg.num_agents)
            s = s.replace(rng=rng)
            return self.env.step_core(s, a, order, None)

        obs_state, new_state, rew, term, trunc = jax.vmap(one)(state, actions)
        done = jnp.all(term, axis=-1) | jnp.any(trunc, axis=-1)
        # Exact task completion, evaluated on the final post-hook state
        # BEFORE auto-reset swaps in a fresh layout (the predicate reads
        # episode state — door flags, carried objects — that the reset
        # erases). Meaningful where ``done``; a cheap all-lanes eval.
        success = jax.vmap(self.env.success)(new_state)
        if self.auto_reset:
            if pool:
                # Consume the pregenerated reserve through the rotating
                # offset (see the pool notes above): env i reads slot
                # (i + gstep) mod E, so an env's consecutive episode ends
                # never replay one slot. Fresh per-env step RNG regardless.
                folded = jax.vmap(
                    lambda k: jax.random.fold_in(k, 1)
                )(new_state.rng)
                offset = pool[_GSTEP][0] % self.num_envs
                reserve = jax.tree.map(
                    lambda r: jnp.roll(r, -offset, axis=0), pool[_RESERVE])
                # Unpack the pool's bit-packed grid plane; elementwise, so
                # it fuses into the consumption select below.
                reserve = self._pool_unpack(reserve, new_state)
                reset_state = reserve.replace(rng=folded)
            else:
                # Exact path: one fixed-cost reset computed for every env
                # each step (fine for cheap layouts).
                reset_key = jax.vmap(
                    lambda s: jax.random.fold_in(s.rng, 0)
                )(new_state)
                reset_state = jax.vmap(self.env.reset_core)(reset_key)

            def sel(r, s):
                d = done.reshape(done.shape + (1,) * (r.ndim - 1))
                return jnp.where(d, r, s)

            # step_core returns the SAME tracers for obs_state and new_state
            # on every leaf post_step left untouched — share the merged
            # select per LEAF, so an env whose hook only flips door flags
            # (LockedHallway) or termination bits (BUP) doesn't pay a second
            # full-grid select each step (all-or-nothing sharing previously
            # double-selected the whole state whenever ANY leaf differed).
            shared = [
                a is b for a, b in zip(
                    jax.tree.leaves(obs_state), jax.tree.leaves(new_state))
            ]
            new_state = jax.tree.map(sel, reset_state, new_state)
            if all(shared):
                obs_state = new_state
            else:
                treedef = jax.tree.structure(obs_state)
                merged = [
                    ns if sh else sel(r, o)
                    for sh, ns, r, o in zip(
                        shared,
                        jax.tree.leaves(new_state),
                        jax.tree.leaves(reset_state),
                        jax.tree.leaves(obs_state))
                ]
                obs_state = jax.tree.unflatten(treedef, merged)
        obs = self._gen_obs_batched(obs_state)
        obs = jax.vmap(self.env.attach_mission)(obs, obs_state)
        obs = jax.vmap(self.env.transform_obs)(obs, obs_state)
        if pool:
            if refresh:
                pool = self._refresh_pool(pool, new_state)
            else:
                # Consumption bookkeeping only: the offset must advance
                # every step (an env's consecutive episode ends must land
                # on different slots); regeneration is the caller's
                # refresh_pool() debt.
                pool = {**pool, _GSTEP: pool[_GSTEP] + 1}
            new_state = new_state.replace(
                extras={**new_state.extras, **pool})
        return self._constrain(
            (obs, new_state, rew, term, trunc, done, success))

    def _gen_obs_batched(self, state: MultiGridState):
        """Raw observations for a batched state: the single-env obs path
        (ops/obs.py) vmapped over envs."""
        cfg = self.env.cfg
        obs = jax.vmap(lambda s: gen_obs(cfg, s))(state)
        return self._pack_obs(obs) if self.packed_obs else obs

    def _pack_obs(self, obs):
        """Pack (…, vs, vs, 3) channel triples into int32 cells
        (``type<<8 | color<<4 | state``), flattened to a (…, vs·vs) cell
        axis."""
        img = obs['image']
        packed = (
            (img[..., 0].astype(jnp.int32) << 8)
            | (img[..., 1].astype(jnp.int32) << 4)
            | img[..., 2].astype(jnp.int32)
        )
        packed = packed.reshape(packed.shape[:-2] + (-1,))
        return {**obs, 'image': packed}

    @functools.partial(jax.jit, static_argnums=0)
    def observe(self, state: MultiGridState):
        state, _ = self._strip_pool(state)
        obs = jax.vmap(self.env.observe)(state)
        if self.packed_obs:
            obs = self._pack_obs(obs)
        return self._constrain(obs)

    # ------------------------------------------------------------ rollouts

    #: Steps per chunked pool refresh in rollout loops (the launch-bound
    #: layout chain runs once per chunk instead of once per step).
    _REFRESH_CHUNK = 16

    @functools.partial(jax.jit, static_argnums=(0, 3), donate_argnums=1)
    def rollout_random(self, state: MultiGridState, key: jax.Array, steps: int):
        """Advance ``steps`` lockstep steps with uniform-random actions.

        The throughput benchmark core: one fused scan, nothing leaves the
        device until the final state. Returns ``(state, summary)`` where
        summary holds reward/done tallies plus an observation checksum — the
        checksum gives observation generation a live data dependency, so XLA
        cannot dead-code-eliminate it out of the benchmark.

        With a reserve pool, steps run in chunks of ``_REFRESH_CHUNK``
        refresh-less steps followed by one chunked pool refresh (same
        freshness contract; the launch-bound procedural layout chain runs
        once per chunk instead of once per step).
        """
        def body(refresh):
            def _body(carry, _):
                st, k, rew_sum, done_sum, obs_sum = carry
                k, ak = jax.random.split(k)
                actions = jax.random.randint(
                    ak, (self.num_envs, self.num_agents), 0, NUM_ACTIONS,
                    dtype=jnp.int32,
                )
                obs, st, rew, _, _, done, _suc = self.step(
                    st, actions, refresh=refresh)
                # The image is the expensive leaf — checksum it specifically
                # so obs generation stays live (dict iteration order would
                # otherwise pick 'direction', leaving the image dead code).
                obs_leaf = obs['image'] \
                    if isinstance(obs, dict) and 'image' in obs \
                    else jax.tree.leaves(obs)[-1]
                return (
                    st, k,
                    rew_sum + rew.sum(),
                    done_sum + done.sum(),
                    obs_sum + obs_leaf.sum(dtype=jnp.int32),
                ), None
            return _body

        carry = (
            state,
            key,
            jnp.zeros((), jnp.float32),
            jnp.zeros((), jnp.int32),
            jnp.zeros((), jnp.int32),
        )
        ck = self._REFRESH_CHUNK
        rem = steps
        if self.reset_pool and steps >= ck:
            def chunk_body(carry, _):
                carry, _ = jax.lax.scan(body(False), carry, None, length=ck)
                st = self.refresh_pool(carry[0], ck)
                return (st,) + carry[1:], None

            carry, _ = jax.lax.scan(
                chunk_body, carry, None, length=steps // ck)
            rem = steps % ck
        if rem:
            carry, _ = jax.lax.scan(body(True), carry, None, length=rem)
        (state, _, rew_sum, done_sum, obs_sum) = carry
        return state, {
            'reward_sum': rew_sum, 'episodes': done_sum, 'obs_sum': obs_sum,
        }
