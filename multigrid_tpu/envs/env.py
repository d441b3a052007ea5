"""Functional environment base class.

The functional counterpart of ``MultiGridEnv`` (multigrid/base.py:36): instead
of a stateful ``gym.Env``, an environment object holds only *static*
configuration and exposes pure functions

    reset(key)                  -> (obs, state)
    step(state, actions)        -> (obs, state, rewards, terms, truncs)
    step_with_order(state, actions, order) -> same, deterministic core

that jit, vmap and shard. Episode state lives entirely in the
:class:`MultiGridState` pytree.

Subclasses implement ``_gen_grid(key) -> MultiGridState`` (on-device layout
generation, the pure-function analogue of base.py:229-248) and may override
``post_step`` (the analogue of env-specific ``step()`` post-processing, e.g.
envs/blockedunlockpickup.py:166-175).
"""

from __future__ import annotations

import abc
import functools

import jax
import jax.numpy as jnp

from ..core.config import EnvConfig
from ..core.state import MultiGridState
from ..ops.obs import gen_obs
from ..ops.step import sample_order, step_with_order


class MultiGridEnv(abc.ABC):
    """Base class for functional multi-agent gridworld environments."""

    #: Mission string template; environments with placeholder arguments
    #: override :meth:`mission_of` instead.
    mission: str = "maximize reward"

    #: True when ``_gen_grid`` does expensive procedural generation —
    #: VectorEnv then amortizes auto-reset layouts through its reserve pool
    #: instead of regenerating every env's layout every step.
    procedural_reset: bool = False

    #: Whether this environment's layouts can ever contain a Box. Box-free
    #: environments (Empty, RedBlueDoors, LockedHallway) set this False so
    #: their state carries a ZERO-sized ``box_contents`` table — the full
    #: (W, H, 3) side table is otherwise dead HBM traffic in every step
    #: and auto-reset select (core/state.py init_state, ops/step.py).
    uses_boxes: bool = True

    def __init__(
        self,
        *,
        agents: int = 1,
        grid_size: int | None = None,
        width: int | None = None,
        height: int | None = None,
        max_steps: int = 100,
        see_through_walls: bool = False,
        agent_view_size: int = 7,
        allow_agent_overlap: bool = True,
        joint_reward: bool = False,
        success_termination_mode: str = 'any',
        failure_termination_mode: str = 'all',
        render_mode: str | None = None,
        **_unused_render_kwargs,
    ):
        width, height = (grid_size, grid_size) if grid_size else (width, height)
        assert width is not None and height is not None
        self.cfg = EnvConfig(
            width=width,
            height=height,
            num_agents=agents,
            max_steps=max_steps,
            see_through_walls=see_through_walls,
            view_size=agent_view_size,
            allow_agent_overlap=allow_agent_overlap,
            joint_reward=joint_reward,
            success_any=(success_termination_mode == 'any'),
            failure_any=(failure_termination_mode == 'any'),
        )
        self.render_mode = render_mode

    # ------------------------------------------------------------------ API

    @property
    def num_agents(self) -> int:
        return self.cfg.num_agents

    @property
    def width(self) -> int:
        return self.cfg.width

    @property
    def height(self) -> int:
        return self.cfg.height

    @abc.abstractmethod
    def _gen_grid(self, key: jax.Array) -> MultiGridState:
        """Generate a fresh episode layout on device (pure function of key)."""

    def mission_of(self, state: MultiGridState) -> str | None:
        """Host-side mission string for a (single-env) state."""
        return self.mission

    @property
    def mission_space(self):
        """Space of mission strings (reference core/mission.py:45-136).

        Environments with placeholder-parameterized missions override this.
        """
        from ..core.mission import MissionSpace
        return MissionSpace.from_string(self.mission)

    def mission_index(self, state: MultiGridState) -> jax.Array | None:
        """Per-episode index into :attr:`mission_space`, or None when the
        mission is static. Mission-parameterized environments override this
        so batched training can condition on the mission (the reference's
        obs carry the mission, base.py:368-376)."""
        return None

    def attach_mission(self, obs, state: MultiGridState):
        """Add the per-agent mission index to an observation dict (no-op for
        static-mission environments)."""
        mi = self.mission_index(state)
        if mi is None or not isinstance(obs, dict):
            return obs
        return {**obs, 'mission': jnp.broadcast_to(
            jnp.asarray(mi, jnp.int32), (self.cfg.num_agents,))}

    def success(self, state: MultiGridState) -> jax.Array:
        """() bool — whether the episode's *task* is complete in ``state``.

        The exact completion signal behind the training ``success_rate``
        metric (evaluated on the final pre-reset state when an episode
        ends), replacing the positive-return proxy that credited partial
        progress (e.g. one unlocked LockedHallway room banks reward without
        completing the task). The base default — any agent terminated — is
        exact for environments where agent termination only ever happens on
        task success (Empty's goal cell, reference base.py:478-507;
        BlockedUnlockPickup's box pickup). Environments with failure
        terminations (RedBlueDoors) or terminations that bypass agent state
        (LockedHallway) override this with a state predicate.
        """
        return jnp.any(state.agent_terminated)

    def transform_obs(self, obs, state: MultiGridState):
        """Observation post-processing hook; identity for base environments.

        Observation wrappers compose through this so batched execution
        (VectorEnv) can generate raw observations once and apply the wrapper
        chain afterwards.
        """
        return obs

    def transform_space(self, agent_space):
        """Per-agent observation-space transform hook; identity here.
        Observation wrappers compose through this so adapters report the
        space wrapped observations actually inhabit (the reference wrappers
        mutate ``agent.observation_space``, multigrid/wrappers.py:41-58)."""
        return agent_space

    def post_step(
        self,
        prev_state: MultiGridState,
        state: MultiGridState,
        actions: jax.Array,
        rewards: jax.Array,
        terminations: jax.Array,
        action_mask: jax.Array,
    ) -> tuple[MultiGridState, jax.Array, jax.Array]:
        """Env-specific post-step hook (may adjust state/rewards/terms).

        Runs *after* observation generation, matching the reference ordering
        where subclass ``step()`` bodies post-process the base class result
        (e.g. envs/redbluedoors.py:170-187 closes a door after obs were
        already generated).
        """
        return state, rewards, terminations

    # -------------------------------------------------------------- core fns

    def reset_core(self, key: jax.Array) -> MultiGridState:
        """Fresh episode state without observation generation."""
        gen_key, rng = jax.random.split(key)
        state = self._gen_grid(gen_key)
        return state.replace(
            rng=rng, step_count=jnp.zeros((), dtype=jnp.int32)
        )

    @functools.partial(jax.jit, static_argnums=0)
    def reset(self, key: jax.Array):
        """Start a new episode. Returns ``(obs, state)`` (base.py:250-301)."""
        state = self.reset_core(key)
        obs = self.attach_mission(gen_obs(self.cfg, state), state)
        return obs, state

    @functools.partial(jax.jit, static_argnums=0)
    def step(
        self,
        state: MultiGridState,
        actions: jax.Array,
        action_mask: jax.Array | None = None,
    ):
        """Advance one timestep with a random agent action order.

        ``action_mask`` marks agents that supplied an action this step
        (agents missing from the action dict are skipped in the reference,
        base.py:403-404). Returns
        ``(obs, state, rewards, terminations, truncations)``.
        """
        order_key, rng = jax.random.split(state.rng)
        order = sample_order(order_key, self.cfg.num_agents)
        state = state.replace(rng=rng)
        return self._step_inner(state, actions, order, action_mask)

    @functools.partial(jax.jit, static_argnums=0)
    def step_with_order(
        self,
        state: MultiGridState,
        actions: jax.Array,
        order: jax.Array,
        action_mask: jax.Array | None = None,
    ):
        """Deterministic step core used by the parity harness: the caller
        supplies the agent action order (reference base.py:396-399 draws it
        from the seeded ``np_random`` stream)."""
        return self._step_inner(state, actions, order, action_mask)

    @functools.partial(jax.jit, static_argnums=0)
    def observe(self, state: MultiGridState):
        """Generate observations for an existing state (base.py:348-376)."""
        return self.attach_mission(gen_obs(self.cfg, state), state)

    def step_core(self, state, actions, order, action_mask=None):
        """Dynamics + post-step hook WITHOUT observation generation.

        Returns ``(obs_state, state, rewards, terms, truncs)`` where
        ``obs_state`` is the post-action, *pre-hook* state observations must
        be generated from (base.py:337 generates obs before subclass step()
        bodies run), and ``state`` is the carried post-hook state. Used by
        batched execution to generate observations exactly once per step
        (after auto-reset merging).
        """
        prev_state = state
        if action_mask is None:
            action_mask = jnp.ones((self.cfg.num_agents,), dtype=jnp.bool_)
        state, rewards, terms, truncs = step_with_order(
            self.cfg, state, actions, order, action_mask
        )
        obs_state = state
        state, rewards, terms = self.post_step(
            prev_state, state, actions, rewards, terms, action_mask
        )
        return obs_state, state, rewards, terms, truncs

    def _step_inner(self, state, actions, order, action_mask):
        obs_state, state, rewards, terms, truncs = self.step_core(
            state, actions, order, action_mask
        )
        obs = self.attach_mission(gen_obs(self.cfg, obs_state), obs_state)
        return obs, state, rewards, terms, truncs

    # ---------------------------------------------------------------- helpers

    def is_done(self, terminations: jax.Array, truncations: jax.Array) -> jax.Array:
        """Whether the episode is finished for all agents (base.py:534-539)."""
        return jnp.all(terminations) | jnp.any(truncations)

    def __repr__(self):
        return f'{self.__class__.__name__}({self.cfg})'
