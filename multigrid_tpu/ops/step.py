"""The jitted environment transition kernel.

Array-native replacement for the reference's sequential Python action loop
(multigrid/base.py:378-476). Agents act **sequentially in a given order** —
conflicts are resolved by order, not simultaneously — so the kernel applies
``N`` masked sub-steps via ``lax.scan``. Every sub-step is branch-free: the
action semantics are expressed as predicated array updates, which vectorize
cleanly under ``vmap`` over thousands of environments.

Exact semantics reproduced (see SURVEY.md §2.2):

* left/right: ``dir = (dir ∓ 1) % 4``                      (base.py:412-417)
* forward: target must be empty/goal/floor/lava/open-door  (base.py:420-436,
  world_object.py:197-201,287,314,339,452); optional agent-occupancy block
  including terminated agents (base.py:425-429); landing on goal → success,
  lava → failure (base.py:432-436)
* pickup: fwd is key/ball/box and hands empty               (base.py:439-446)
* drop: carrying, fwd cell empty, and no agent there        (base.py:449-459)
* toggle: Door unlock-with-matching-key / open-close flip   (world_object.py:458-474);
  Box replaced by its contents                              (world_object.py:599-605)
* done: no-op                                               (base.py:470-471)
* success/failure side effects: termination modes 'any'/'all', joint vs.
  individual reward ``1 - 0.9·step_count/max_steps``        (base.py:478-532,598-602)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.actions import Action
from ..core.config import EnvConfig
from ..core.constants import (
    DIR_TO_VEC,
    EMPTY_ENCODING,
    STATE_CLOSED,
    STATE_LOCKED,
    STATE_OPEN,
    TYPE_BALL,
    TYPE_BOX,
    TYPE_DOOR,
    TYPE_EMPTY,
    TYPE_FLOOR,
    TYPE_GOAL,
    TYPE_KEY,
    TYPE_LAVA,
    TYPE_WALL,
)
from ..core.state import MultiGridState

_A_LEFT = int(Action.left)
_A_RIGHT = int(Action.right)
_A_FORWARD = int(Action.forward)
_A_PICKUP = int(Action.pickup)
_A_DROP = int(Action.drop)
_A_TOGGLE = int(Action.toggle)


def can_overlap(cell_type: jax.Array, cell_state: jax.Array) -> jax.Array:
    """Whether an agent may walk onto a cell with this encoding.

    Matches WorldObj.can_overlap overrides: empty cells, goal, floor, lava,
    and open doors (world_object.py:197-201,287-291,314-318,339-343,452-456).
    """
    return (
        (cell_type == TYPE_EMPTY)
        | (cell_type == TYPE_GOAL)
        | (cell_type == TYPE_FLOOR)
        | (cell_type == TYPE_LAVA)
        | ((cell_type == TYPE_DOOR) & (cell_state == STATE_OPEN))
    )


def can_pickup(cell_type: jax.Array) -> jax.Array:
    """Whether an agent may pick up a cell's object (key/ball/box;
    world_object.py:518-522,556-560,587-591)."""
    return (cell_type == TYPE_KEY) | (cell_type == TYPE_BALL) | (cell_type == TYPE_BOX)


def apply_success(
    cfg: EnvConfig,
    agent_onehot: jax.Array,
    fire: jax.Array,
    terminated: jax.Array,
    rewards: jax.Array,
    reward_value: jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """Predicated equivalent of ``MultiGridEnv.on_success`` (base.py:478-507).

    When ``fire`` is True: terminate all agents ('any' mode) or just the
    agent selected by the ``agent_onehot`` mask ('all' mode), and assign (not
    add) the reward to all agents (joint) or just the selected agent. The
    one-hot mask (rather than an index) keeps the update scatter-free.
    """
    term_on = jnp.ones_like(terminated) if cfg.success_any \
        else (terminated | agent_onehot)
    terminated = jnp.where(fire, term_on, terminated)
    rew_on = jnp.full_like(rewards, reward_value) if cfg.joint_reward \
        else jnp.where(agent_onehot, reward_value, rewards)
    rewards = jnp.where(fire, rew_on, rewards)
    return terminated, rewards


def apply_failure(
    cfg: EnvConfig,
    agent_onehot: jax.Array,
    fire: jax.Array,
    terminated: jax.Array,
) -> jax.Array:
    """Predicated equivalent of ``MultiGridEnv.on_failure`` (base.py:509-532).

    Failure pays zero reward; only termination flags change.
    """
    term_on = jnp.ones_like(terminated) if cfg.failure_any \
        else (terminated | agent_onehot)
    return jnp.where(fire, term_on, terminated)


#: Agent-count threshold between the unrolled sub-step form (XLA fuses the
#: one-hot reads/writes across sub-steps) and the ``lax.scan`` form (bounded
#: program size for large teams). Both forms are bit-identical.
UNROLL_MAX_AGENTS = 8


def handle_actions(
    cfg: EnvConfig,
    state: MultiGridState,
    actions: jax.Array,
    order: jax.Array,
    action_mask: jax.Array | None = None,
) -> tuple[MultiGridState, jax.Array]:
    """Apply all agents' actions sequentially in ``order``.

    Parameters
    ----------
    cfg : EnvConfig
        Static configuration.
    state : MultiGridState
        State *after* the step counter has been incremented (the reference
        increments before handling actions, base.py:333, and the success
        reward reads the incremented count, base.py:602).
    actions : (N,) int32
        Action for each agent.
    order : (N,) int32
        Permutation in which agents act (base.py:396-399).
    action_mask : (N,) bool, optional
        Which agents have an action this step (agents missing from the action
        dict are skipped in the reference, base.py:403-404).

    Returns
    -------
    (state, rewards) : updated state and per-agent rewards.
    """
    n = cfg.num_agents
    w, h = cfg.width, cfg.height
    if action_mask is None:
        action_mask = jnp.ones((n,), dtype=jnp.bool_)

    empty = jnp.asarray(EMPTY_ENCODING, dtype=jnp.int32)
    dir_vec = jnp.asarray(DIR_TO_VEC, dtype=jnp.int32)
    reward_value = (
        1.0 - 0.9 * state.step_count.astype(jnp.float32) / cfg.max_steps
    )
    rewards = jnp.zeros((n,), dtype=jnp.float32)

    # The agent index `i` below is a traced per-env value (the action order
    # differs per environment under vmap), so *indexed* reads/writes (x[i],
    # grid[fx, fy], .at[...].set) would lower to per-env gathers/scatters
    # over tiny trailing dims. Every access is instead expressed as a
    # one-hot select/masked update: elementwise work that XLA fuses across
    # the env batch.
    agent_iota = jnp.arange(n, dtype=jnp.int32)
    dir_iota = jnp.arange(4, dtype=jnp.int32)
    cell_x = jnp.arange(w, dtype=jnp.int32)[:, None]
    cell_y = jnp.arange(h, dtype=jnp.int32)[None, :]

    def substep(carry, i):
        st, rew = carry
        oh = agent_iota == i  # (N,) one-hot over agents

        def read_agent(arr):
            """arr: (N, ...) → arr[i] via one-hot reduce (no gather)."""
            m = oh.reshape((n,) + (1,) * (arr.ndim - 1))
            return jnp.sum(jnp.where(m, arr, 0), axis=0, dtype=arr.dtype)

        pos = read_agent(st.agent_pos)
        dirn = read_agent(st.agent_dir)
        carrying = read_agent(st.agent_carrying)
        carrying_contents = read_agent(st.agent_carrying_contents)
        act = read_agent(actions.astype(jnp.int32))
        active = (
            jnp.sum(jnp.where(oh, action_mask, False), axis=0, dtype=jnp.bool_)
            & ~jnp.sum(jnp.where(oh, st.agent_terminated, False), axis=0,
                       dtype=jnp.bool_)
        )

        # --- rotations -----------------------------------------------------
        is_left = active & (act == _A_LEFT)
        is_right = active & (act == _A_RIGHT)
        new_dir = jnp.where(
            is_left, (dirn - 1) % 4, jnp.where(is_right, (dirn + 1) % 4, dirn)
        )

        # --- forward-cell lookup (shared by forward/pickup/drop/toggle) ----
        # dir_vec[dirn] with traced dirn → select over the 4 static rows.
        fwd_dx = jnp.sum(jnp.where(dir_iota == dirn, dir_vec[:, 0], 0))
        fwd_dy = jnp.sum(jnp.where(dir_iota == dirn, dir_vec[:, 1], 0))
        fwd = jnp.stack([pos[0] + fwd_dx, pos[1] + fwd_dy])
        in_bounds = (fwd[0] >= 0) & (fwd[0] < w) & (fwd[1] >= 0) & (fwd[1] < h)
        # One-hot cell mask for the forward cell (W, H).
        cell_mask = (cell_x == fwd[0]) & (cell_y == fwd[1])

        def read_cell(grid):
            """grid[(fx, fy)] via masked reduce over all cells (no gather)."""
            return jnp.sum(
                jnp.where(cell_mask[..., None], grid, 0), axis=(0, 1),
                dtype=grid.dtype,
            )

        fwd_enc = read_cell(st.grid)
        ftype = jnp.where(in_bounds, fwd_enc[0], TYPE_WALL)
        fcolor = fwd_enc[1]
        fstate = fwd_enc[2]
        # Any agent (including terminated ones) standing on the fwd cell
        # (base.py:425-429,454-455 compare against the full position array).
        agent_at_fwd = jnp.any(jnp.all(st.agent_pos == fwd[None, :], axis=-1))

        # --- forward -------------------------------------------------------
        is_fwd = active & (act == _A_FORWARD)
        blocked_by_agent = (
            jnp.zeros((), jnp.bool_) if cfg.allow_agent_overlap else agent_at_fwd
        )
        move_ok = is_fwd & can_overlap(ftype, fstate) & ~blocked_by_agent
        new_pos = jnp.where(move_ok, fwd, pos)
        success = move_ok & (ftype == TYPE_GOAL)
        failure = move_ok & (ftype == TYPE_LAVA)

        # --- pickup ----------------------------------------------------------
        is_carrying = carrying[0] != TYPE_EMPTY
        do_pickup = active & (act == _A_PICKUP) & can_pickup(ftype) & ~is_carrying

        # --- drop ------------------------------------------------------------
        do_drop = (
            active
            & (act == _A_DROP)
            & is_carrying
            & (ftype == TYPE_EMPTY)
            & ~agent_at_fwd
        )

        # --- toggle ----------------------------------------------------------
        is_toggle = active & (act == _A_TOGGLE)
        door_locked = fstate == STATE_LOCKED
        has_matching_key = (carrying[0] == TYPE_KEY) & (carrying[1] == fcolor)
        new_door_state = jnp.where(
            door_locked,
            jnp.where(has_matching_key, STATE_OPEN, STATE_LOCKED),
            jnp.where(fstate == STATE_OPEN, STATE_CLOSED, STATE_OPEN),
        )
        do_toggle_door = is_toggle & (ftype == TYPE_DOOR)
        do_toggle_box = is_toggle & (ftype == TYPE_BOX)

        # --- compose the forward cell's new encoding -------------------------
        # Box-free environments carry a zero-sized box_contents table
        # (core/state.py init_state has_boxes=False): no Box can exist, so
        # the contents read is the empty encoding and the plane is never
        # touched — a static branch that removes ~half the dynamics HBM
        # traffic for Empty/RedBlueDoors/LockedHallway.
        has_boxes = st.box_contents.size > 0
        box_cont = read_cell(st.box_contents) if has_boxes else empty
        cell = fwd_enc
        cell = jnp.where(do_pickup, empty, cell)
        cell = jnp.where(do_drop, carrying, cell)
        cell = jnp.where(
            do_toggle_door,
            jnp.stack([fwd_enc[0], fwd_enc[1], new_door_state]),
            cell,
        )
        cell = jnp.where(do_toggle_box, box_cont, cell)

        cont_cell = box_cont
        cont_cell = jnp.where(do_pickup | do_toggle_box, empty, cont_cell)
        cont_cell = jnp.where(do_drop, carrying_contents, cont_cell)

        new_carrying = jnp.where(
            do_pickup, fwd_enc, jnp.where(do_drop, empty, carrying)
        )
        new_carrying_contents = jnp.where(
            do_pickup, box_cont, jnp.where(do_drop, empty, carrying_contents)
        )

        # --- success / failure side effects ----------------------------------
        terminated, rew = apply_success(
            cfg, oh, success, st.agent_terminated, rew, reward_value
        )
        terminated = apply_failure(cfg, oh, failure, terminated)

        # --- masked writes (no scatters) --------------------------------------
        cell_changed = do_pickup | do_drop | do_toggle_door | do_toggle_box
        write_mask = (cell_mask & cell_changed)[..., None]
        grid = jnp.where(write_mask, cell[None, None, :], st.grid)
        box_contents = jnp.where(
            write_mask, cont_cell[None, None, :], st.box_contents
        ) if has_boxes else st.box_contents

        ohc = oh[:, None]
        st = st.replace(
            grid=grid,
            box_contents=box_contents,
            agent_pos=jnp.where(ohc, new_pos[None, :], st.agent_pos),
            agent_dir=jnp.where(oh, new_dir, st.agent_dir),
            agent_carrying=jnp.where(
                ohc, new_carrying[None, :], st.agent_carrying
            ),
            agent_carrying_contents=jnp.where(
                ohc, new_carrying_contents[None, :],
                st.agent_carrying_contents
            ),
            agent_terminated=terminated,
        )
        return (st, rew), None

    # Unrolled over the (small, static) agent count: unrolling lets XLA fuse
    # the one-hot reads/writes across sub-steps instead of paying a
    # device-loop iteration per agent (~2× at N=4). Past UNROLL_MAX_AGENTS
    # the unrolled graph blows up compile time, so large teams scan (the
    # two forms are bit-identical — tests/test_invariants.py pins it).
    if n <= UNROLL_MAX_AGENTS:
        carry = (state, rewards)
        for t in range(n):
            carry, _ = substep(carry, order[t])
        state, rewards = carry
    else:
        (state, rewards), _ = jax.lax.scan(
            substep, (state, rewards), order)
    return state, rewards


def step_with_order(
    cfg: EnvConfig,
    state: MultiGridState,
    actions: jax.Array,
    order: jax.Array,
    action_mask: jax.Array | None = None,
) -> tuple[MultiGridState, jax.Array, jax.Array, jax.Array]:
    """Deterministic step core: increments the counter, applies actions.

    Equivalent to ``MultiGridEnv.step`` without observation generation
    (base.py:303-346). Returns ``(state, rewards, terminations, truncations)``
    where terminations are read from agent state after the action loop
    (base.py:338) and truncation is ``step_count >= max_steps`` broadcast to
    all agents (base.py:339-340).
    """
    state = state.replace(step_count=state.step_count + 1)
    state, rewards = handle_actions(cfg, state, actions, order, action_mask)
    terminations = state.agent_terminated
    truncated = state.step_count >= cfg.max_steps
    truncations = jnp.broadcast_to(truncated, (cfg.num_agents,))
    return state, rewards, terminations, truncations


def sample_order(key: jax.Array, num_agents: int) -> jax.Array:
    """Sample the random agent action order for one step.

    The reference draws ``np_random.random(N).argsort()`` (base.py:396-399);
    single-agent environments use ``(0,)`` and consume no randomness.
    """
    if num_agents == 1:
        return jnp.zeros((1,), dtype=jnp.int32)
    return jnp.argsort(jax.random.uniform(key, (num_agents,))).astype(jnp.int32)
