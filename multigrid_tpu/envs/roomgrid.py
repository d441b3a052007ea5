"""Rooms-in-a-grid procedural base environment.

Array-native counterpart of the reference ``RoomGrid`` (multigrid/core/roomgrid.py:139):
the static room lattice is precomputed host-side; the random parts of a
layout (door positions/colors, object placement, agent placement with the
front-cell retry) run on device as fixed-cost predicated draws, or host-side
in parity mode consuming numpy draws in the reference's exact order.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.constants import (
    DIR_TO_VEC,
    STATE_CLOSED,
    STATE_LOCKED,
    TYPE_EMPTY,
    TYPE_WALL,
    Direction,
)
from ..core.state import MultiGridState, init_state
from ..ops.place import (
    agent_occupancy,
    place_obj_mask,
    set_cell,
    uniform_position,
)
from . import layout
from .env import MultiGridEnv


def opposite(direction: int) -> int:
    return (direction + 2) % 4


class RoomGeometry:
    """Static geometry of the room lattice (host-side)."""

    def __init__(self, room_size: int, num_rows: int, num_cols: int):
        assert room_size >= 3 and num_rows > 0 and num_cols > 0
        self.room_size = room_size
        self.num_rows = num_rows
        self.num_cols = num_cols
        self.width = (room_size - 1) * num_cols + 1
        self.height = (room_size - 1) * num_rows + 1

    def room_top(self, col: int, row: int) -> tuple[int, int]:
        rs = self.room_size
        return (col * (rs - 1), row * (rs - 1))

    @property
    def room_shape(self) -> tuple[int, int]:
        return (self.room_size, self.room_size)

    def middle_pos(self) -> tuple[int, int]:
        """Initial agent position: center of the middle room, facing right
        (core/roomgrid.py:231-236)."""
        rs = self.room_size
        return (
            (self.num_cols // 2) * (rs - 1) + (rs // 2),
            (self.num_rows // 2) * (rs - 1) + (rs // 2),
        )

    def base_grid(self) -> np.ndarray:
        """Wall lattice for all rooms (core/roomgrid.py:209-216)."""
        grid = layout.empty_grid(self.width, self.height)
        for row in range(self.num_rows):
            for col in range(self.num_cols):
                tx, ty = self.room_top(col, row)
                layout.wall_rect(grid, tx, ty, self.room_size, self.room_size)
        return grid

    def remove_wall(self, grid: np.ndarray, col: int, row: int, direction: int):
        """Remove the interior wall between two rooms (core/roomgrid.py:333-367)."""
        tx, ty = self.room_top(col, row)
        w = h = self.room_size
        if direction == Direction.right:
            grid[tx + w - 1, ty + 1:ty + h - 1] = layout.EMPTY
        elif direction == Direction.down:
            grid[tx + 1:tx + w - 1, ty + h - 1] = layout.EMPTY
        elif direction == Direction.left:
            grid[tx, ty + 1:ty + h - 1] = layout.EMPTY
        elif direction == Direction.up:
            grid[tx + 1:tx + w - 1, ty] = layout.EMPTY
        else:
            raise ValueError(direction)

    def fixed_door_pos(self, col: int, row: int, direction: int) -> tuple[int, int]:
        """Midpoint door position on a room wall (core/roomgrid.py:104-126,
        random=None branch)."""
        left, top = self.room_top(col, row)
        right = left + self.room_size - 1
        bottom = top + self.room_size - 1
        if direction == Direction.right:
            return (right, (top + bottom) // 2)
        if direction == Direction.down:
            return ((left + right) // 2, bottom)
        if direction == Direction.left:
            return (left, (top + bottom) // 2)
        if direction == Direction.up:
            return ((left + right) // 2, top)
        raise ValueError(direction)

    def door_wall_span(self, col: int, row: int, direction: int):
        """(fixed coordinate, low, high) for a random door position draw:
        the varying coordinate is sampled from [low, high)
        (core/roomgrid.py:104-126, random branch)."""
        left, top = self.room_top(col, row)
        right = left + self.room_size - 1
        bottom = top + self.room_size - 1
        if direction == Direction.right:
            return ('x', right, top + 1, bottom)
        if direction == Direction.down:
            return ('y', bottom, left + 1, right)
        if direction == Direction.left:
            return ('x', left, top + 1, bottom)
        if direction == Direction.up:
            return ('y', top, left + 1, right)
        raise ValueError(direction)

    def has_neighbor(self, col: int, row: int, direction: int) -> bool:
        if direction == Direction.right:
            return col < self.num_cols - 1
        if direction == Direction.down:
            return row < self.num_rows - 1
        if direction == Direction.left:
            return col > 0
        if direction == Direction.up:
            return row > 0
        raise ValueError(direction)

    def neighbor(self, col: int, row: int, direction: int) -> tuple[int, int]:
        dx, dy = DIR_TO_VEC[direction]
        return (col + int(dx), row + int(dy))


### Device-side placement helpers ------------------------------------------


def next_to_agent_mask(agent_pos: jax.Array, width: int, height: int) -> jax.Array:
    """(W, H) bool — cells within L2 distance 1 of any agent (the
    ``reject_next_to`` filter, core/roomgrid.py:45-50): the agent cells plus
    their orthogonal neighbors."""
    occ = agent_occupancy(agent_pos, width, height)
    pad = jnp.pad(occ, 1)
    return (
        occ
        | pad[:-2, 1:-1]
        | pad[2:, 1:-1]
        | pad[1:-1, :-2]
        | pad[1:-1, 2:]
    )


def front_ok_mask(grid: jax.Array) -> jax.Array:
    """(W, H, 4) bool — whether the cell in front of (x, y) facing d is empty
    or a wall (the roomgrid agent-placement retry predicate,
    core/roomgrid.py:398-402). Out-of-grid counts as wall (accept)."""
    t = grid[..., 0]
    wall = jnp.full_like(t[:1, :], TYPE_WALL)
    wall_col = jnp.full_like(t[:, :1], TYPE_WALL)
    fronts = jnp.stack(
        [
            jnp.concatenate([t[1:, :], wall], axis=0),       # right: (x+1, y)
            jnp.concatenate([t[:, 1:], wall_col], axis=1),   # down:  (x, y+1)
            jnp.concatenate([wall, t[:-1, :]], axis=0),      # left:  (x-1, y)
            jnp.concatenate([wall_col, t[:, :-1]], axis=1),  # up:    (x, y-1)
        ],
        axis=-1,
    )
    return (fronts == TYPE_EMPTY) | (fronts == TYPE_WALL)


def uniform_pos_dir(key: jax.Array, valid: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Sample (position, direction) uniformly over a (W, H, 4) validity mask.

    Distributionally equivalent to the reference's redraw-until-front-cell-ok
    loop (core/roomgrid.py:396-402): rejection over uniform (pos, dir) pairs
    conditioned on acceptance is uniform over the accepted set.
    """
    w, h, _ = valid.shape
    g = jax.random.bits(key, (w, h, 4), dtype=jnp.uint32)
    # Top bit set on valid cells: a valid cell always beats invalid
    # ones even in the astronomically unlikely all-zero-bits draw.
    g = jnp.where(valid, (g >> 1) | jnp.uint32(1 << 31), jnp.uint32(0))
    flat = jnp.argmax(g.reshape(-1))
    pos = jnp.stack([flat // (h * 4), (flat // 4) % h]).astype(jnp.int32)
    return pos, (flat % 4).astype(jnp.int32)


def place_agents_device(
    state: MultiGridState,
    key: jax.Array,
    top=None,
    size=None,
    check_front: bool = False,
) -> MultiGridState:
    """Place all agents sequentially, uniform over valid cells with a random
    direction (base.py:680-697; with ``check_front``, the roomgrid variant
    core/roomgrid.py:373-404)."""
    n = state.num_agents
    keys = jax.random.split(key, n)
    # Per-agent writes are one-hot selects over the (tiny) agent axis — even
    # static-index .at[a].set lowers to a scatter under vmap, and this runs
    # on the per-step auto-reset path (tests/test_hlo_guard.py pins zero).
    sel = jnp.arange(n, dtype=jnp.int32)
    for a in range(n):
        # Clear this agent's own stale position first (the reference's
        # place_agent sets pos=(-1,-1) before sampling, base.py:687-691;
        # otherwise the agent could never be re-placed on its own cell).
        state = state.replace(
            agent_pos=jnp.where(
                (sel == a)[:, None], jnp.int32(-1), state.agent_pos))
        valid_pos = place_obj_mask(state.grid, state.agent_pos, top, size)
        if check_front:
            valid = valid_pos[:, :, None] & front_ok_mask(state.grid)
            pos, dirn = uniform_pos_dir(keys[a], valid)
        else:
            k1, k2 = jax.random.split(keys[a])
            pos = uniform_position(k1, valid_pos)
            dirn = jax.random.randint(k2, (), 0, 4, dtype=jnp.int32)
        state = state.replace(
            agent_pos=jnp.where(
                (sel == a)[:, None], pos[None, :], state.agent_pos),
            agent_dir=jnp.where(sel == a, dirn, state.agent_dir),
        )
    return state


def place_object_device(
    state: MultiGridState,
    key: jax.Array,
    obj_enc: jax.Array,
    top=None,
    size=None,
    reject_next_to: bool = False,
) -> tuple[MultiGridState, jax.Array]:
    """Place an object uniformly over valid cells; returns (state, pos)."""
    cfg_w, cfg_h, _ = state.grid.shape
    valid = place_obj_mask(state.grid, state.agent_pos, top, size)
    if reject_next_to:
        valid = valid & ~next_to_agent_mask(state.agent_pos, cfg_w, cfg_h)
    pos = uniform_position(key, valid)
    grid = set_cell(state.grid, pos, obj_enc)
    return state.replace(grid=grid), pos


class RoomGrid(MultiGridEnv):
    """Base class for environments built on a room lattice."""

    procedural_reset = True  # amortize auto-reset layouts (parallel/vector.py)

    def __init__(
        self,
        room_size: int = 7,
        num_rows: int = 3,
        num_cols: int = 3,
        **kwargs,
    ):
        self.geometry = RoomGeometry(room_size, num_rows, num_cols)
        super().__init__(
            width=self.geometry.width, height=self.geometry.height, **kwargs
        )
        self._base_grid = self.geometry.base_grid()

    @property
    def room_size(self) -> int:
        return self.geometry.room_size

    @property
    def num_rows(self) -> int:
        return self.geometry.num_rows

    @property
    def num_cols(self) -> int:
        return self.geometry.num_cols

    def _init_room_state(self, key: jax.Array, base_grid=None) -> MultiGridState:
        """Fresh state with the wall lattice and all agents at the middle
        room's center facing right (core/roomgrid.py:203-236)."""
        cfg = self.cfg
        state = init_state(cfg.width, cfg.height, cfg.num_agents, rng=key,
                           has_boxes=self.uses_boxes)
        grid = jnp.asarray(self._base_grid if base_grid is None else base_grid)
        mid = jnp.asarray(self.geometry.middle_pos(), dtype=jnp.int32)
        return state.replace(
            grid=grid,
            agent_pos=jnp.broadcast_to(mid, (cfg.num_agents, 2)),
            agent_dir=jnp.zeros((cfg.num_agents,), dtype=jnp.int32),
        )

    # ------------------------------------------------- device-side builders
    # Public layout-building API for custom environments, mirroring the
    # reference RoomGrid methods (core/roomgrid.py:238-495) as pure functions
    # of (state, key).

    def place_in_room(
        self, state: MultiGridState, key: jax.Array, obj_enc,
        col: int, row: int,
    ) -> tuple[MultiGridState, jax.Array]:
        """Place an object at a random empty position in a room, rejecting
        cells adjacent to agents (core/roomgrid.py:238-256)."""
        return place_object_device(
            state, key, obj_enc,
            top=self.geometry.room_top(col, row),
            size=self.geometry.room_shape,
            reject_next_to=True,
        )

    def add_object(
        self, state: MultiGridState, key: jax.Array,
        col: int, row: int, kind: int, color: jax.Array | int,
    ) -> tuple[MultiGridState, jax.Array]:
        """Add an object of a given type/color to a room
        (core/roomgrid.py:258-281)."""
        enc = jnp.stack([
            jnp.asarray(kind, jnp.int32),
            jnp.asarray(color, jnp.int32),
            jnp.zeros((), jnp.int32),
        ])
        return self.place_in_room(state, key, enc, col, row)

    def add_door(
        self, state: MultiGridState, key: jax.Array,
        col: int, row: int, direction: int,
        color: jax.Array | int, locked: bool = False,
        rand_pos: bool = True,
    ) -> tuple[MultiGridState, jax.Array]:
        """Add a door on a room wall (core/roomgrid.py:283-331): random or
        midpoint position along the wall span, returning (state, door_pos)."""
        from ..core.constants import TYPE_DOOR
        geom = self.geometry
        if rand_pos:
            axis, fixed, lo, hi = geom.door_wall_span(col, row, direction)
            coord = jax.random.randint(key, (), lo, hi, dtype=jnp.int32)
            pos = jnp.stack(
                [jnp.int32(fixed), coord] if axis == 'x'
                else [coord, jnp.int32(fixed)])
        else:
            pos = jnp.asarray(
                geom.fixed_door_pos(col, row, direction), jnp.int32)
        enc = jnp.stack([
            jnp.int32(TYPE_DOOR),
            jnp.asarray(color, jnp.int32),
            jnp.int32(STATE_LOCKED if locked else STATE_CLOSED),
        ])
        cx = jnp.arange(self.cfg.width, dtype=jnp.int32)[:, None]
        cy = jnp.arange(self.cfg.height, dtype=jnp.int32)[None, :]
        mask = ((cx == pos[0]) & (cy == pos[1]))[..., None]
        return state.replace(
            grid=jnp.where(mask, enc[None, None, :], state.grid)), pos

    def place_agents_in_room(
        self, state: MultiGridState, key: jax.Array, col: int, row: int,
    ) -> MultiGridState:
        """Place all agents in a room with the front-cell retry
        (core/roomgrid.py:373-404)."""
        return place_agents_device(
            state, key,
            top=self.geometry.room_top(col, row),
            size=self.geometry.room_shape,
            check_front=True,
        )

    def add_distractors(
        self, state: MultiGridState, key: jax.Array, num_distractors: int = 10,
    ) -> MultiGridState:
        """Scatter random objects (ball/key/box of random colors) into random
        rooms (core/roomgrid.py:454-495 — which crashes in the reference due
        to a latent ``set.append`` bug; implemented correctly here)."""
        from ..core.constants import NUM_BASE_COLORS, TYPE_BALL, TYPE_BOX, TYPE_KEY
        kinds = jnp.asarray(
            [TYPE_BALL, TYPE_KEY, TYPE_BOX], dtype=jnp.int32)
        keys = jax.random.split(key, 4 * num_distractors)
        geom = self.geometry
        for d in range(num_distractors):
            kind = kinds[jax.random.randint(keys[4 * d], (), 0, 3)]
            color = jax.random.randint(
                keys[4 * d + 1], (), 0, NUM_BASE_COLORS, dtype=jnp.int32)
            # Random room drawn on device; rectangle mask built from the draw.
            room = jax.random.randint(
                keys[4 * d + 2], (2,), 0,
                jnp.asarray([geom.num_cols, geom.num_rows]), dtype=jnp.int32)
            rs = geom.room_size
            top = room * (rs - 1)
            enc = jnp.stack([kind, color, jnp.zeros((), jnp.int32)])
            state, _ = place_object_device(
                state, keys[4 * d + 3], enc,
                top=(top[0], top[1]), size=(rs, rs), reject_next_to=True)
        return state

    # ----------------------------------------------------------- parity side

    def _parity_init(self) -> dict:
        """Host-side fresh layout dict with agents at the middle."""
        cfg = self.cfg
        mid = self.geometry.middle_pos()
        return dict(
            grid=self._base_grid.copy(),
            agent_pos=np.tile(np.asarray(mid, np.int32), (cfg.num_agents, 1)),
            agent_dir=np.zeros((cfg.num_agents,), dtype=np.int32),
        )

    def _parity_place_in_room(
        self, G, grid, agent_pos, obj_enc, col: int, row: int
    ) -> np.ndarray:
        """place_in_room: rejection with the next-to-agent filter
        (core/roomgrid.py:238-256)."""
        from .parity import parity_place_obj

        top = self.geometry.room_top(col, row)

        def reject_next_to(pos):
            d = np.linalg.norm(np.asarray(pos) - agent_pos, axis=-1)
            return bool((d <= 1).any())

        return parity_place_obj(
            G, grid, agent_pos, obj_enc, top, self.geometry.room_shape,
            reject_fn=reject_next_to, max_tries=1000,
        )

    def _parity_place_agent_in_room(
        self, G, grid, agent_pos, agent_dir, agent_idx: int,
        col: int | None = None, row: int | None = None,
    ) -> None:
        """Roomgrid agent placement with the front-cell retry
        (core/roomgrid.py:373-404), drawing from G in reference order."""
        from .parity import parity_place_agent

        col = col if col is not None else int(G.integers(0, self.num_cols))
        row = row if row is not None else int(G.integers(0, self.num_rows))
        top = self.geometry.room_top(col, row)
        size = self.geometry.room_shape
        dvec = np.asarray(DIR_TO_VEC)
        while True:
            pos, dirn = parity_place_agent(
                G, grid, agent_pos, agent_idx, top, size, max_tries=1000)
            fx, fy = np.asarray(pos) + dvec[dirn]
            if grid[fx, fy, 0] in (TYPE_EMPTY, TYPE_WALL):
                break
        agent_dir[agent_idx] = dirn
