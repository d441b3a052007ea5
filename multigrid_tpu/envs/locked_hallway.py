"""Locked hallway environment (reference: multigrid/envs/locked_hallway.py:13).

A central hallway with locked, color-coded rooms on either side. Keys are
chained: some start in the hallway, the rest inside rooms that earlier keys
unlock. Agents are rewarded per door unlocked; the episode terminates when
every door has been unlocked.
"""

from __future__ import annotations

from math import ceil

import jax
import jax.numpy as jnp
import numpy as np

from ..core.actions import Action
from ..core.constants import (
    DIR_TO_VEC,
    Direction,
    NUM_BASE_COLORS,
    STATE_LOCKED,
    TYPE_DOOR,
    TYPE_KEY,
)
from ..core.state import MultiGridState
from ..ops.place import place_obj_mask, set_cell, uniform_position
from . import layout
from .roomgrid import RoomGrid, place_agents_device

_LEFT, _HALLWAY, _RIGHT = range(3)  # room columns


class LockedHallwayEnv(RoomGrid):
    """Unlock all the doors (envs/locked_hallway.py:64-227).

    Registered: ``MultiGrid-LockedHallway-{2,4,6}Rooms-v0``.
    """

    mission = "unlock all the doors"
    #: No Box ever appears in these layouts — zero-sized box_contents
    #: table (core/state.py init_state).
    uses_boxes = False

    def __init__(
        self,
        num_rooms: int = 6,
        room_size: int = 5,
        max_hallway_keys: int = 1,
        max_keys_per_room: int = 2,
        max_steps: int | None = None,
        joint_reward: bool = True,
        **kwargs,
    ):
        assert room_size >= 4
        assert num_rooms % 2 == 0
        self.num_rooms = num_rooms
        self.max_hallway_keys = max_hallway_keys
        self.max_keys_per_room = max_keys_per_room
        super().__init__(
            room_size=room_size,
            num_rows=(num_rooms // 2),
            num_cols=3,
            max_steps=max_steps or (8 * num_rooms * room_size**2),
            joint_reward=joint_reward,
            **kwargs,
        )
        geom = self.geometry
        # Hallway = middle column with the inner walls removed
        # (locked_hallway.py:162-164).
        for row in range(geom.num_rows - 1):
            geom.remove_wall(self._base_grid, _HALLWAY, row, Direction.down)
        self._hallway_top = geom.room_top(_HALLWAY, 0)
        self._hallway_size = (geom.room_size, geom.height)
        # Door positions are fixed (rand_pos=False, locked_hallway.py:167-174):
        # room r = row*2 + side, side 0 = LEFT (door on its right wall),
        # side 1 = RIGHT (door on its left wall).
        self._door_pos = np.array(
            [
                geom.fixed_door_pos(
                    _LEFT if r % 2 == 0 else _RIGHT,
                    r // 2,
                    Direction.right if r % 2 == 0 else Direction.left,
                )
                for r in range(num_rooms)
            ],
            dtype=np.int32,
        )
        # Top-left corner of the room behind door r.
        self._room_tops = np.array(
            [
                geom.room_top(_LEFT if r % 2 == 0 else _RIGHT, r // 2)
                for r in range(num_rooms)
            ],
            dtype=np.int32,
        )

    def _gen_grid(self, key: jax.Array) -> MultiGridState:
        """On-device layout (locked_hallway.py:149-194): shuffled color
        sequence, one locked door per room, chained key placement, agents in
        the hallway."""
        cfg = self.cfg
        nr = self.num_rooms
        k_seq, k_doors, k_nhall, k_group, k_place, k_agents = (
            jax.random.split(key, 6))

        # color_sequence: shuffled cycle of colors, truncated to num_rooms
        # (locked_hallway.py:159-160).
        reps = ceil(nr / NUM_BASE_COLORS)
        pool = jnp.tile(jnp.arange(NUM_BASE_COLORS, dtype=jnp.int32), reps)
        color_sequence = jax.random.permutation(k_seq, pool)[:nr]

        # Door colors: an independent shuffle of the sequence, assigned to
        # rooms in creation order by popping from the end
        # (locked_hallway.py:166-174).
        door_colors_pool = jax.random.permutation(k_doors, color_sequence)
        door_color = door_colors_pool[::-1]  # room r gets pop() number r

        # Door positions are a static numpy table: expand the traced door
        # colors onto their cells through a constant (nr, W, H) indicator and
        # merge with one fused select — no scatters (even static-index
        # .at[x, y].set lowers to one under vmap; tests/test_hlo_guard.py).
        W, H = self.cfg.width, self.cfg.height
        door_cells = np.zeros((nr, W, H), dtype=bool)
        for r in range(nr):
            door_cells[r, self._door_pos[r, 0], self._door_pos[r, 1]] = True
        cell_color = jnp.sum(
            jnp.asarray(door_cells, jnp.int32) * door_color[:, None, None],
            axis=0,
        )
        door_cell = jnp.stack([
            jnp.full((W, H), TYPE_DOOR, jnp.int32),
            cell_color,
            jnp.full((W, H), STATE_LOCKED, jnp.int32),
        ], axis=-1)
        is_door = jnp.asarray(door_cells.any(axis=0))
        grid = jnp.where(
            is_door[..., None], door_cell, jnp.asarray(self._base_grid))

        state = self._init_room_state(key, base_grid=grid)

        # Map each color to the room it opens; later rooms win on duplicate
        # colors, matching the reference's dict overwrite
        # (locked_hallway.py:170-171). One-hot writes — door_color[r] is a
        # traced per-env value, and this runs on the per-step auto-reset path.
        color_iota = jnp.arange(NUM_BASE_COLORS, dtype=jnp.int32)
        room_of_color = jnp.zeros((NUM_BASE_COLORS,), dtype=jnp.int32)
        for r in range(nr):
            room_of_color = jnp.where(
                color_iota == door_color[r], r, room_of_color)

        # Chained key placement (locked_hallway.py:176-190): the first
        # num_hallway_keys keys go in the hallway; the rest are grouped, each
        # group living in the room opened by the key before the group.
        num_hallway_keys = jax.random.randint(
            k_nhall, (), 1, self.max_hallway_keys + 1, dtype=jnp.int32)
        group_keys = jax.random.split(k_group, nr)
        place_keys = jax.random.split(k_place, nr)
        room_tops = jnp.asarray(self._room_tops)
        hall_top = jnp.asarray(self._hallway_top, dtype=jnp.int32)
        hall_size = jnp.asarray(self._hallway_size, dtype=jnp.int32)
        room_shape = jnp.asarray(self.geometry.room_shape, dtype=jnp.int32)

        group_room = jnp.int32(0)
        remaining = jnp.int32(0)
        for k in range(nr):
            in_hallway = k < num_hallway_keys
            start_group = ~in_hallway & (remaining == 0)
            size_draw = jax.random.randint(
                group_keys[k], (), 1, self.max_keys_per_room + 1,
                dtype=jnp.int32)
            prev_color = color_sequence[max(k - 1, 0)]
            prev_room = jnp.sum(
                jnp.where(color_iota == prev_color, room_of_color, 0))
            group_room = jnp.where(start_group, prev_room, group_room)
            remaining = jnp.where(start_group, size_draw, remaining)

            group_top = jnp.sum(
                jnp.where(
                    jnp.arange(nr, dtype=jnp.int32)[:, None] == group_room,
                    room_tops, 0),
                axis=0)
            top = jnp.where(in_hallway, hall_top, group_top)
            size = jnp.where(in_hallway, hall_size, room_shape)
            valid = place_obj_mask(state.grid, state.agent_pos, top, size)
            pos = uniform_position(place_keys[k], valid)
            state = state.replace(grid=set_cell(
                state.grid, pos,
                jnp.stack([jnp.int32(TYPE_KEY), color_sequence[k],
                           jnp.int32(0)])))
            remaining = jnp.where(in_hallway, remaining, remaining - 1)

        # Agents in the hallway (plain placement, no front-cell retry —
        # locked_hallway.py:192-194 calls MultiGridEnv.place_agent directly).
        state = place_agents_device(
            state, k_agents, top=self._hallway_top, size=self._hallway_size)

        return state.replace(extras={
            'door_unlocked': jnp.zeros((nr,), dtype=jnp.bool_),
        })

    def post_step(self, prev_state, state, actions, rewards, terminations,
                  action_mask):
        """Per-door unlock rewards + all-doors termination
        (locked_hallway.py:203-227). A toggling agent facing a door that is
        no longer locked and not yet counted earns the reward (for everyone,
        if joint); the returned terminations flip when every door is
        unlocked, without touching agent state (the reference only updates
        the returned dict)."""
        cfg = self.cfg
        unlocked = state.extras['door_unlocked']
        door_pos = jnp.asarray(self._door_pos)
        dir_vec = jnp.asarray(DIR_TO_VEC, dtype=jnp.int32)
        reward_value = (
            1.0 - 0.9 * state.step_count.astype(jnp.float32) / cfg.max_steps
        )

        # Door positions are static layout constants, so the door cells'
        # encodings come from static (constant-index) slicing; the per-agent
        # forward cell is matched against them with masks — no per-env
        # gathers/scatters (see the note in ops/step.py).
        # Static per-door indexing (plain slices), not fancy-index gathers.
        door_encs = jnp.stack([
            state.grid[int(x), int(y)] for x, y in self._door_pos
        ])
        dir4 = jnp.arange(4, dtype=jnp.int32)
        for i in range(cfg.num_agents):
            doh = (dir4 == state.agent_dir[i])[:, None]
            fwd = state.agent_pos[i] + jnp.sum(
                jnp.where(doh, dir_vec, 0), axis=0)
            matches = jnp.all(fwd[None, :] == door_pos, axis=-1)  # (D,)
            # Doors are at distinct cells: at most one row matches.
            fwd_enc = jnp.sum(
                jnp.where(matches[:, None], door_encs, 0), axis=0)
            door_not_locked = (
                (fwd_enc[0] == TYPE_DOOR) & (fwd_enc[2] != STATE_LOCKED))
            not_yet = jnp.any(matches & ~unlocked)
            fire = (
                action_mask[i]
                & (actions[i] == int(Action.toggle))
                & door_not_locked
                & jnp.any(matches)
                & not_yet
            )
            add = jnp.where(fire, reward_value, 0.0)
            if cfg.joint_reward:
                rewards = rewards + add
            else:
                rewards = rewards + jnp.where(
                    jnp.arange(cfg.num_agents) == i, add, 0.0)
            unlocked = unlocked | (matches & fire)

        all_unlocked = jnp.all(unlocked)
        terminations = jnp.where(
            all_unlocked, jnp.ones_like(terminations), terminations)
        state = state.replace(
            extras={**state.extras, 'door_unlocked': unlocked})
        return state, rewards, terminations

    def success(self, state: MultiGridState) -> jax.Array:
        """Task complete ⇔ every room door has been unlocked — the exact
        all-doors termination condition (locked_hallway.py:225-227). The
        base any-agent-terminated default never fires here: post_step flips
        the *returned* terminations without touching agent state, and the
        positive-return proxy over-counted (a single unlocked door already
        banks reward)."""
        return jnp.all(state.extras['door_unlocked'])

    # ------------------------------------------------------------ parity mode

    def _gen_grid_parity(self, G: np.random.Generator) -> dict:
        """Host-side layout consuming draws in reference order
        (locked_hallway.py:149-194)."""
        from .parity import parity_place_agent, parity_place_obj

        nr = self.num_rooms
        data = self._parity_init()
        grid, agent_pos, agent_dir = (
            data['grid'], data['agent_pos'], data['agent_dir'])

        # Shuffled color cycle (G.shuffle on a Python list, like _rand_perm).
        pool = list(range(NUM_BASE_COLORS)) * ceil(nr / NUM_BASE_COLORS)
        G.shuffle(pool)
        color_sequence = pool[:nr]

        door_colors = list(color_sequence)
        G.shuffle(door_colors)
        room_of_color: dict[int, int] = {}
        for r in range(nr):
            color = door_colors.pop()
            room_of_color[color] = r
            grid[self._door_pos[r, 0], self._door_pos[r, 1]] = layout.door(
                color, STATE_LOCKED)

        num_hallway_keys = int(G.integers(1, self.max_hallway_keys + 1))
        for key_color in color_sequence[:num_hallway_keys]:
            parity_place_obj(
                G, grid, agent_pos, layout.key(key_color),
                self._hallway_top, self._hallway_size)

        key_index = num_hallway_keys
        while key_index < nr:
            room = room_of_color[color_sequence[key_index - 1]]
            num_room_keys = int(G.integers(1, self.max_keys_per_room + 1))
            for key_color in color_sequence[key_index:key_index + num_room_keys]:
                parity_place_obj(
                    G, grid, agent_pos, layout.key(key_color),
                    tuple(self._room_tops[room]), self.geometry.room_shape)
                key_index += 1

        for a in range(self.cfg.num_agents):
            _, agent_dir[a] = parity_place_agent(
                G, grid, agent_pos, a, self._hallway_top, self._hallway_size)

        return dict(
            grid=grid, agent_pos=agent_pos, agent_dir=agent_dir,
            extras={'door_unlocked': np.zeros((nr,), dtype=bool)},
        )
