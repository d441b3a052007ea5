"""Dense environment state — the array-native replacement for the reference's
object graph.

The reference keeps a dual representation: a dense ``(W, H, 3)`` int array in
sync with a lazy dict of ``WorldObj`` Python objects (multigrid/core/grid.py:53-55),
and a vectorized ``(N, 9)`` AgentState row array with Python-object sidecars
(multigrid/core/agent.py:170-254). This framework keeps only the dense half:

* ``grid``          — ``(W, H, 3)`` int32, each cell a (type, color, state) triple.
* ``box_contents``  — ``(W, H, 3)`` int32 side table for Box containment
                      (the reference nests WorldObj instances,
                      multigrid/core/world_object.py:574-585; one nesting level
                      is supported, which covers every shipped environment).
* agent fields      — split typed arrays instead of the packed 9-int row
                      (reference layout at multigrid/core/agent.py:222-232).

Everything is a pytree (``utils.struct``), so a batched environment is just
``vmap`` over a leading env axis and a checkpoint is one array per leaf.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import struct
from .constants import (
    COLOR_RED,
    EMPTY_ENCODING,
    TYPE_AGENT,
    TYPE_EMPTY,
)


@struct.dataclass
class MultiGridState:
    """Complete state of a single MultiGrid environment instance.

    A batch of ``E`` environments is represented by the same pytree with a
    leading ``(E, ...)`` axis on every array (constructed via ``jax.vmap``).
    """

    #: (W, H, 3) int32 — grid cell encodings (type, color, state).
    grid: jax.Array
    #: (W, H, 3) int32 — encoding of the object contained by a Box at (x, y).
    box_contents: jax.Array
    #: (N, 2) int32 — agent (x, y) positions.
    agent_pos: jax.Array
    #: (N,) int32 — agent directions (0: right, 1: down, 2: left, 3: up).
    agent_dir: jax.Array
    #: (N,) int32 — agent colors (Color indices).
    agent_color: jax.Array
    #: (N,) bool — whether each agent has terminated.
    agent_terminated: jax.Array
    #: (N, 3) int32 — encoding of the object each agent carries (empty = none).
    agent_carrying: jax.Array
    #: (N, 3) int32 — contents encoding if the carried object is a Box.
    agent_carrying_contents: jax.Array
    #: () int32 — steps since episode start.
    step_count: jax.Array
    #: PRNG key consumed by stochastic dynamics (agent-order shuffle).
    rng: jax.Array
    #: Env-specific extra state (door flags, target encodings, mission index).
    extras: dict[str, Any] = struct.field(default_factory=dict)

    @property
    def num_agents(self) -> int:
        return self.agent_dir.shape[-1]

    @property
    def agent_encoding(self) -> jax.Array:
        """(N, 3) agent grid encodings: (Type.agent, color, dir).

        Mirrors AgentState's ENCODING slice (multigrid/core/agent.py:226).
        """
        n = self.agent_dir.shape[-1]
        return jnp.stack(
            [jnp.full((n,), TYPE_AGENT, dtype=jnp.int32),
             self.agent_color.astype(jnp.int32),
             self.agent_dir.astype(jnp.int32)],
            axis=-1,
        )


def init_state(
    width: int,
    height: int,
    num_agents: int,
    rng: jax.Array,
    has_boxes: bool = True,
) -> MultiGridState:
    """Create a blank state: empty grid, agents unplaced at (-1, -1), dir -1.

    Matches the reference's fresh ``AgentState`` defaults
    (multigrid/core/agent.py:234-254) and ``Grid`` init (core/grid.py:54-55).

    ``has_boxes=False`` allocates a ZERO-sized ``box_contents`` side table:
    environments whose layouts never contain a Box (Empty, RedBlueDoors,
    LockedHallway — set via ``MultiGridEnv.uses_boxes``) otherwise pay a
    full (W, H, 3) plane of dead HBM traffic in every step's masked writes,
    every auto-reset select and every reserve-pool move (~half the
    dynamics traffic at the flagship batch). The step kernel branches on
    ``box_contents.size`` statically (ops/step.py).
    """
    empty = jnp.asarray(EMPTY_ENCODING, dtype=jnp.int32)
    grid = jnp.broadcast_to(empty, (width, height, 3))
    colors = (jnp.arange(num_agents, dtype=jnp.int32) % 6) + COLOR_RED
    bc_shape = (width, height, 3) if has_boxes else (0, 0, 3)
    return MultiGridState(
        grid=grid,
        box_contents=jnp.broadcast_to(empty, bc_shape),
        agent_pos=jnp.full((num_agents, 2), -1, dtype=jnp.int32),
        agent_dir=jnp.full((num_agents,), -1, dtype=jnp.int32),
        agent_color=colors,
        agent_terminated=jnp.zeros((num_agents,), dtype=jnp.bool_),
        agent_carrying=jnp.broadcast_to(empty, (num_agents, 3)),
        agent_carrying_contents=jnp.broadcast_to(empty, (num_agents, 3)),
        step_count=jnp.zeros((), dtype=jnp.int32),
        rng=rng,
        extras={},
    )


def state_from_numpy(
    grid: np.ndarray,
    agent_pos: np.ndarray,
    agent_dir: np.ndarray,
    rng: jax.Array,
    *,
    box_contents: np.ndarray | None = None,
    agent_color: np.ndarray | None = None,
    extras: dict[str, Any] | None = None,
    has_boxes: bool = True,
) -> MultiGridState:
    """Build a device state from host-side numpy layout arrays.

    Used by the parity-mode reset path, where procedural generation runs on
    the host with numpy RNG streams that bit-match the reference.
    ``has_boxes=False`` (box-free environments) allocates the zero-sized
    ``box_contents`` table — see :func:`init_state`.
    """
    grid = np.asarray(grid, dtype=np.int32)
    w, h, _ = grid.shape
    n = int(np.asarray(agent_dir).shape[0])
    if box_contents is None:
        bc_shape = (w, h, 3) if has_boxes else (0, 0, 3)
        box_contents = np.broadcast_to(EMPTY_ENCODING, bc_shape)
    if agent_color is None:
        agent_color = np.arange(n, dtype=np.int32) % 6
    empty_n = np.broadcast_to(EMPTY_ENCODING, (n, 3))
    return MultiGridState(
        grid=jnp.asarray(grid),
        box_contents=jnp.asarray(box_contents, dtype=jnp.int32),
        agent_pos=jnp.asarray(agent_pos, dtype=jnp.int32),
        agent_dir=jnp.asarray(agent_dir, dtype=jnp.int32),
        agent_color=jnp.asarray(agent_color, dtype=jnp.int32),
        agent_terminated=jnp.zeros((n,), dtype=jnp.bool_),
        agent_carrying=jnp.asarray(empty_n, dtype=jnp.int32),
        agent_carrying_contents=jnp.asarray(empty_n, dtype=jnp.int32),
        step_count=jnp.zeros((), dtype=jnp.int32),
        rng=rng,
        extras=dict(extras or {}),
    )


def is_carrying(state: MultiGridState) -> jax.Array:
    """(N,) bool — whether each agent is carrying an object."""
    return state.agent_carrying[..., 0] != TYPE_EMPTY
