"""Partial-observation generation — the hot kernel.

Array-native replacement for the reference's numba observation kernels
(multigrid/utils/obs.py). The object-graph-free pipeline:

1. overlay live agents' encodings into the grid      (obs.py:162-173)
2. per-agent view-extent computation                  (obs.py:275-316)
3. crop via dynamic-slice on a wall-padded grid,
   out-of-bounds cells read as walls                  (obs.py:199-202)
4. rotate so the agent faces up                       (obs.py:180-196)
5. carried-object overlay at the agent's view cell    (obs.py:204-207)
6. two-pass flood-fill visibility mask                (obs.py:235-273)
7. unseen-masking                                     (obs.py:93-102)

Everything is expressed as predicated vector ops over static shapes: the
flood fill's sequential in-place row sweeps become fixpoint shift-OR chains
(``view_size`` is small and static, so full unrolling is cheap and lets XLA
fuse the whole mask into a handful of elementwise ops). ``vmap`` over agents and
environments gives the batched kernel.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core.config import EnvConfig
from ..core.constants import (
    DIR_DOWN,
    DIR_LEFT,
    DIR_RIGHT,
    STATE_OPEN,
    TYPE_DOOR,
    TYPE_WALL,
    UNSEEN_ENCODING,
    WALL_ENCODING,
)
from ..core.state import MultiGridState


def get_view_exts(
    agent_dir: jax.Array, agent_pos: jax.Array, view_size: int
) -> tuple[jax.Array, jax.Array]:
    """Top-left (x, y) of each agent's view rectangle (obs.py:275-316).

    Works elementwise for any batch shape of ``agent_dir``/``agent_pos[..., 2]``.
    """
    x = agent_pos[..., 0]
    y = agent_pos[..., 1]
    half = view_size // 2
    top_x = jnp.where(
        agent_dir == DIR_RIGHT,
        x,
        jnp.where(
            agent_dir == DIR_DOWN,
            x - half,
            jnp.where(agent_dir == DIR_LEFT, x - view_size + 1, x - half),
        ),
    )
    top_y = jnp.where(
        agent_dir == DIR_RIGHT,
        y - half,
        jnp.where(
            agent_dir == DIR_DOWN,
            y,
            jnp.where(agent_dir == DIR_LEFT, y - half, y - view_size + 1),
        ),
    )
    return top_x, top_y


def see_behind_mask(obs_grid: jax.Array) -> jax.Array:
    """Whether each view cell can be seen through (obs.py:46-63,211-233).

    Opaque cells: walls and non-open doors.
    """
    t = obs_grid[..., 0]
    s = obs_grid[..., 2]
    return ~((t == TYPE_WALL) | ((t == TYPE_DOOR) & (s != STATE_OPEN)))


def _shift_up(v: jax.Array) -> jax.Array:
    """Shift along the i-axis (second-to-last): value at i moves to i+1."""
    return jnp.concatenate([jnp.zeros_like(v[..., :1]), v[..., :-1]], axis=-1)


def _shift_down(v: jax.Array) -> jax.Array:
    """Shift along the i-axis: value at i moves to i-1."""
    return jnp.concatenate([v[..., 1:], jnp.zeros_like(v[..., :1])], axis=-1)


def _propagate(v: jax.Array, s: jax.Array, shift, steps: int) -> jax.Array:
    """Fixpoint of the in-place sweep ``if v[i] & s[i]: v[i ± 1] = True``.

    Each iteration extends the lit region by at least one cell, so ``steps``
    iterations reach the fixpoint for a row of length ``steps + 1``.
    """
    for _ in range(steps):
        v = v | shift(v & s)
    return v


def get_vis_mask(obs_grid: jax.Array) -> jax.Array:
    """Minigrid-style two-pass flood-fill visibility (obs.py:235-273).

    Parameters
    ----------
    obs_grid : (..., vs, vs, 3) int
        Observation grids (agent at ``(vs//2, vs-1)`` facing up).

    Returns
    -------
    vis : (..., vs, vs) bool

    The reference sweeps rows bottom→top; within each row a forward in-place
    pass (i ascending) and a backward in-place pass (i descending) propagate
    visibility sideways and into the next row up (straight and diagonal).
    The in-place semantics make each pass a directional fixpoint, computed
    here as ``vs - 1`` shift-OR steps.

    Columns are carried functionally (a Python list stacked at the end) so
    the kernel lowers to pure elementwise/select ops — zero scatters, even
    constant-index ones (tests/test_hlo_guard.py pins this).
    """
    vs = obs_grid.shape[-2]
    see = see_behind_mask(obs_grid)  # (..., vs_i, vs_j)
    ii = jnp.arange(vs)

    # Iterate columns j from bottom (vs-1) to top (0); operate on i-rows.
    # ``carry`` is the visibility contributed to column j by the pass over
    # column j+1; the bottom column starts from the agent's own cell.
    cols: list[jax.Array] = [None] * vs  # type: ignore[list-item]
    carry = jnp.broadcast_to(ii == vs // 2, see[..., :, vs - 1].shape)
    for j in range(vs - 1, -1, -1):
        s = see[..., :, j]
        f = _propagate(carry, s, _shift_up, vs - 1)     # forward pass fixpoint
        b = _propagate(f, s, _shift_down, vs - 1)       # backward pass fixpoint
        cols[j] = b
        if j > 0:
            # Forward pass: checks i in [0, vs-2]; lights (i, j-1), (i+1, j-1).
            cf = f & s & (ii != vs - 1)
            # Backward pass: checks i in [1, vs-1]; lights (i-1, j-1), (i, j-1).
            cb = b & s & (ii != 0)
            carry = cf | _shift_up(cf) | cb | _shift_down(cb)

    return jnp.stack(cols, axis=-1)


def _overlay_agents(state: MultiGridState) -> jax.Array:
    """Write live agents' encodings into a copy of the grid (obs.py:162-173).

    The reference overlays agents in index order 0..N-1 (later indices win on
    overlapping positions), skipping terminated agents; the loop is unrolled
    here to preserve that overwrite order exactly. Writes are one-hot masked
    selects, not scatters (per-env positions are traced under vmap).
    """
    grid = state.grid
    enc = state.agent_encoding
    w, h, _ = grid.shape
    cx = jnp.arange(w, dtype=jnp.int32)[:, None]
    cy = jnp.arange(h, dtype=jnp.int32)[None, :]
    for a in range(state.num_agents):
        m = (
            (cx == state.agent_pos[a, 0])
            & (cy == state.agent_pos[a, 1])
            & ~state.agent_terminated[a]
        )
        grid = jnp.where(m[..., None], enc[a][None, None, :], grid)
    return grid


def _shift_crop(
    v: jax.Array, shift: jax.Array, size: int, axis: int, *, stride: int = 1
) -> jax.Array:
    """``v[stride·shift : stride·(shift + size)]`` along ``axis`` with a
    *traced* per-batch start, computed without a gather.

    The shift decomposes into its binary digits: ``ceil(log2(dim/stride))``
    predicated static rolls (``where(bit_k, roll(v, -stride·2^k), v)``) —
    pure data movement + elementwise select, which vectorizes perfectly over
    the env batch, unlike per-env dynamic slices which lower to gathers.
    ``shift`` may have leading
    batch dims that broadcast against ``v``'s leading dims.
    """
    dim = v.shape[axis] // stride
    nbits = max(1, (dim - 1).bit_length())
    axis = axis % v.ndim
    # High bit first: once bit k is applied the remaining shift is < 2^k, so
    # only the first (2^k - 1 + size) entries can still be needed — each pass
    # slices the working array down, roughly halving total bytes moved
    # compared to a fixed-size chain.
    for k in reversed(range(nbits)):
        rolled = jnp.roll(v, -stride * (1 << k), axis=axis)
        bit = ((shift >> k) & 1).astype(jnp.bool_)
        bit = bit.reshape(bit.shape + (1,) * (v.ndim - bit.ndim))
        v = jnp.where(bit, rolled, v)
        keep = min(v.shape[axis] // stride, (1 << k) - 1 + size)
        v = jax.lax.slice_in_dim(v, 0, stride * keep, axis=axis)
    return jax.lax.slice_in_dim(v, 0, stride * size, axis=axis)


def gen_obs_grid(
    state: MultiGridState, view_size: int
) -> jax.Array:
    """Per-agent observation sub-grids WITHOUT the visibility mask.

    Equivalent of ``gen_obs_grid`` (obs.py:130-209): overlay, crop with
    out-of-bounds→wall, rotate to face up, carried-object overlay.

    Lowering: the crop at per-agent traced offsets is two chains of
    predicated rolls (binary-decomposed shift, :func:`_shift_crop`) — no
    gathers, no scatters, no tiny-matrix matmuls; everything on the hot path
    is elementwise/static data movement. The padded grid is cast to int8
    (cell values ≤ 10) with the channel dim folded into the minor axis, so
    the roll chain moves 4× fewer bytes.

    Returns ``(N, vs, vs, 3)`` int32.
    """
    vs = view_size
    n = state.num_agents
    w, h, _ = state.grid.shape
    wp, hp = w + 2 * vs, h + 2 * vs

    # 1. Agent overlay (single-agent envs skip it, obs.py:172-173 — the
    #    result is identical since the agent's own cell is overwritten below).
    grid = _overlay_agents(state) if n > 1 else state.grid

    # 2. Wall-pad the grid so out-of-bounds view cells read as walls
    #    (obs.py:199-202). jnp.pad + border select (a constant-offset
    #    dynamic_update_slice re-lowers to a scatter under vmap). int8
    #    packed: (wp, hp*3) with channels interleaved along the minor axis.
    wall = jnp.asarray(WALL_ENCODING, dtype=jnp.int8)
    inside = (
        ((jnp.arange(wp) >= vs) & (jnp.arange(wp) < vs + w))[:, None]
        & ((jnp.arange(hp) >= vs) & (jnp.arange(hp) < vs + h))[None, :]
    )
    big = jnp.pad(grid.astype(jnp.int8), ((vs, vs), (vs, vs), (0, 0)))
    big = jnp.where(inside[..., None], big, wall).reshape(wp, hp * 3)

    top_x, top_y = get_view_exts(state.agent_dir, state.agent_pos, vs)

    # 3. All agents' windows in world orientation via predicated-roll crops
    #    (window[a, u, v] = big[top_x[a] + vs + u, top_y[a] + vs + v]).
    v = jnp.broadcast_to(big[None], (n, wp, hp * 3))
    v = _shift_crop(v, top_x + vs, vs, axis=1)               # (N, vs, hp*3)
    v = _shift_crop(v, top_y + vs, vs, axis=2, stride=3)     # (N, vs, vs*3)
    win = v.reshape(n, vs, vs, 3)

    # 4. Rotate (dir + 1) % 4 left-rotations so the agent faces up
    #    (obs.py:180-196); k left-rotations == jnp.rot90(..., k=-k). The
    #    rotation count is per-agent traced, so select between the four
    #    statically-rotated copies with masks (no dynamic indexing).
    k = ((state.agent_dir + 1) % 4).reshape((-1, 1, 1, 1))
    out = jnp.where(k == 0, win, 0)
    for kk in range(1, 4):
        out = out + jnp.where(
            k == kk, jnp.rot90(win, k=-kk, axes=(1, 2)), 0
        )

    # 5. Carried-object overlay at the agent's own view cell (obs.py:204-207)
    #    — written unconditionally, empty encoding when hands are free.
    #    One-hot select on the (static) cell: pure elementwise, no scatter.
    own_cell = (
        (jnp.arange(vs) == vs // 2)[:, None] & (jnp.arange(vs) == vs - 1)[None, :]
    )
    out = jnp.where(
        own_cell[None, :, :, None],
        state.agent_carrying.astype(jnp.int8)[:, None, None, :],
        out,
    )
    return out.astype(jnp.int32)


@functools.partial(jax.jit, static_argnums=(1, 2))
def gen_obs_grid_encoding(
    state: MultiGridState, view_size: int, see_through_walls: bool
) -> jax.Array:
    """Full observation images including visibility masking (obs.py:65-102).

    Returns ``(N, vs, vs, 3)`` int32 where invisible cells are overwritten
    with the unseen encoding unless ``see_through_walls``.
    """
    obs = gen_obs_grid(state, view_size)
    if see_through_walls:
        return obs
    vis = get_vis_mask(obs)
    unseen = jnp.asarray(UNSEEN_ENCODING, dtype=obs.dtype)
    return jnp.where(vis[..., None], obs, unseen)


def gen_obs(cfg: EnvConfig, state: MultiGridState) -> dict[str, jax.Array]:
    """Generate the observation pytree for all agents (base.py:348-376).

    Returns ``{'image': (N, vs, vs, 3) int32, 'direction': (N,) int32}``.
    Mission strings live at the adapter layer; batched cores carry mission
    indices in ``state.extras`` when an environment parameterizes them.
    """
    image = gen_obs_grid_encoding(state, cfg.view_size, cfg.see_through_walls)
    return {'image': image, 'direction': state.agent_dir}
