"""On-device procedural placement primitives.

The reference places objects/agents with unbounded host-side rejection
sampling (multigrid/base.py:604-670). Rejection sampling over a rectangle,
accepting the first valid cell, is distributionally identical to sampling
uniformly over the valid cells — so the on-device speed-mode reset uses the
Gumbel-argmax trick: one fixed-cost draw per placement, no loops.

(Bit-exact parity with the reference's numpy draw sequences is provided by
the separate host-side parity generators in ``multigrid_tpu.envs.parity``.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.constants import TYPE_EMPTY


def agent_occupancy(agent_pos: jax.Array, width: int, height: int) -> jax.Array:
    """(W, H) bool mask of cells occupied by any agent.

    One-hot masked reduce (a traced-index scatter would serialize per env
    under vmap — this runs on the per-step auto-reset path). Unplaced agents
    at (-1, -1) match no cell.
    """
    cx = jnp.arange(width, dtype=jnp.int32)[:, None, None]
    cy = jnp.arange(height, dtype=jnp.int32)[None, :, None]
    # NB: index the coordinate axis with `[..., k]`, not `[None, None, :, k]`
    # — mixing None with an int index falls off jnp's slice fast path and
    # lowers to a (constant-index) gather under vmap.
    hit = (cx == agent_pos[..., 0][None, None, :]) \
        & (cy == agent_pos[..., 1][None, None, :])
    return jnp.any(hit, axis=-1)


def rect_mask(
    width: int, height: int, top: tuple | jax.Array, size: tuple | jax.Array
) -> jax.Array:
    """(W, H) bool mask of cells inside the rectangle [top, top + size)."""
    xs = jnp.arange(width)[:, None]
    ys = jnp.arange(height)[None, :]
    tx, ty = top[0], top[1]
    return (xs >= tx) & (xs < tx + size[0]) & (ys >= ty) & (ys < ty + size[1])


def uniform_position(key: jax.Array, valid: jax.Array) -> jax.Array:
    """Sample a cell uniformly from the True entries of a (W, H) mask.

    Argmax of i.i.d. random bits over the valid cells — the fixed-cost
    equivalent of the reference's accept-first-valid rejection loop
    (base.py:637-662), distribution-identical to Gumbel-argmax but without
    transcendentals (uniform-tie probability ~W·H/2³² is negligible; the
    auto-reset path runs this every step). If no cell is valid, returns
    cell 0 — callers must guarantee satisfiability, as the reference does
    implicitly by looping forever.
    """
    w, h = valid.shape
    g = jax.random.bits(key, (w, h), dtype=jnp.uint32)
    # Top bit set on valid cells: a valid cell always beats invalid
    # ones even in the astronomically unlikely all-zero-bits draw.
    g = jnp.where(valid, (g >> 1) | jnp.uint32(1 << 31), jnp.uint32(0))
    flat_idx = jnp.argmax(g.reshape(-1))
    return jnp.stack([flat_idx // h, flat_idx % h]).astype(jnp.int32)


def set_cell(grid: jax.Array, pos: jax.Array, enc) -> jax.Array:
    """Write one cell encoding at a traced position WITHOUT a scatter.

    ``grid.at[pos[0], pos[1]].set(...)`` with traced indices lowers to a
    per-env scatter under vmap. A one-hot masked select is pure elementwise
    work.
    """
    w, h, _ = grid.shape
    cx = jnp.arange(w, dtype=jnp.int32)[:, None]
    cy = jnp.arange(h, dtype=jnp.int32)[None, :]
    mask = ((cx == pos[0]) & (cy == pos[1]))[..., None]
    enc = jnp.asarray(enc, dtype=grid.dtype)
    return jnp.where(mask, enc[None, None, :], grid)


def place_obj_mask(
    grid: jax.Array,
    agent_pos: jax.Array,
    top: tuple | jax.Array | None = None,
    size: tuple | jax.Array | None = None,
) -> jax.Array:
    """Validity mask for ``place_obj`` (base.py:604-662): cell empty, no
    agent present, inside the clamped target rectangle."""
    w, h, _ = grid.shape
    valid = (grid[..., 0] == TYPE_EMPTY) & ~agent_occupancy(agent_pos, w, h)
    if top is not None or size is not None:
        top = (0, 0) if top is None else (
            jnp.maximum(top[0], 0), jnp.maximum(top[1], 0))
        size = (w, h) if size is None else size
        valid = valid & rect_mask(w, h, top, size)
    return valid
