"""Halo exchange for row-sharded image fields inside ``shard_map``.

The image grid is tiled along H across the ``space`` mesh axis.  Every
stencil of radius r needs r rows from each neighbor; strips move between
mesh neighbors with ``lax.ppermute`` (the same communication shape as ring
attention's KV rotation).

Global edges (the top of shard 0, the bottom of shard n-1) are filled
according to ``mode`` so that every boundary convention in the pipeline can
run sharded:

* ``'zero'``      — zero rows.  Correct for the flow Laplacian, whose
  dangling edge weights are zero by construction (ops/stencil.py).
* ``'edge'``      — replicate the edge row (scipy ``nearest`` / np ``edge``);
  used by the warp gathers' clamped reads.
* ``'symmetric'`` — mirror including the edge row (scipy ``reflect``);
  used by the derivative/pyramid/median filters.
* ``'reflect'``   — mirror excluding the edge row (np ``reflect``);
  used by the weighted median (reference ``weighted_median.py:78-84``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def _shift_down(x_slice, axis_name: str):
    """Send each shard's strip to the NEXT shard (receive from previous)."""
    n = lax.axis_size(axis_name)
    perm = [(i, i + 1) for i in range(n - 1)]
    return lax.ppermute(x_slice, axis_name, perm)


def _shift_up(x_slice, axis_name: str):
    """Send each shard's strip to the PREVIOUS shard (receive from next)."""
    n = lax.axis_size(axis_name)
    perm = [(i + 1, i) for i in range(n - 1)]
    return lax.ppermute(x_slice, axis_name, perm)


def _edge_fill(x, radius: int, top: bool):
    """Boundary rows this shard would synthesize if it sits at a global edge."""
    if top:
        return jnp.broadcast_to(x[0:1], (radius,) + x.shape[1:])
    return jnp.broadcast_to(x[-1:], (radius,) + x.shape[1:])


def _symmetric_fill(x, radius: int, top: bool):
    return x[:radius][::-1] if top else x[-radius:][::-1]


def _reflect_fill(x, radius: int, top: bool):
    return x[1 : radius + 1][::-1] if top else x[-radius - 1 : -1][::-1]


_FILLS = {"edge": _edge_fill, "symmetric": _symmetric_fill, "reflect": _reflect_fill}


def halo_exchange_rows(x, radius: int, axis_name: str, mode: str = "zero"):
    """Extend a local (Hs, W[, C]) block with ``radius`` rows of halo.

    Returns an array of shape (Hs + 2*radius, W[, C]).  Interior shards
    receive neighbor rows; the global top/bottom edges are filled
    per ``mode`` (see module docstring).
    """
    top_halo = _shift_down(x[-radius:], axis_name)  # from the shard above
    bottom_halo = _shift_up(x[:radius], axis_name)  # from the shard below
    if mode != "zero":
        fill = _FILLS[mode]
        idx = lax.axis_index(axis_name)
        n = lax.axis_size(axis_name)
        top_halo = jnp.where(idx == 0, fill(x, radius, top=True), top_halo)
        bottom_halo = jnp.where(idx == n - 1, fill(x, radius, top=False), bottom_halo)
    return jnp.concatenate([top_halo, x, bottom_halo], axis=0)


def halo_exchange_rows_multi(xs, radius: int, axis_name: str):
    """Halo-extend several same-shaped (Hs, W) planes with ONE ppermute pair.

    The channel-split CG state keeps (u, v) as separate planes for lane
    occupancy (``solvers/cg.py::pcg_solve_split``), but a naive per-plane
    halo exchange would double the per-iteration collective count.  Only
    the thin boundary strips travel: the planes' strips are stacked into a
    single (n, radius, W) payload, so the ``ppermute`` count — the
    latency-bound cost on a mesh — stays what it was for one stacked
    (Hs, W, 2) array while the CG body itself runs on full-lane planes.

    Zero-fill at the global edges only (the flow Laplacian's dangling edge
    weights are zero by construction, ops/stencil.py).  Returns the list of
    (Hs + 2*radius, W) extended planes.
    """
    top_strips = jnp.stack([x[-radius:] for x in xs])
    bot_strips = jnp.stack([x[:radius] for x in xs])
    top_halo = _shift_down(top_strips, axis_name)  # from the shard above
    bottom_halo = _shift_up(bot_strips, axis_name)  # from the shard below
    return [
        jnp.concatenate([top_halo[i], x, bottom_halo[i]], axis=0)
        for i, x in enumerate(xs)
    ]
