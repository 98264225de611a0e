"""Image gathers for warping.

Every warp in this pipeline gathers K source planes at the SAME per-pixel
indices (e.g. Hermite bicubic = 4 derivative images x 4 corner shifts).
Three exact implementations are kept (``OFTPU_GATHER_IMPL``):

* ``perplane`` (the default): K independent (H, W) gathers;
* ``batched``: one gather of the stacked (H, W, K) planes;
* ``displaced`` / ``displaced_blocked``: a sweep of masked shifted views
  over the runtime displacement rectangle (:func:`gather_displaced`).
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp

# 'auto' | 'displaced' | 'displaced_blocked' | 'perplane' | 'batched'
# ('auto' = 'perplane').
GATHER_IMPL = os.environ.get("OFTPU_GATHER_IMPL", "auto")


def _impl(shapes_match: bool) -> str:
    impl = GATHER_IMPL
    if impl == "auto":
        return "perplane"
    if impl in ("displaced", "displaced_blocked") and not shapes_match:
        return "perplane"
    if impl == "displaced_blocked":
        return "displaced"  # variant selection happens inside the impl
    return impl


def gather_planes(planes, iy, ix):
    """``out[i, j, k] = planes[iy[i,j], ix[i,j], k]`` for in-range indices.

    Args:
        planes: (H_in, W_in, K) stack of source planes.
        iy, ix: (H_out, W_out) int32 indices, already clamped in-range.
    Returns:
        (H_out, W_out, K).
    """
    impl = _impl(iy.shape == planes.shape[:2])
    if impl == "displaced":
        return gather_displaced(planes, iy, ix)
    if impl == "perplane":
        K = planes.shape[2]
        return jnp.stack([planes[:, :, k][iy, ix] for k in range(K)], axis=-1)
    if impl == "batched":
        return planes[iy, ix]
    raise ValueError(f"Unknown gather impl {impl!r} (OFTPU_GATHER_IMPL?)")


# Max displacement magnitude the sweep's static padding covers; larger
# motions take the per-plane gather fallback (on-device lax.cond).
_MAX_TIER = 5

# Row-blocked sweep (see sweep_blocked): block height, and the minimum
# image height at which 'auto' prefers the blocked variant — small frames
# have few blocks to localize over and the global sweep is already tuned.
_BLOCK_ROWS = 128
_BLOCK_MIN_H = 1024
# The blocked sweep's cost scales with the LOCAL displacement range, so it
# affords a much larger static pad before the per-plane fallback: coherent
# multi-pixel flows (4K fine levels) sweep in near-constant time where the
# global-rectangle sweep would pay (2D+1)^2 passes.
_MAX_TIER_BLOCKED = 24


def _gather_displaced_impl(planes, iy, ix):
    """Displacement-rectangle sweep over (B, H, W, K) planes / (B, H, W) indices.

    The sweep iterates ONLY the runtime displacement rectangle
    [min(di)..max(di)] x [min(dj)..max(dj)] with a dynamic-trip-count
    ``while_loop`` — not the full (2D+1)^2 square sized by the max
    magnitude.  Real flow fields concentrate in a small range (e.g.
    RubberWhale's finest level spans ~4x4 offsets inside the 11x11 D<=5
    square), so the number of full-stack passes drops by ~5-10x with
    identical results; the worst case equals the old square sweep.  One
    dynamic-slice body compiles once.

    The feasibility test uses ONE scalar D = max displacement over the whole
    batch, so ``lax.cond`` stays a true branch (a vmapped cond with a
    batched predicate would execute BOTH branches — sweep + slow per-plane
    gather — for every element; this is why batching is claimed via
    custom_vmap).
    """
    B, H, W, K = planes.shape
    ii = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    di = iy - ii
    dj = ix - jj
    D = jnp.maximum(jnp.max(jnp.abs(di)), jnp.max(jnp.abs(dj)))

    # 'displaced_blocked' forces the row-blocked variant, an explicit
    # 'displaced' forces the global-rectangle sweep (the A/B knob at the
    # sizes where the two differ); only 'auto' picks by height.
    use_blocked = GATHER_IMPL == "displaced_blocked" or (
        GATHER_IMPL == "auto" and H >= _BLOCK_MIN_H
    )
    # the blocked sweep's pass count scales with the LOCAL range, so it can
    # afford a much larger static pad before the per-plane fallback bites
    TIER = _MAX_TIER_BLOCKED if use_blocked else _MAX_TIER

    P = jnp.pad(planes, ((0, 0), (TIER, TIER), (TIER, TIER), (0, 0)))

    def sweep():
        dylo, dyhi = jnp.min(di), jnp.max(di)
        dxlo, dxhi = jnp.min(dj), jnp.max(dj)
        wdx = dxhi - dxlo + 1
        num = (dyhi - dylo + 1) * wdx
        n = 2 * TIER + 1
        code = (di + TIER) * n + (dj + TIER)

        def cond(state):
            t, _ = state
            return t < num

        def body(state):
            t, acc = state
            dy = dylo + t // wdx
            dx = dxlo + t % wdx
            zero = jnp.int32(0)
            view = jax.lax.dynamic_slice(
                P,
                (zero, jnp.int32(TIER) + dy, jnp.int32(TIER) + dx, zero),
                (B, H, W, K),
            )
            hit = code == (dy + TIER) * n + (dx + TIER)
            return t + 1, acc + jnp.where(hit[:, :, :, None], view, 0.0)

        _, out = jax.lax.while_loop(
            cond, body, (jnp.int32(0), jnp.zeros_like(planes))
        )
        return out

    def sweep_blocked():
        """Row-blocked sweep: each block pays only ITS displacement rectangle.

        The global sweep's pass count is the GLOBAL rectangle — a smooth
        flow spanning ±4 px across the frame costs ~80 passes even though
        any 128-row band locally spans ~1 px.  Blocking converts the cost
        from global range to mean local range.  Worst case
        (pixel-frequency displacement oscillation) equals the global sweep.
        """
        T = TIER
        Rb = _BLOCK_ROWS
        NB = -(-H // Rb)
        pad_r = NB * Rb - H
        # padded rows carry d = (0, 0): at most widens the last block's
        # rectangle to include the zero offset
        di_p = jnp.pad(di, ((0, 0), (0, pad_r), (0, 0)))
        dj_p = jnp.pad(dj, ((0, 0), (0, pad_r), (0, 0)))
        n = 2 * T + 1
        code_p = (di_p + T) * n + (dj_p + T)
        Pp = jnp.pad(P, ((0, 0), (0, pad_r), (0, 0), (0, 0)))

        def block(nb):
            r0 = (nb * Rb).astype(jnp.int32)  # x64-safe slice index
            zero = jnp.int32(0)
            win = jax.lax.dynamic_slice(
                Pp, (zero, r0, zero, zero), (B, Rb + 2 * T, W + 2 * T, K)
            )
            dib = jax.lax.dynamic_slice(di_p, (zero, r0, zero), (B, Rb, W))
            djb = jax.lax.dynamic_slice(dj_p, (zero, r0, zero), (B, Rb, W))
            cb = jax.lax.dynamic_slice(code_p, (zero, r0, zero), (B, Rb, W))
            dylo, dyhi = jnp.min(dib), jnp.max(dib)
            dxlo, dxhi = jnp.min(djb), jnp.max(djb)
            wdx = dxhi - dxlo + 1
            num = (dyhi - dylo + 1) * wdx

            def cond(state):
                t, _ = state
                return t < num

            def body(state):
                t, acc = state
                dy = dylo + t // wdx
                dx = dxlo + t % wdx
                view = jax.lax.dynamic_slice(
                    win, (zero, jnp.int32(T) + dy, jnp.int32(T) + dx, zero),
                    (B, Rb, W, K),
                )
                hit = cb == (dy + T) * n + (dx + T)
                return t + 1, acc + jnp.where(hit[:, :, :, None], view, 0.0)

            _, out = jax.lax.while_loop(
                cond, body, (jnp.int32(0), jnp.zeros((B, Rb, W, K), planes.dtype))
            )
            return out

        out = jax.lax.map(block, jnp.arange(NB))  # (NB, B, Rb, W, K)
        out = jnp.moveaxis(out, 0, 1).reshape(B, NB * Rb, W, K)
        return out[:, :H]

    def fallback():
        def one(args):
            p, y, x = args
            return jnp.stack([p[:, :, k][y, x] for k in range(K)], axis=-1)

        return jax.lax.map(one, (planes, iy, ix))

    chosen = sweep_blocked if use_blocked else sweep
    return jax.lax.cond(D <= TIER, chosen, fallback)


@jax.custom_batching.custom_vmap
def gather_displaced(planes, iy, ix):
    """Exact gather specialized for displacement fields (warps).

    ``out[i,j,k] = planes[iy[i,j], ix[i,j], k]`` where (iy, ix) deviate from
    the identity grid by a *bounded* displacement most of the time (optical
    flow magnitudes).  When the runtime max displacement D fits a static
    tier, the gather becomes a (2D+1)^2 sweep of masked shifted views — an
    elementwise pass over all K planes at once.  Larger displacements fall back to the
    per-plane gather.  Selection happens on-device via ``lax.cond``, so a
    single compiled program serves any motion magnitude.

    Requires ``iy.shape == ix.shape == planes.shape[:2]`` and indices
    already clamped in-range.  vmap-safe: the batching rule runs the same
    sweep over the stacked batch with a single batch-wide tier decision.
    """
    return _gather_displaced_impl(planes[None], iy[None], ix[None])[0]


@gather_displaced.def_vmap
def _gather_displaced_vmap(axis_size, in_batched, planes, iy, ix):
    planes, iy, ix = [
        x if bat else jnp.broadcast_to(x, (axis_size, *x.shape))
        for x, bat in zip((planes, iy, ix), in_batched)
    ]
    return _gather_displaced_impl(planes, iy, ix), True


def gather_shifted_planes(padded, shifts, iy, ix):
    """Gather ``len(shifts)`` static shifts of one padded image at (iy, ix).

    ``padded`` is (H_in + max_dy, W_in + max_dx); shift (dy, dx) selects the
    plane ``padded[dy : dy + H, dx : dx + W]``.  Returns (H_out, W_out, K).
    """
    H = padded.shape[0] - max(dy for dy, _ in shifts)
    W = padded.shape[1] - max(dx for _, dx in shifts)
    planes = jnp.stack(
        [padded[dy : dy + H, dx : dx + W] for dy, dx in shifts], axis=-1
    )
    return gather_planes(planes, iy, ix)
