"""Spatiotemporal derivatives with warping — the hot inner kernel.

Reference: ``utils/derivatives.py``.  Three interpolation paths are
supported with exact semantics:

* ``'cubic'`` (default) — cubic B-spline warping.  scipy's recursive
  prefilter is replaced by dense per-axis inverse matrices (matmuls,
  see :mod:`optical_flow_tpu.ops.interp`), evaluation is a 4x4 gather.
* ``'bi-linear'`` — 2x2 gather.
* ``'bi-cubic'`` — Hermite bicubic with *analytical* spatial derivatives
  (Numerical Recipes 16x16 coefficient matrix).  The per-pixel coefficient
  solve is batched into one (16,16) x (16, N) matmul.

Restructuring vs the reference: everything that depends only on
the *images* (derivative images, spline coefficients, Hermite corner
tables) is split into :func:`precompute_warp` so the per-warping-iteration
work (:func:`warp_deriv`) is pure gather + FMA.  The reference recomputes
these per call (``derivatives.py:148-296``); hoisting is mathematically
identical.

Out-of-bounds pixels are masked to zero in It/Ix/Iy with the same masks the
reference derives from NaNs (``derivatives.py:188,246-247,263-264``) — no
NaNs ever materialize on-device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from optical_flow_tpu.ops.filters import correlate2d
from optical_flow_tpu.ops.interp import (
    sample_bilinear,
    sample_cubic_spline,
    spline_coeffs_2d,
)

DEFAULT_DERIV_FILTER = np.array([1.0, -8.0, 0.0, 8.0, -1.0]) / 12.0

# Hermite bicubic coefficient matrix (Numerical Recipes "bcucof" table).
W_BICUBIC = np.array(
    [
        [1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0],
        [-3, 0, 0, 3, 0, 0, 0, 0, -2, 0, 0, -1, 0, 0, 0, 0],
        [2, 0, 0, -2, 0, 0, 0, 0, 1, 0, 0, 1, 0, 0, 0, 0],
        [0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0],
        [0, 0, 0, 0, -3, 0, 0, 3, 0, 0, 0, 0, -2, 0, 0, -1],
        [0, 0, 0, 0, 2, 0, 0, -2, 0, 0, 0, 0, 1, 0, 0, 1],
        [-3, 3, 0, 0, -2, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, -3, 3, 0, 0, -2, -1, 0, 0],
        [9, -9, 9, -9, 6, 3, -3, -6, 6, -6, -3, 3, 4, 2, 1, 2],
        [-6, 6, -6, 6, -4, -2, 2, 4, -3, 3, 3, -3, -2, -1, -1, -2],
        [2, -2, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 2, -2, 0, 0, 1, 1, 0, 0],
        [-6, 6, -6, 6, -3, -3, 3, 3, -4, 4, 2, -2, -2, -2, -1, -1],
        [4, -4, 4, -4, 2, 2, -2, -2, 2, -2, -2, 2, 1, 1, 1, 1],
    ],
    dtype=np.float64,
)


class WarpPrecompute(NamedTuple):
    """Flow-independent per-level tables for :func:`warp_deriv`.

    Channel layout: every field is a tuple over channels (length 1 for
    grayscale pairs).
    """

    method: str
    blend: float
    im1: tuple  # per-channel (H, W)
    I1x: tuple
    I1y: tuple
    # cubic / bi-linear path
    warp_tables: tuple  # cubic: spline coeffs of (im2, I2x, I2y); bilinear: raw
    # bi-cubic path: (Z, DX, DY, DXY) per channel
    hermite_tables: tuple


def _split_pair(images):
    """Split an (H, W, 2) / (H, W, 2C) stack into per-channel frame tuples."""
    nc = images.shape[2] // 2
    im1 = tuple(images[:, :, c] for c in range(nc))
    im2 = tuple(images[:, :, nc + c] for c in range(nc))
    return im1, im2


def precompute_warp(images, interp_method: str = "cubic", deriv_filter=None, blend: float = 0.5):
    """Build all flow-independent tables for one pyramid level."""
    if deriv_filter is None:
        deriv_filter = DEFAULT_DERIV_FILTER
    f = np.asarray(deriv_filter, dtype=np.float64)
    fx = f.reshape(1, -1)
    fy = f.reshape(-1, 1)
    fxy = np.outer(f, f)  # cross-derivative filter (reference derivatives.py:82)

    im1s, im2s = _split_pair(images)
    I1x = tuple(correlate2d(c, fx, "reflect") for c in im1s)
    I1y = tuple(correlate2d(c, fy, "reflect") for c in im1s)

    warp_tables = ()
    hermite_tables = ()
    if interp_method == "bi-cubic":
        hermite_tables = tuple(
            (
                c,
                correlate2d(c, fx, "reflect"),
                correlate2d(c, fy, "reflect"),
                correlate2d(c, fxy, "reflect"),
            )
            for c in im2s
        )
    elif interp_method == "cubic":
        warp_tables = tuple(
            (
                spline_coeffs_2d(c),
                spline_coeffs_2d(correlate2d(c, fx, "reflect")),
                spline_coeffs_2d(correlate2d(c, fy, "reflect")),
            )
            for c in im2s
        )
    elif interp_method == "bi-linear":
        warp_tables = tuple(
            (c, correlate2d(c, fx, "reflect"), correlate2d(c, fy, "reflect"))
            for c in im2s
        )
    else:
        raise ValueError(f"Unknown interpolation method: {interp_method}")

    return WarpPrecompute(
        method=interp_method,
        blend=float(blend),
        im1=im1s,
        I1x=I1x,
        I1y=I1y,
        warp_tables=warp_tables,
        hermite_tables=hermite_tables,
    )


# corner order per image: 00=(fx,fy), 10=(cx,fy), 11=(cx,cy), 01=(fx,cy)
HERMITE_CORNER_SHIFTS = ((0, 0), (0, 1), (1, 1), (1, 0))


def hermite_eval(taps, ax, ay, dtype):
    """(val, d/dx, d/dy) from 16 corner taps and in-cell offsets (ax, ay).

    ``taps`` is (..., 16): for each of (Z, DX, DY, DXY) the four corners in
    :data:`HERMITE_CORNER_SHIFTS` order.  One matmul with the Numerical
    Recipes coefficient matrix solves the 16 polynomial coefficients for
    every pixel at once.
    """
    V = jnp.moveaxis(taps, -1, 0)  # (16, ...)
    C = jnp.tensordot(
        jnp.asarray(W_BICUBIC, dtype=dtype), V, axes=1,
        precision=jax.lax.Precision.HIGHEST,
    )

    ax_p = [jnp.ones_like(ax), ax, ax * ax, ax * ax * ax]
    ay_p = [jnp.ones_like(ay), ay, ay * ay, ay * ay * ay]

    val = jnp.zeros_like(ax)
    vx = jnp.zeros_like(ax)
    vy = jnp.zeros_like(ax)
    idx = 0
    for i in range(4):
        for j in range(4):
            c = C[idx]
            val = val + c * ax_p[i] * ay_p[j]
            if i > 0:
                vx = vx + i * c * ax_p[i - 1] * ay_p[j]
            if j > 0:
                vy = vy + j * c * ax_p[i] * ay_p[j - 1]
            idx += 1
    return val, vx, vy


def _hermite_bicubic(tables, yq, xq, dtype):
    """Hermite bicubic sample + analytical d/dx, d/dy at (yq, xq), 0-based.

    Returns (val, vx, vy, oob).  ``oob`` follows the reference's
    ``interp2_bicubic`` convention: a point is out once its ceil neighbor
    leaves the grid (``derivatives.py:52-56``), i.e. x >= W-1 counts as out.
    """
    from optical_flow_tpu.ops.gather import gather_planes

    Z, DX, DY, DXY = tables
    H, W = Z.shape
    fx = jnp.floor(xq)
    fy = jnp.floor(yq)
    oob = (fx < 0) | (fx + 1 > W - 1) | (fy < 0) | (fy + 1 > H - 1)

    iy0 = jnp.clip(fy, 0, H - 1).astype(jnp.int32)
    ix0 = jnp.clip(fx, 0, W - 1).astype(jnp.int32)

    # All 16 corner reads are one batched gather: corner (a, b) of image A
    # equals the edge-padded shift A[r+a, c+b] at the clamped base index —
    # identical to clipping each corner separately.
    planes = jnp.stack(
        [
            jnp.pad(A, ((0, 1), (0, 1)), mode="edge")[a : a + H, b : b + W]
            for A in (Z, DX, DY, DXY)
            for (a, b) in HERMITE_CORNER_SHIFTS
        ],
        axis=-1,
    )
    taps = gather_planes(planes, iy0, ix0)  # (..., 16)
    val, vx, vy = hermite_eval(taps, xq - fx, yq - fy, dtype)
    return val, vx, vy, oob


def warp_deriv(pre: WarpPrecompute, uv):
    """Warp frame 2 by ``uv`` and return (It, Ix, Iy).

    Shapes mirror the reference ``partial_deriv``: (H, W) for grayscale
    pairs, (H, W, C) otherwise.
    """
    H, W = uv.shape[:2]
    dtype = uv.dtype
    ygrid, xgrid = jnp.meshgrid(
        jnp.arange(H, dtype=dtype), jnp.arange(W, dtype=dtype), indexing="ij"
    )
    xq = xgrid + uv[:, :, 0]
    yq = ygrid + uv[:, :, 1]
    # strictly-outside mask, 0-based equivalent of reference's B (derivatives.py:188)
    B = (xq > W - 1) | (xq < 0) | (yq > H - 1) | (yq < 0)

    blend = pre.blend
    Its, Ixs, Iys = [], [], []
    nc = len(pre.im1)
    for c in range(nc):
        if pre.method == "bi-cubic":
            warp, wx, wy, oob = _hermite_bicubic(
                pre.hermite_tables[c], yq, xq, dtype
            )
            mask = oob  # bi-cubic zeroes via the interpolator's own oob (nan) mask
            It = warp - pre.im1[c]
            Ix = blend * wx + (1 - blend) * pre.I1x[c]
            Iy = blend * wy + (1 - blend) * pre.I1y[c]
        else:
            if pre.method == "cubic":
                c_im, c_dx, c_dy = pre.warp_tables[c]
                warp, _ = sample_cubic_spline(c_im, yq, xq)
                wx, _ = sample_cubic_spline(c_dx, yq, xq)
                wy, _ = sample_cubic_spline(c_dy, yq, xq)
            else:  # bi-linear
                t_im, t_dx, t_dy = pre.warp_tables[c]
                warp = sample_bilinear(t_im, yq, xq, mode="nearest")
                wx = sample_bilinear(t_dx, yq, xq, mode="nearest")
                wy = sample_bilinear(t_dy, yq, xq, mode="nearest")
            mask = B
            It = warp - pre.im1[c]
            Ix = blend * wx + (1 - blend) * pre.I1x[c]
            Iy = blend * wy + (1 - blend) * pre.I1y[c]

        zero = jnp.zeros((), dtype=dtype)
        Its.append(jnp.where(mask, zero, It))
        Ixs.append(jnp.where(mask, zero, Ix))
        Iys.append(jnp.where(mask, zero, Iy))

    if nc == 1:
        return Its[0], Ixs[0], Iys[0]
    return (
        jnp.stack(Its, axis=2),
        jnp.stack(Ixs, axis=2),
        jnp.stack(Iys, axis=2),
    )


def partial_deriv(images, uv, interp_method: str = "cubic", deriv_filter=None, blend: float = 0.5):
    """Reference-compatible one-shot API (``derivatives.py:148-296``)."""
    pre = precompute_warp(images, interp_method, deriv_filter, blend)
    return warp_deriv(pre, uv)


def interp2_bicubic(Z, XI, YI, deriv_filter=None):
    """Hermite bicubic interpolation with analytical derivatives.

    Reference-compatible surface (``derivatives.py:27-145``): 1-based
    coordinates, returns (ZI, ZXI, ZYI) with out-of-boundary ZI marked NaN.
    """
    if deriv_filter is None:
        deriv_filter = DEFAULT_DERIV_FILTER
    f = np.asarray(deriv_filter, dtype=np.float64)
    Z = jnp.asarray(Z)
    XI = jnp.asarray(XI)
    YI = jnp.asarray(YI)
    tables = (
        Z,
        correlate2d(Z, f.reshape(1, -1), "reflect"),
        correlate2d(Z, f.reshape(-1, 1), "reflect"),
        correlate2d(Z, np.outer(f, f), "reflect"),
    )
    val, vx, vy, oob = _hermite_bicubic(tables, YI - 1.0, XI - 1.0, Z.dtype)
    val = jnp.where(oob, jnp.nan, val)
    return val, vx, vy
