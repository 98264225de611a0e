"""Image sampling: bilinear and cubic B-spline interpolation.

Design notes
------------
* The cubic-spline *prefilter* (scipy's recursive IIR pass) is recast as a
  dense matmul: the interpolation system is tridiagonal with mirror folding,
  so its inverse is a fixed (n, n) matrix per axis length.  ``coeffs =
  P_h @ im @ P_w^T`` runs as two matmuls instead of a
  sequential scan — exact to machine precision against
  ``scipy.ndimage.spline_filter`` (verified in tests).
* Evaluation gathers a 4×4 (cubic) or 2×2 (linear) neighborhood.  Gathers
  are expressed over a mirror-padded array with clamped indices so every
  lane does identical work (no data-dependent branches).
* Out-of-bounds handling matches ``scipy.ndimage.map_coordinates``:
  strictly-outside points yield ``cval`` (the caller masks), interior
  points near the edge use mirror extension — the same semantics the
  reference relies on (``derivatives.py:235-292``).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

# Full float32 precision for the resize / prefilter contractions: the GPU's
# default float32 matmul may run in TF32 (~3 decimal digits).
HIGHEST = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=HIGHEST)


# ---------------------------------------------------------------------------
# prefilter
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def bspline_prefilter_matrix(n: int) -> np.ndarray:
    """Inverse of the cubic B-spline interpolation system with mirror BC.

    Row i of the system: (c[i-1] + 4 c[i] + c[i+1]) / 6 = f[i], with mirror
    folding c[-1] = c[1], c[n] = c[n-2].  The dense inverse reproduces
    ``scipy.ndimage.spline_filter1d(order=3)`` exactly and turns the
    prefilter into a matmul.
    """
    if n == 1:
        return np.ones((1, 1))
    B = np.zeros((n, n))
    for i in range(n):
        B[i, i] += 4.0 / 6.0
        for d in (-1, 1):
            j = i + d
            if j < 0:
                j = -j
            if j >= n:
                j = 2 * (n - 1) - j
            B[i, j] += 1.0 / 6.0
    return np.linalg.inv(B)


def spline_coeffs_2d(im):
    """Cubic B-spline coefficients of a 2-D image via two matmuls."""
    H, W = im.shape
    Ph = jnp.asarray(bspline_prefilter_matrix(H), dtype=im.dtype)
    Pw = jnp.asarray(bspline_prefilter_matrix(W), dtype=im.dtype)
    return _mm(_mm(Ph, im), Pw.T)


def _bspline3(t):
    """Cubic B-spline kernel beta^3(t), support |t| < 2."""
    at = jnp.abs(t)
    inner = 2.0 / 3.0 - at**2 + at**3 / 2.0
    outer = (2.0 - at) ** 3 / 6.0
    return jnp.where(at < 1.0, inner, jnp.where(at < 2.0, outer, 0.0))


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------


def sample_cubic_spline(coeffs, ys, xs):
    """Evaluate a cubic B-spline surface at (ys, xs) (0-based, float).

    ``coeffs`` are precomputed spline coefficients (see
    :func:`spline_coeffs_2d`).  Returns ``(values, oob)`` where ``oob``
    marks strictly-out-of-domain points (caller decides the fill value,
    matching map_coordinates' ``cval`` contract).

    The 4x4 tap read is one 16-plane gather (see ops/gather.py); tap
    weights come from the unclamped
    fractional offsets, so interior results are exact.
    """
    from optical_flow_tpu.ops.gather import gather_shifted_planes

    H, W = coeffs.shape
    padded = jnp.pad(coeffs, 2, mode="reflect")  # mirror extension, no edge dup
    fy = jnp.floor(ys)
    fx = jnp.floor(xs)
    # clamped base indices (out-of-domain rows are masked by the caller)
    iy = jnp.clip(fy, 0, H - 1).astype(jnp.int32)
    ix = jnp.clip(fx, 0, W - 1).astype(jnp.int32)

    offsets = (-1, 0, 1, 2)
    shifts = [(dy + 2, dx + 2) for dy in offsets for dx in offsets]
    taps = gather_shifted_planes(padded, shifts, iy, ix)  # (..., 16)

    wy = [_bspline3(ys - (fy + dy)) for dy in offsets]
    wx = [_bspline3(xs - (fx + dx)) for dx in offsets]
    out = jnp.zeros_like(ys)
    for a, dy in enumerate(offsets):
        for b, dx in enumerate(offsets):
            out = out + wy[a] * wx[b] * taps[..., a * 4 + b]
    oob = (ys < 0) | (ys > H - 1) | (xs < 0) | (xs > W - 1)
    return out, oob


def sample_bilinear(im, ys, xs, mode: str = "nearest"):
    """Bilinear sampling at (ys, xs), 0-based.

    ``mode='nearest'`` clamps coordinates to the image (scipy
    ``map_coordinates(order=1, mode='nearest')`` — used by occlusion
    detection and flow resampling).  ``mode='constant'`` additionally
    returns an ``oob`` mask for strictly-outside points.
    """
    from optical_flow_tpu.ops.gather import gather_shifted_planes

    H, W = im.shape
    ysc = jnp.clip(ys, 0.0, H - 1.0)
    xsc = jnp.clip(xs, 0.0, W - 1.0)
    y0f = jnp.floor(ysc)
    x0f = jnp.floor(xsc)
    y0 = y0f.astype(jnp.int32)
    x0 = x0f.astype(jnp.int32)
    ay = ysc - y0f
    ax = xsc - x0f
    padded = jnp.pad(im, ((0, 1), (0, 1)), mode="edge")
    taps = gather_shifted_planes(padded, [(0, 0), (0, 1), (1, 0), (1, 1)], y0, x0)
    v00, v01, v10, v11 = (taps[..., k] for k in range(4))
    top = v00 * (1.0 - ax) + v01 * ax
    bot = v10 * (1.0 - ax) + v11 * ax
    val = top * (1.0 - ay) + bot * ay
    if mode == "nearest":
        return val
    oob = (ys < 0) | (ys > H - 1) | (xs < 0) | (xs > W - 1)
    return val, oob


# ---------------------------------------------------------------------------
# fixed-grid linear resizes as matmuls
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def matlab_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """1-D MATLAB ``imresize(..., 'bilinear', Antialiasing=false)`` operator.

    MATLAB's coordinate convention u = (out + 0.5) / scale - 0.5, clipped to
    the valid range (reference ``pyramid.py:11-41``).  Returned as a dense
    (n_out, n_in) matrix so a 2-D resize is two matmuls.
    """
    scale = n_out / n_in
    u = (np.arange(n_out) + 0.5) / scale - 0.5
    u = np.clip(u, 0, n_in - 1)
    lo = np.floor(u).astype(int)
    hi = np.minimum(lo + 1, n_in - 1)
    a = u - lo
    M = np.zeros((n_out, n_in))
    M[np.arange(n_out), lo] += 1.0 - a
    M[np.arange(n_out), hi] += a
    return M


def matlab_imresize_bilinear(im, out_hw):
    """2-D MATLAB-convention bilinear resize for (H, W) or (H, W, C)."""
    H, W = im.shape[:2]
    new_H, new_W = int(out_hw[0]), int(out_hw[1])
    Rh = jnp.asarray(matlab_resize_matrix(H, new_H), dtype=im.dtype)
    Rw = jnp.asarray(matlab_resize_matrix(W, new_W), dtype=im.dtype)
    if im.ndim == 2:
        return _mm(_mm(Rh, im), Rw.T)
    return jnp.einsum("oi,ijc,pj->opc", Rh, im, Rw, precision=HIGHEST)
