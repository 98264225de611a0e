"""MATLAB-compat numeric helpers.

These helpers reproduce the handful of MATLAB quirks that decide AEPE/AAE
parity with the reference pipeline (see reference ``interface.py:74-141``,
``image_processing.py:6-49``).  Everything here is pure ``jax.numpy`` and
shape-polymorphic, so it can run on the device inside ``jit`` or host-side.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def matlab_round(x: float) -> int:
    """Round half away from zero for positive sizes (MATLAB ``round``).

    Host-side scalar helper used for pyramid / resize shape schedules
    (reference ``pyramid.py:6-8``).
    """
    return int(np.floor(x + 0.5))


def scale_image(im, vlow, vhigh, ilow=None, ihigh=None):
    """Linearly rescale values of ``im`` from [ilow, ihigh] to [vlow, vhigh].

    When source bounds are omitted they are taken from the global min/max —
    across *all* channels, matching the reference (``image_processing.py:6-26``);
    the global (not per-channel) normalization inside the ROF decomposition
    is parity-critical.
    """
    im = jnp.asarray(im)
    if ilow is None:
        ilow = jnp.min(im)
    if ihigh is None:
        ihigh = jnp.max(im)
    span = ihigh - ilow
    mid = jnp.full_like(im, (vlow + vhigh) / 2.0)
    scaled = (im - ilow) / jnp.where(span == 0, 1.0, span) * (vhigh - vlow) + vlow
    return jnp.where(span == 0, mid, scaled)


def fspecial_gaussian(size, sigma) -> np.ndarray:
    """MATLAB ``fspecial('gaussian', size, sigma)`` kernel (host-side numpy).

    Reference: ``image_processing.py:29-49``.  Returned as numpy because the
    kernel is a trace-time constant baked into stencil programs.
    """
    if isinstance(size, (int, np.integer)):
        size = (int(size), int(size))
    m, n = [(s - 1) / 2.0 for s in size]
    y, x = np.ogrid[-m : m + 1, -n : n + 1]
    h = np.exp(-(x**2 + y**2) / (2.0 * sigma**2))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    s = h.sum()
    if s != 0:
        h /= s
    return h


def rgb2gray(im):
    """MATLAB ``double(rgb2gray(uint8(im)))`` with half-away-from-zero rounding.

    The uint8 quantization round-trip is parity-critical (reference
    ``interface.py:74-88``).
    """
    im = jnp.asarray(im)
    if im.ndim == 2:
        return im
    q = jnp.clip(jnp.floor(im + 0.5), 0, 255)
    gray = 0.2989 * q[:, :, 0] + 0.5870 * q[:, :, 1] + 0.1140 * q[:, :, 2]
    return jnp.floor(gray + 0.5)


def preprocess_color_pair(im1, im2):
    """Grayscale pair + [0,255]-scaled Lab guide (traceable, one fusion).

    The preprocessing the reference does host-side before ``compute_flow``
    (``interface.py:46-64``), expressed as pure jnp so it can be folded into
    a whole-flow device program — the frame pair then crosses the host link
    once, as raw (uint8) frames, and everything downstream is one dispatch.
    """
    gray = jnp.stack([rgb2gray(im1), rgb2gray(im2)], axis=2)
    lab = rgb2lab(im1)
    lab = jnp.stack(
        [scale_image(lab[:, :, j], 0, 255) for j in range(lab.shape[2])], axis=2
    )
    return gray, lab


def rgb2lab(im):
    """RGB -> CIE Lab with BT.709 primaries and D65 white point.

    Matches the reference's MATLAB-derived conversion (``interface.py:91-141``)
    including the conditional on whether the input is already in [0, 1].
    """
    im = jnp.asarray(im)
    R, G, B = im[:, :, 0], im[:, :, 1], im[:, :, 2]

    needs_norm = jnp.maximum(jnp.maximum(R.max(), G.max()), B.max()) > 1.0
    scale = jnp.where(needs_norm, 1.0 / 255.0, 1.0)
    R, G, B = R * scale, G * scale, B * scale

    T = 0.008856
    # Explicit linear combinations, NOT a 3x3 matmul: a default-precision
    # f32 matmul may round its operands (TF32 on the GPU), and XLA lowers the
    # single-pair vs vmapped-batched contraction differently, which would
    # perturb the Lab guide and break batched-vs-single flow parity.
    # Elementwise FMAs stay exact f32 in every batching mode.
    X = (0.412453 * R + 0.357580 * G + 0.180423 * B) / 0.950456
    Y = 0.212671 * R + 0.715160 * G + 0.072169 * B
    Z = (0.019334 * R + 0.119193 * G + 0.950227 * B) / 1.088754

    XT, YT, ZT = X > T, Y > T, Z > T
    # cube roots are safe for the sub-threshold branch too (values >= 0)
    cbrt = lambda t: jnp.cbrt(t)
    Y3 = cbrt(Y)
    fX = jnp.where(XT, cbrt(X), 7.787 * X + 16.0 / 116.0)
    fY = jnp.where(YT, Y3, 7.787 * Y + 16.0 / 116.0)
    fZ = jnp.where(ZT, cbrt(Z), 7.787 * Z + 16.0 / 116.0)

    L = jnp.where(YT, 116.0 * Y3 - 16.0, 903.3 * Y)
    a = 500.0 * (fX - fY)
    b = 200.0 * (fY - fZ)
    return jnp.stack([L, a, b], axis=2)
