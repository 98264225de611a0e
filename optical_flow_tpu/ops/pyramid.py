"""Gaussian image pyramids with MATLAB-exact resampling.

The pyramid *shape schedule* is computed host-side from (H, W, n_levels,
ratio) — every level is a static shape, so each level's solve compiles once.
The smoothing + resize for one level is a fused XLA program: a small
shift-accumulate Gaussian followed by two resize matmuls.

Reference behavior reproduced: ``pyramid.py:44-73`` (smooth with
``fspecial`` Gaussian, reflect boundary, then ``imresize`` bilinear with
Antialiasing=false and half-away-from-zero output-size rounding) and
``base.py:174-195`` (filter sigma = sqrt(spacing)/sqrt(2), ksize =
2*round(1.5 sigma)+1, auto level count 1 + floor(log(min_dim/16)/log(spacing))).
"""
from __future__ import annotations

from functools import partial
from typing import List, Tuple

import numpy as np
import jax

from optical_flow_tpu.ops.filters import correlate2d_multi
from optical_flow_tpu.ops.interp import matlab_imresize_bilinear
from optical_flow_tpu.utils.compat import fspecial_gaussian, matlab_round


def pyramid_shapes(hw: Tuple[int, int], n_levels: int, ratio: float) -> List[Tuple[int, int]]:
    """Static shape ladder, index 0 = finest (input size)."""
    shapes = [(int(hw[0]), int(hw[1]))]
    for _ in range(1, n_levels):
        H, W = shapes[-1]
        shapes.append((max(1, matlab_round(H * ratio)), max(1, matlab_round(W * ratio))))
    return shapes


def auto_pyramid_levels(hw: Tuple[int, int], spacing: float) -> int:
    """1 + floor(log(min_dim/16)/log(spacing))  (reference ``base.py:192-195``)."""
    min_dim = min(hw[0], hw[1])
    return 1 + int(np.floor(np.log(min_dim / 16.0) / np.log(spacing)))


def pyramid_filter(spacing: float) -> np.ndarray:
    """Gaussian smoothing kernel for one pyramid step (``base.py:185-188``)."""
    smooth_sigma = np.sqrt(spacing) / np.sqrt(2.0)
    ksize = 2 * int(round(1.5 * smooth_sigma)) + 1
    return fspecial_gaussian(int(ksize), smooth_sigma)


def compute_image_pyramid(img, f: np.ndarray, n_levels: int, ratio: float):
    """Build the Gaussian pyramid: smooth (reflect) then MATLAB resize.

    ``img`` is (H, W) or (H, W, C); returns a list of arrays, finest first.
    """
    shapes = pyramid_shapes(img.shape[:2], n_levels, ratio)
    pyramid = [img]
    current = img
    for lvl in range(1, n_levels):
        smoothed = correlate2d_multi(current, f, boundary="reflect")
        current = matlab_imresize_bilinear(smoothed, shapes[lvl])
        pyramid.append(current)
    return pyramid


@partial(jax.jit, static_argnums=(1, 2))
def _pyramid_step(img, spacing: float, out_hw):
    """One fused smooth+resize level, compiled per (shape, spacing)."""
    f = pyramid_filter(spacing)
    smoothed = correlate2d_multi(img, f, boundary="reflect")
    return matlab_imresize_bilinear(smoothed, out_hw)


def build_pyramid(images, levels: int, spacing: float):
    """Reference ``BaseOpticalFlow._build_pyramid`` equivalent.

    Each level is one jitted program (the 25-tap Gaussian + two resize
    matmuls fuse into a single dispatch — essential when the host↔device
    link is high-latency).
    """
    shapes = pyramid_shapes(images.shape[:2], levels, 1.0 / spacing)
    pyramid = [images]
    current = images
    for lvl in range(1, levels):
        current = _pyramid_step(current, float(spacing), shapes[lvl])
        pyramid.append(current)
    return pyramid


@partial(jax.jit, static_argnums=(1, 2, 3, 4))
def pyramid_pair(images, levels: int, spacing: float, gnc_levels: int, gnc_spacing: float):
    """Both pyramid ladders (main + GNC) of an image in ONE device program."""
    return (
        tuple(build_pyramid(images, levels, spacing)),
        tuple(build_pyramid(images, gnc_levels, gnc_spacing)),
    )
