"""Occlusion detection from flow divergence + brightness constancy.

Reference: ``utils/occlusion.py``.  Pure shift arithmetic and a bilinear
(clamped) warp — one fused elementwise program.  Note the reference uses 0-based
coordinates here (unlike ``partial_deriv``), which this matches natively.
"""
from __future__ import annotations

import jax.numpy as jnp

from optical_flow_tpu.ops.interp import sample_bilinear


def detect_occlusion(uv, images, sigma_d: float = 0.3, sigma_i: float = 20.0):
    """Occlusion confidence in [0, 1]; higher = less occluded."""
    H, W = uv.shape[:2]
    u = uv[:, :, 0]
    v = uv[:, :, 1]

    # backward-difference divergence, zero at the leading edge
    dudx = jnp.zeros_like(u).at[:, 1:].set(u[:, 1:] - u[:, :-1])
    dvdy = jnp.zeros_like(v).at[1:, :].set(v[1:, :] - v[:-1, :])
    div = dudx + dvdy
    occ_div = jnp.exp(-(div**2) / (2.0 * sigma_d**2))

    nc = images.shape[2] // 2
    ygrid, xgrid = jnp.meshgrid(
        jnp.arange(H, dtype=uv.dtype), jnp.arange(W, dtype=uv.dtype), indexing="ij"
    )
    xq = xgrid + u
    yq = ygrid + v

    It = jnp.zeros_like(u)
    for c in range(nc):
        warp = sample_bilinear(images[:, :, nc + c], yq, xq, mode="nearest")
        It = It + jnp.abs(warp - images[:, :, c])
    It = It / nc

    occ_bc = jnp.exp(-(It**2) / (2.0 * sigma_i**2))
    return occ_div * occ_bc
