"""Flow-field resampling between pyramid levels.

Matches reference ``warping.py:6-45``: bilinear resize with MATLAB's
coordinate convention, and — a parity-critical MATLAB quirk — both flow
components scaled by the *height* ratio.  Implemented as two resize
matmuls shared across the u and v channels.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from optical_flow_tpu.ops.interp import matlab_resize_matrix


@partial(jax.jit, static_argnums=(1,))
def resample_flow(uv, target_hw):
    """Resize (H, W, 2) flow to ``target_hw`` and scale magnitudes.

    The magnitude scale is ``new_H / H`` for *both* u and v
    (reference ``warping.py:28-29``).
    """
    H, W = uv.shape[:2]
    new_H, new_W = int(target_hw[0]), int(target_hw[1])
    if (H, W) == (new_H, new_W):
        return uv
    ratio = new_H / H
    Rh = jnp.asarray(matlab_resize_matrix(H, new_H), dtype=uv.dtype)
    Rw = jnp.asarray(matlab_resize_matrix(W, new_W), dtype=uv.dtype)
    out = jnp.einsum(
        "oi,ijc,pj->opc", Rh, uv, Rw, precision=jax.lax.Precision.HIGHEST
    )
    return out * ratio
