"""ROF structure–texture decomposition (Chambolle primal–dual).

Reference: ``image_processing.py:52-136``.  This formulation keeps the
dual field ``p`` as loop-carried state in a ``lax.fori_loop`` whose body is
a single fused elementwise program (divergence, gradient, reprojection are
all shift-arithmetic — XLA fuses the whole iteration, so the 100 iterations
never round-trip intermediates through device memory between ops).

Parity notes: the input is normalized to [-1, 1] *globally across channels*
(``image_processing.py:71``), and the texture is ``norm - alp*structure``
rescaled to [0, 255].
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from optical_flow_tpu.utils.compat import scale_image


def _divergence(p):
    """Backward-difference divergence with zero boundary (H, W, 2) -> (H, W).

    Written as shift-and-subtract (concat of slices), NOT ``.at[]`` scatters:
    scatters lower to the slow generic path once batched (vmap turns them
    into real scatter HLOs), while slices/concats stay fused elementwise code.
    """
    px, py = p[:, :, 0], p[:, :, 1]
    px_shift = jnp.concatenate([jnp.zeros_like(px[:, :1]), px[:, :-1]], axis=1)
    py_shift = jnp.concatenate([jnp.zeros_like(py[:1, :]), py[:-1, :]], axis=0)
    return (px - px_shift) + (py - py_shift)


def _gradient(u):
    """Forward-difference gradient, zero at far boundary (H, W) -> (H, W, 2)."""
    gx = jnp.concatenate([u[:, 1:] - u[:, :-1], jnp.zeros_like(u[:, :1])], axis=1)
    gy = jnp.concatenate([u[1:, :] - u[:-1, :], jnp.zeros_like(u[:1, :])], axis=0)
    return jnp.stack([gx, gy], axis=-1)


def rof_structure_2d(im, theta: float = 1.0 / 8, n_iters: int = 100):
    """Structure (denoised) component of a single-channel image."""
    delta = 1.0 / (4.0 * theta)

    def body(_, p):
        u = im + theta * _divergence(p)
        p = p + delta * _gradient(u)
        norm_p = jnp.maximum(jnp.sqrt(p[:, :, 0] ** 2 + p[:, :, 1] ** 2), 1.0)
        return p / norm_p[:, :, None]

    p0 = jnp.zeros((*im.shape, 2), dtype=im.dtype)
    p = jax.lax.fori_loop(0, n_iters, body, p0)
    return im + theta * _divergence(p)


@partial(jax.jit, static_argnums=(1, 2, 3))
def structure_texture_decomposition_rof(im, theta=1.0 / 8, n_iters=100, alp=0.95):
    """Texture component of ``im`` ((H, W) or (H, W, C)), scaled to [0, 255].

    Jitted per shape: the full 100-iteration primal-dual loop plus the
    global rescales run as one device program.
    """
    im = jnp.asarray(im)
    im_norm = scale_image(im, -1, 1)

    rof2d = lambda x: rof_structure_2d(x, theta, n_iters)
    if im_norm.ndim == 3:
        structure = jnp.stack(
            [rof2d(im_norm[:, :, c]) for c in range(im_norm.shape[2])],
            axis=2,
        )
    else:
        structure = rof2d(im_norm)
    return scale_image(im_norm - alp * structure, 0, 255)
