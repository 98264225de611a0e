"""Color-guided weighted median filtering — the non-local term.

Reference: ``utils/weighted_median.py`` — an O(H·W·p²·log p) per-pixel
Python loop.  Here the whole filter is one data-parallel program:

1. build the (H, W, P) patch stacks (P = (2·hsz+1)²) by shifting the
   reflect-padded fields — a static unrolled gather, no bounds checks;
2. compute color-affinity × occlusion weights elementwise;
3. per-pixel weighted median via a key-value ``lax.sort`` along the patch
   axis (value sorted, weight carried), inclusive cumsum, and a
   first-crossing select at half the total weight — precisely the
   sort+cumsum+searchsorted semantics of ``weighted_median_1d``
   (``weighted_median.py:5-21``).

For large images the rows are processed in static chunks to bound the
(H, W, P) intermediate footprint.

On the GPU, float32 calls run the Pallas kernel in
``ops/pallas/wmedian_kernel.py`` instead: the same selection by bisection
over order-preserving integer keys, with no patch stacks and no sort.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from optical_flow_tpu.ops.filters import median_filter2d

def _impl_for(H, W, hsz, C, dtype) -> str:
    """'pallas' (the GPU kernel) for float32 on the GPU when the patch fits
    its lane axis; 'sort' (the XLA path) otherwise."""
    if dtype != jnp.float32 or jax.default_backend() != "gpu":
        return "sort"
    from optical_flow_tpu.ops.pallas.wmedian_kernel import wmedian_pallas_ok

    return "pallas" if wmedian_pallas_ok(H, W, hsz, C) else "sort"


def _patch_stack(padded, H, W, k):
    """(H+2h, W+2h) padded -> (H, W, k*k) shifted views."""
    views = [
        padded[dy : dy + H, dx : dx + W] for dy in range(k) for dx in range(k)
    ]
    return jnp.stack(views, axis=-1)


def _weighted_median_lastaxis(values, weights):
    """Weighted median along the last axis (first index where cumw >= total/2)."""
    v_sorted, w_sorted = jax.lax.sort((values, weights), dimension=-1, num_keys=1)
    cumw = jnp.cumsum(w_sorted, axis=-1)
    total = cumw[..., -1:]
    # searchsorted(cumw, total/2, side='left'): first i with cumw[i] >= total/2
    idx = jnp.argmax(cumw >= total / 2.0, axis=-1)
    return jnp.take_along_axis(v_sorted, idx[..., None], axis=-1)[..., 0]


def weighted_median_1d(w, u):
    """Reference-compatible 1-D helper (``weighted_median.py:5-21``)."""
    return _weighted_median_lastaxis(jnp.asarray(u), jnp.asarray(w))


def denoise_color_weighted_medfilt2(
    uv,
    color_images,
    occ,
    area_hsz: int,
    mfsz,
    sigma_i: float,
    full_version: bool = False,
    row_chunk: int = 0,
):
    """Weighted median filter of the flow field guided by color affinity.

    ``color_images`` may be None (or statically too small, e.g. the
    (1, 1, 3) placeholder from the config table) — then a plain median
    filter of size ``mfsz`` is applied, matching the reference fallback
    (``weighted_median.py:42-47``).  ``full_version`` is accepted for API
    parity; like the reference implementation, it does not change the
    computation.
    """
    H, W = uv.shape[:2]
    if color_images is None or int(np.prod(color_images.shape[:2])) < H * W:
        sz = int(mfsz[0]) if hasattr(mfsz, "__len__") else int(mfsz)
        return jnp.stack(
            [
                median_filter2d(uv[:, :, 0], sz, "reflect"),
                median_filter2d(uv[:, :, 1], sz, "reflect"),
            ],
            axis=-1,
        )

    if color_images.shape[0] != H or color_images.shape[1] != W:
        from optical_flow_tpu.ops.interp import matlab_imresize_bilinear

        color_images = matlab_imresize_bilinear(color_images, (H, W))
    if color_images.ndim == 2:
        color_images = color_images[:, :, None]

    hsz = int(area_hsz)
    C = color_images.shape[2]

    # numpy-'reflect' (mirror, no edge duplication) — the reference pads with
    # np.pad(..., mode='reflect') here (weighted_median.py:78-84), which is
    # NOT the scipy.ndimage 'reflect' used by the plain median filters.
    u_pad = jnp.pad(uv[:, :, 0], hsz, mode="reflect")
    v_pad = jnp.pad(uv[:, :, 1], hsz, mode="reflect")
    occ_pad = jnp.pad(occ, hsz, mode="reflect")
    color_pad = jnp.pad(color_images, ((hsz, hsz), (hsz, hsz), (0, 0)), mode="reflect")

    if _impl_for(H, W, hsz, C, uv.dtype) == "pallas":
        from optical_flow_tpu.ops.pallas.wmedian_kernel import wmedian_pallas

        return wmedian_pallas(
            u_pad,
            v_pad,
            occ_pad,
            jnp.transpose(color_pad, (2, 0, 1)),
            (H, W),
            hsz,
            float(sigma_i),
        )

    return wmedfilt_prepadded(
        u_pad, v_pad, occ_pad, color_pad, color_images,
        H, W, hsz, float(sigma_i), row_chunk,
    )


def wmedfilt_prepadded(
    u_pad,
    v_pad,
    occ_pad,
    color_pad,
    color_center,
    H: int,
    W: int,
    hsz: int,
    sigma_i: float,
    row_chunk: int = 0,
):
    """Weighted median core on pre-padded fields (XLA-sort path).

    ``*_pad`` fields carry ``hsz`` boundary rows/columns (any fill — the
    caller owns the boundary convention; the single-device entry point uses
    numpy-'reflect', the row-sharded path supplies halo-exchanged strips).
    ``color_center`` is the unpadded (H, W, C) guide at the output pixels.
    Returns the (H, W, 2) filtered flow.
    """
    k = 2 * hsz + 1
    C = color_pad.shape[2]
    inv_2sigma2 = 1.0 / (2.0 * sigma_i**2)

    if row_chunk <= 0:
        # bound the (rows, W, k^2) patch-stack footprint to ~256 MB of f32.
        # Successive weighted-median calls are data-dependent, so one
        # image-sized stack at a time is the true peak; only images too
        # large for that (4K+) fall into the sequential lax.map path.
        budget = 64 * 1024 * 1024
        row_chunk = max(1, min(H, budget // max(1, W * k * k)))

    def chunk_median(r0, rows):
        """Weighted median for rows [r0, r0+rows); r0 may be traced."""
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, r0, rows + 2 * hsz, axis=0)
        up = _patch_stack(sl(u_pad), rows, W, k)
        vp = _patch_stack(sl(v_pad), rows, W, k)
        op = _patch_stack(sl(occ_pad), rows, W, k)
        cdiff = jnp.zeros_like(op)
        for c in range(C):
            cp = _patch_stack(sl(color_pad[:, :, c]), rows, W, k)
            center = jax.lax.dynamic_slice_in_dim(
                color_center[:, :, c], r0, rows, axis=0
            )[:, :, None]
            cdiff = cdiff + (cp - center) ** 2
        w = jnp.maximum(jnp.exp(-cdiff * inv_2sigma2) * op, 1e-10)
        return _weighted_median_lastaxis(up, w), _weighted_median_lastaxis(vp, w)

    if row_chunk >= H:
        u_out, v_out = chunk_median(0, H)
        return jnp.stack([u_out, v_out], axis=-1)

    # Sequential chunking via lax.map: one chunk's patch stacks live at a
    # time.  (A Python loop would emit independent subgraphs that XLA's
    # scheduler overlaps, multiplying peak device memory by the chunk count.)
    n_chunks = -(-H // row_chunk)
    pad_rows = n_chunks * row_chunk - H
    if pad_rows:
        u_pad = jnp.pad(u_pad, ((0, pad_rows), (0, 0)))
        v_pad = jnp.pad(v_pad, ((0, pad_rows), (0, 0)))
        occ_pad = jnp.pad(occ_pad, ((0, pad_rows), (0, 0)), constant_values=1.0)
        color_pad = jnp.pad(color_pad, ((0, pad_rows), (0, 0), (0, 0)))
        color_center = jnp.pad(color_center, ((0, pad_rows), (0, 0), (0, 0)))

    u_out, v_out = jax.lax.map(
        lambda i: chunk_median(i * row_chunk, row_chunk), jnp.arange(n_chunks)
    )
    u_out = u_out.reshape(n_chunks * row_chunk, W)[:H]
    v_out = v_out.reshape(n_chunks * row_chunk, W)[:H]
    return jnp.stack([u_out, v_out], axis=-1)
