"""Small-stencil correlation filters as fused shift-accumulate programs.

The reference leans on ``scipy.ndimage.correlate`` (C loops over host
arrays).  Here a k×k correlation with a *constant* kernel is expressed as a
sum of shifted multiplies over a padded array: XLA fuses the whole thing
into one elementwise loop, and there is no conv layout/IM2COL overhead for the tiny
single-channel images involved.  Kernels are numpy constants at trace time, so
zero taps are skipped for free.

Boundary names follow scipy.ndimage: ``reflect`` (edge value included —
numpy ``symmetric``) and ``nearest`` (numpy ``edge``), matching the use sites
in the reference (``derivatives.py``, ``pyramid.py``, ``image_processing.py``).
"""
from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

_PAD_MODE = {
    "reflect": "symmetric",  # scipy 'reflect'  == numpy 'symmetric'
    "nearest": "edge",  # scipy 'nearest'  == numpy 'edge'
    "mirror": "reflect",  # scipy 'mirror'   == numpy 'reflect'
    "constant": "constant",
}


def correlate2d(im, kernel, boundary: str = "reflect"):
    """2-D correlation with a constant kernel, scipy.ndimage semantics.

    ``im`` is (H, W); ``kernel`` a numpy array (any 2-D shape, possibly 1×k
    or k×1).  The kernel origin matches ``scipy.ndimage.correlate`` —
    centered, with ties toward the upper-left for even sizes.
    """
    kernel = np.atleast_2d(np.asarray(kernel))
    kh, kw = kernel.shape
    # scipy.ndimage origin: center at (kh//2, kw//2)
    cy, cx = kh // 2, kw // 2
    pad_t, pad_b = cy, kh - 1 - cy
    pad_l, pad_r = cx, kw - 1 - cx
    padded = jnp.pad(im, ((pad_t, pad_b), (pad_l, pad_r)), mode=_PAD_MODE[boundary])
    H, W = im.shape
    out = jnp.zeros_like(im)
    for dy in range(kh):
        for dx in range(kw):
            # python-float weight: weakly typed, never promotes f32 inputs
            w = float(kernel[dy, dx])
            if w == 0.0:
                continue
            out = out + w * padded[dy : dy + H, dx : dx + W]
    return out


def correlate2d_multi(im, kernel, boundary: str = "reflect"):
    """Channel-wise :func:`correlate2d` for (H, W) or (H, W, C) inputs."""
    if im.ndim == 2:
        return correlate2d(im, kernel, boundary)
    chans = [correlate2d(im[:, :, c], kernel, boundary) for c in range(im.shape[2])]
    return jnp.stack(chans, axis=2)


@functools.lru_cache(maxsize=None)
def _batcher_pairs(m: int):
    """Comparator list of Batcher's odd-even mergesort for size m (power of 2)."""
    pairs = []
    p = 1
    while p < m:
        k = p
        while k >= 1:
            for j in range(k % p, m - k, 2 * k):
                for i in range(0, min(k, m - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return tuple(pairs)


@functools.lru_cache(maxsize=None)
def _median_network(n: int):
    """Min/max network selecting order statistic ``n//2`` of n inputs.

    Batcher's network on the next power of two (inputs n..m-1 padded +inf,
    which sort past every real value), pruned by backward reachability to
    the comparators that can influence the median lane.  For n=25 this is
    153 comparators (vs 191 for the full sort of 32); XLA fuses the min/max
    chain into one elementwise pass over the window views instead of
    sorting a materialized (H, W, k²) stack.
    """
    m = 1
    while m < n:
        m *= 2
    target = n // 2  # +inf tail padding keeps real order statistics in place
    needed = {target}
    kept = []
    for a, b in reversed(_batcher_pairs(m)):
        if a in needed or b in needed:
            kept.append((a, b))
            needed.add(a)
            needed.add(b)
    kept.reverse()
    return tuple(kept), m, target


def _scrub_nans(x):
    """Map NaN → +inf (see ``_median_lastaxis_views`` NaN semantics).

    Apply to the PADDED parent array before taking window views: one pass
    over the parent that XLA materializes once, instead of scrubbing each
    of the k² views.
    """
    if not np.issubdtype(np.dtype(x.dtype), np.floating):
        return x
    return jnp.where(jnp.isnan(x), np.dtype(x.dtype).type(np.inf), x)


def _median_lastaxis_views(views, n: int, dtype, scrubbed: bool = False):
    """Median (rank n//2) across a list of same-shape arrays via the network.

    NaN semantics match ``jnp.sort`` (NaNs placed LAST): min/max propagate
    NaN, so feeding NaNs straight into the network would turn one bad pixel
    into a k×k NaN patch per application — whereas the sort path self-heals
    isolated solver NaNs (a finite value holds rank n//2 unless more than
    half the window is NaN).  NaNs are therefore pushed past every real
    value before the network (``scrubbed=True`` promises the caller already
    ran :func:`_scrub_nans` on the views' parent), and the output is NaN
    exactly where the rank lands in the NaN tail, as the sort would produce.
    """
    pairs, m, target = _median_network(n)
    floating = np.issubdtype(np.dtype(dtype), np.floating)
    if floating:
        pad_val = np.dtype(dtype).type(np.inf)
        if not scrubbed:
            views = [jnp.where(jnp.isnan(v), pad_val, v) for v in views]
    else:
        pad_val = np.iinfo(np.dtype(dtype)).max
    vals = list(views) + [jnp.full(views[0].shape, pad_val, dtype)] * (m - n)
    for a, b in pairs:
        lo = jnp.minimum(vals[a], vals[b])
        hi = jnp.maximum(vals[a], vals[b])
        vals[a], vals[b] = lo, hi
    out = vals[target]
    if floating:
        # sort places NaNs after +inf: rank n//2 is NaN iff fewer than
        # target+1 non-NaN values exist — and with NaNs mapped to +inf that
        # is exactly when the selected value is +inf (the m-n +inf pad
        # lanes can never reach rank target < n).  Caveat: a REAL +inf
        # input holding rank n//2 also maps to NaN — flow/image data is
        # finite, and sort-vs-network parity on finite+NaN data is exact.
        out = jnp.where(out == pad_val, jnp.nan, out)
    return out


def _median_views_scrubbed(padded, H, W, kh, kw):
    """Window views + network median with the parent scrubbed ONCE."""
    padded = _scrub_nans(padded)
    views = [
        padded[dy : dy + H, dx : dx + W] for dy in range(kh) for dx in range(kw)
    ]
    return _median_lastaxis_views(views, kh * kw, padded.dtype, scrubbed=True)


def median_filter2d(im, size, boundary: str = "reflect"):
    """Median filter with odd window ``size`` (int or (h, w)).

    Equivalent to ``scipy.ndimage.median_filter(im, size, mode='reflect')``
    for odd sizes (rank ``k²//2`` matches scipy for even sizes too).  Small
    windows (≤ 7×7) select the median through a pruned Batcher min/max
    network — one fused elementwise pass instead of sorting a
    (H, W, k²) stack; larger windows keep the sort.  Both paths place NaNs
    last (see ``_median_lastaxis_views``), so isolated solver NaNs are
    scrubbed by each median pass rather than spread.
    """
    if isinstance(size, (tuple, list, np.ndarray)):
        kh, kw = int(size[0]), int(size[1])
    else:
        kh = kw = int(size)
    cy, cx = kh // 2, kw // 2
    padded = jnp.pad(im, ((cy, kh - 1 - cy), (cx, kw - 1 - cx)), mode=_PAD_MODE[boundary])
    H, W = im.shape
    n = kh * kw
    if n <= 49:
        return _median_views_scrubbed(padded, H, W, kh, kw)
    views = [
        padded[dy : dy + H, dx : dx + W] for dy in range(kh) for dx in range(kw)
    ]
    stack = jnp.stack(views, axis=-1)
    sorted_stack = jnp.sort(stack, axis=-1)
    # rank n//2 matches scipy.ndimage.median_filter for odd and even sizes
    return sorted_stack[..., n // 2]
