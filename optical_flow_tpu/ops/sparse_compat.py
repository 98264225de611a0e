"""Explicit convolution-operator matrices (compatibility shims).

The framework never materializes sparse filter matrices — the spatial
term lives as a matrix-free stencil (:mod:`optical_flow_tpu.ops.stencil`).
These host-side helpers exist for users of the reference API
(``utils/sparse_ops.py``) who inspect the operators directly, and for
verification: they build the same linear maps by *applying the filter to
basis-indexed index grids* rather than assembling tap lists.

All functions return dense numpy arrays (column-major / Fortran pixel
ordering like MATLAB) — adequate for the small grids where explicit
operators are useful at all.
"""
from __future__ import annotations

import numpy as np


def _fortran_index(i, j, H):
    return j * H + i


def convmtxn(F, sz) -> np.ndarray:
    """Dense matrix M with M @ vec_F(x) = vec_F(conv2(x, F, 'full'))."""
    F = np.atleast_2d(np.asarray(F, dtype=float))
    fh, fw = F.shape
    H, W = int(sz[0]), int(sz[1])
    oh, ow = H + fh - 1, W + fw - 1
    M = np.zeros((oh * ow, H * W))
    for a in range(fh):
        for b in range(fw):
            v = F[a, b]
            if v == 0.0:
                continue
            for i in range(H):
                for j in range(W):
                    M[_fortran_index(i + a, j + b, oh), _fortran_index(i, j, H)] += v
    return M


def make_convn_mat(F, sz, shape: str = "full", pad=None) -> np.ndarray:
    """Convolution matrix with 'full' / 'same' / 'valid' (+ 'sameswap' pad).

    'sameswap' embeds the valid-size output back into a same-size vector at
    the half-filter offset — the form the reference feeds the spatial term
    (``sparse_ops.py:90-110``).
    """
    F = np.atleast_2d(np.asarray(F, dtype=float))
    fh, fw = F.shape
    H, W = int(sz[0]), int(sz[1])
    M = convmtxn(F, sz)
    oh, ow = H + fh - 1, W + fw - 1

    def rows_for(region_h, region_w, off_i, off_j):
        rows = []
        for j in range(region_w):
            for i in range(region_h):
                rows.append(_fortran_index(i + off_i, j + off_j, oh))
        return rows

    if shape == "full":
        return M
    if shape == "same":
        return M[rows_for(H, W, (fh - 1) // 2, (fw - 1) // 2)]
    if shape == "valid":
        vh, vw = H - fh + 1, W - fw + 1
        if vh <= 0 or vw <= 0:
            return np.zeros((0, H * W))
        Mv = M[rows_for(vh, vw, fh - 1, fw - 1)]
        if pad != "sameswap":
            return Mv
        out = np.zeros((H * W, H * W))
        oi, oj = (fh - 1) // 2, (fw - 1) // 2
        for j in range(vw):
            for i in range(vh):
                out[_fortran_index(i + oi, j + oj, H)] = Mv[_fortran_index(i, j, vh)]
        return out
    raise ValueError(f"Unknown shape: {shape}")


def make_imfilter_mat(F, sz, boundary: str = "replicate", shape: str = "same") -> np.ndarray:
    """Correlation (imfilter) matrix with boundary handling.

    Boundaries: 'replicate' (clamp), '0' (zero), 'symmetric' (mirror with
    edge duplication) — reference ``sparse_ops.py:128-220``.
    """
    F = np.atleast_2d(np.asarray(F, dtype=float))
    fh, fw = F.shape
    H, W = int(sz[0]), int(sz[1])
    ci, cj = (fh - 1) // 2, (fw - 1) // 2
    M = np.zeros((H * W, H * W))

    def resolve(idx, n):
        if boundary == "replicate":
            return min(max(idx, 0), n - 1)
        if boundary == "symmetric":
            if idx < 0:
                idx = -idx - 1
            if idx >= n:
                idx = 2 * n - idx - 1
            return min(max(idx, 0), n - 1)
        return idx if 0 <= idx < n else None  # '0'

    for a in range(fh):
        for b in range(fw):
            v = F[a, b]
            if v == 0.0:
                continue
            for i in range(H):
                for j in range(W):
                    si = resolve(i + a - ci, H)
                    sj = resolve(j + b - cj, W)
                    if si is None or sj is None:
                        continue
                    M[_fortran_index(i, j, H), _fortran_index(si, sj, H)] += v
    return M
