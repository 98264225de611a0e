"""Matrix-free flow linear systems as coupled 5-point stencils.

The reference assembles an explicit sparse (2HW, 2HW) matrix per IRLS step
(``sparse_ops.py`` + ``bmat`` + ``spsolve``).  Structurally that matrix is

    A = [[ D_uu + lam * Fᵀ W_u F ,  D_uv                  ],
         [ D_uv                  ,  D_vv + lam * Fᵀ W_v F ]]

where D_* are per-pixel diagonals from the linearized data term and
``Fᵀ W F`` — with F the forward-difference filters ``[[1,-1]]`` and
``[[1],[-1]]`` in 'valid'+'sameswap' form (``sparse_ops.py:59-118``) — is an
edge-weighted 4-neighbor graph Laplacian.  (The Horn–Schunck Laplacian with
replicate boundary, ``hs.py:168-169``, is the same operator with unit edge
weights: the Neumann graph Laplacian.)

So the whole system is represented here by small dense coefficient fields
(:class:`FlowSystem`) and applied matrix-free as one fused stencil — the
natural accelerator formulation: O(HW) memory instead of O(HW · nnz), every
apply a single fused elementwise pass, and trivially shard-able over an image-tiled device mesh
(halo radius 1).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class FlowSystem(NamedTuple):
    """Coefficients of the coupled system ``A @ x = b`` over a (H, W) grid.

    a11, a12, a22 : per-pixel 2x2 data-term block (plus any diagonal
        coupling term folded in).
    wu_h, wu_v, wv_h, wv_v : edge weights (already scaled by lambda) for the
        u- and v-field Laplacians.  ``w*_h[i, j]`` weights the edge
        (i,j)-(i,j+1) and must be 0 in the last column; ``w*_v[i, j]``
        weights (i,j)-(i+1,j) and must be 0 in the last row.
    b_u, b_v : right-hand side fields.
    """

    a11: jnp.ndarray
    a12: jnp.ndarray
    a22: jnp.ndarray
    wu_h: jnp.ndarray
    wu_v: jnp.ndarray
    wv_h: jnp.ndarray
    wv_v: jnp.ndarray
    b_u: jnp.ndarray
    b_v: jnp.ndarray


def forward_diff_h(x):
    """``x[i, j+1] - x[i, j]`` stored at (i, j); 0 in the last column.

    Equals the reference's 'valid'+'sameswap' convolution with ``[[1,-1]]``.
    """
    out = jnp.zeros_like(x)
    return out.at[:, :-1].set(x[:, 1:] - x[:, :-1])


def forward_diff_v(x):
    """``x[i+1, j] - x[i, j]`` stored at (i, j); 0 in the last row."""
    out = jnp.zeros_like(x)
    return out.at[:-1, :].set(x[1:, :] - x[:-1, :])


def weighted_laplacian_apply(w_h, w_v, x):
    """Apply ``Fᵀ diag(w) F`` (4-neighbor edge-weighted Laplacian) to ``x``."""
    zero_col = jnp.zeros((x.shape[0], 1), dtype=x.dtype)
    zero_row = jnp.zeros((1, x.shape[1]), dtype=x.dtype)
    # eh[i,j] = w_h[i,j] * (x[i,j] - x[i,j+1]);  last column is 0 by construction
    eh = w_h * (x - jnp.concatenate([x[:, 1:], zero_col], axis=1))
    ev = w_v * (x - jnp.concatenate([x[1:, :], zero_row], axis=0))
    out = eh + ev
    out = out - jnp.concatenate([zero_col, eh[:, :-1]], axis=1)
    out = out - jnp.concatenate([zero_row, ev[:-1, :]], axis=0)
    return out


def weighted_laplacian_diag(w_h, w_v):
    """Diagonal of ``Fᵀ diag(w) F``: sum of incident edge weights."""
    zero_col = jnp.zeros((w_h.shape[0], 1), dtype=w_h.dtype)
    zero_row = jnp.zeros((1, w_v.shape[1]), dtype=w_v.dtype)
    left = jnp.concatenate([zero_col, w_h[:, :-1]], axis=1)
    up = jnp.concatenate([zero_row, w_v[:-1, :]], axis=0)
    return w_h + left + w_v + up


def system_apply(sys: FlowSystem, x):
    """``A @ x`` for ``x`` of shape (H, W, 2)."""
    yu, yv = system_apply_split(sys, x[:, :, 0], x[:, :, 1])
    return jnp.stack([yu, yv], axis=-1)


def system_apply_split(sys: FlowSystem, xu, xv):
    """``A @ x`` with channel-split state: two (H, W) planes in and out.

    Identical math to :func:`system_apply` minus the stack/unstack — the
    layout the channel-split CG (``solvers/cg.py::pcg_solve_split``) keeps
    its whole state in.
    """
    yu = sys.a11 * xu + sys.a12 * xv + weighted_laplacian_apply(sys.wu_h, sys.wu_v, xu)
    yv = sys.a12 * xu + sys.a22 * xv + weighted_laplacian_apply(sys.wv_h, sys.wv_v, xv)
    return yu, yv


def system_diag(sys: FlowSystem):
    """diag(A) as (H, W, 2) — the Jacobi preconditioner."""
    du = sys.a11 + weighted_laplacian_diag(sys.wu_h, sys.wu_v)
    dv = sys.a22 + weighted_laplacian_diag(sys.wv_h, sys.wv_v)
    return jnp.stack([du, dv], axis=-1)


def system_rhs(sys: FlowSystem):
    return jnp.stack([sys.b_u, sys.b_v], axis=-1)


def blend_systems(alpha, sys_q: FlowSystem, sys_r: FlowSystem) -> FlowSystem:
    """GNC blend ``alpha * A_quadratic + (1 - alpha) * A_robust``.

    Because both operands share the same stencil structure, blending the
    coefficient fields is exactly the reference's sparse-matrix blend
    (``ba.py:172-182``).
    """
    return FlowSystem(
        *[alpha * q + (1.0 - alpha) * r for q, r in zip(sys_q, sys_r)]
    )


# ---------------------------------------------------------------------------
# system builders
# ---------------------------------------------------------------------------


def _channel_mean(x):
    return jnp.mean(x, axis=2) if x.ndim == 3 else x


def build_irls_system(
    uv,
    duv,
    It,
    Ix,
    Iy,
    rho_spatial_u,
    rho_spatial_v,
    rho_data,
    lam,
) -> FlowSystem:
    """IRLS linear system for the BA / Classic+NL / Alt-BA family.

    Mirrors ``ba.py:208-302`` / ``classic_nl.py:279-378``: spatial IRLS
    weights from the filtered ``uv + duv`` (forward differences), linearized
    data term ``It + Ix du + Iy dv`` with channel-mean reduction of the
    per-channel weights and products.

    ``rho_spatial_u/v`` are pairs of :class:`~optical_flow_tpu.ops.penalties.Robust`
    for the (horizontal, vertical) filters; ``lam`` is folded into the edge
    weights and the RHS here.
    """
    u = uv[:, :, 0]
    v = uv[:, :, 1]
    up = u + duv[:, :, 0]
    vp = v + duv[:, :, 1]

    # spatial term: IRLS weights per edge (forward differences)
    wu_h = rho_spatial_u[0].deriv_over_x(forward_diff_h(up))
    wu_v = rho_spatial_u[1].deriv_over_x(forward_diff_v(up))
    wv_h = rho_spatial_v[0].deriv_over_x(forward_diff_h(vp))
    wv_v = rho_spatial_v[1].deriv_over_x(forward_diff_v(vp))
    # zero the dangling edges (rows of F that are identically zero)
    mask_h = jnp.ones_like(wu_h).at[:, -1].set(0.0)
    mask_v = jnp.ones_like(wu_v).at[-1, :].set(0.0)
    wu_h = lam * wu_h * mask_h
    wv_h = lam * wv_h * mask_h
    wu_v = lam * wu_v * mask_v
    wv_v = lam * wv_v * mask_v

    # data term (channel-aware)
    if It.ndim == 3:
        It_lin = It + Ix * duv[:, :, 0:1] + Iy * duv[:, :, 1:2]
    else:
        It_lin = It + Ix * duv[:, :, 0] + Iy * duv[:, :, 1]
    pp_d = _channel_mean(rho_data.deriv_over_x(It_lin))
    Ix2 = _channel_mean(Ix**2)
    Iy2 = _channel_mean(Iy**2)
    Ixy = _channel_mean(Ix * Iy)
    Itx = _channel_mean(It_lin * Ix)
    Ity = _channel_mean(It_lin * Iy)

    a11 = pp_d * Ix2
    a12 = pp_d * Ixy
    a22 = pp_d * Iy2
    b_u = -weighted_laplacian_apply(wu_h, wu_v, u) - pp_d * Itx
    b_v = -weighted_laplacian_apply(wv_h, wv_v, v) - pp_d * Ity

    return FlowSystem(a11, a12, a22, wu_h, wu_v, wv_h, wv_v, b_u, b_v)


def build_hs_system(uv, It, Ix, Iy, lam, sigmaD2, sigmaS2) -> FlowSystem:
    """Horn–Schunck system (``hs.py:144-203``).

    ``A = D/sigmaD2 + (lam/sigmaS2) * blkdiag(L, L)`` with L the Neumann
    graph Laplacian (= minus the replicate-boundary Laplacian stencil), and
    ``b = -(lam/sigmaS2) L uv - [Itx; Ity]/sigmaD2``.
    """
    Ix2 = _channel_mean(Ix**2) / sigmaD2
    Iy2 = _channel_mean(Iy**2) / sigmaD2
    Ixy = _channel_mean(Ix * Iy) / sigmaD2
    Itx = _channel_mean(It * Ix) / sigmaD2
    Ity = _channel_mean(It * Iy) / sigmaD2

    w_edge = lam / sigmaS2
    ones = jnp.ones_like(Ix2)
    wh = (w_edge * ones).at[:, -1].set(0.0)
    wv = (w_edge * ones).at[-1, :].set(0.0)

    u = uv[:, :, 0]
    v = uv[:, :, 1]
    b_u = -weighted_laplacian_apply(wh, wv, u) - Itx
    b_v = -weighted_laplacian_apply(wh, wv, v) - Ity

    return FlowSystem(Ix2, Ixy, Iy2, wh, wv, wh, wv, b_u, b_v)


def add_coupling(sys: FlowSystem, weight) -> FlowSystem:
    """Add a per-pixel diagonal coupling term ``weight`` (H, W, 2) to A.

    Used by Alt-BA (``alt_ba.py:236-242``); the matching RHS update is done
    by the caller.
    """
    return sys._replace(
        a11=sys.a11 + weight[:, :, 0],
        a22=sys.a22 + weight[:, :, 1],
    )
