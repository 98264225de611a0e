"""Distributed matrix-free CG over a row-sharded image grid.

The flow system's stencil structure makes the distributed solver cheap:
one radius-1 halo exchange (``ppermute``) per operator apply, and
``psum``-reduced inner products — the Schur-complement-free analog of the
reference's global ``spsolve`` (which cannot scale at all, SURVEY §5).

Functions suffixed ``_local`` expect to run *inside* ``shard_map`` with the
leading (H) axis sharded over ``axis_name``; ``solve_flow_system_sharded``
is the host-callable wrapper.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map

from optical_flow_tpu.ops.stencil import (
    FlowSystem,
    weighted_laplacian_apply,
    weighted_laplacian_diag,
)
from optical_flow_tpu.parallel.halo import halo_exchange_rows, halo_exchange_rows_multi
from optical_flow_tpu.parallel.mesh import SPACE_AXIS
from optical_flow_tpu.solvers.cg import (
    _check_algo,
    pcg_solve_split,
    pcg_solve_split_gear,
)


def _zero_row_pad(x):
    return jnp.pad(x, ((1, 1), (0, 0)))


def sharded_laplacian_apply_local(w_h, w_v, x, axis_name: str):
    """Edge-weighted Laplacian on a row-sharded block (radius-1 halo)."""
    x_e = halo_exchange_rows(x, 1, axis_name)
    wv_e = halo_exchange_rows(w_v, 1, axis_name)
    # halo rows of w_h never influence the cropped interior rows
    out_e = weighted_laplacian_apply(_zero_row_pad(w_h), wv_e, x_e)
    return out_e[1:-1]


def sharded_laplacian_diag_local(w_h, w_v, axis_name: str):
    wv_e = halo_exchange_rows(w_v, 1, axis_name)
    diag_e = weighted_laplacian_diag(_zero_row_pad(w_h), wv_e)
    return diag_e[1:-1]


def solve_flow_system_local(
    sys: FlowSystem,
    axis_name: str = SPACE_AXIS,
    rtol: float = 1e-3,
    maxiter: int = 200,
    x0=None,
    sync_axes=(),
    algo: str | None = None,
):
    """PCG on a row-sharded FlowSystem; call inside ``shard_map``.

    CHANNEL-SPLIT, like the single-chip path: the CG state is (u, v) plane
    pairs, not a trailing-dim-2 stack (``solvers/cg.py::pcg_solve_split``
    has the layout argument).
    The mesh path pays no extra collectives for the split:

    * the loop-invariant vertical edge weights (wu_v, wv_v) are
      halo-extended ONCE before the loop — the old stacked path re-exchanged
      them inside every operator apply;
    * per apply, the (xu, xv) boundary strips travel in ONE stacked
      ``ppermute`` pair (:func:`~optical_flow_tpu.parallel.halo.halo_exchange_rows_multi`).

    Net per-iteration collective count drops 8 ppermutes -> 2 vs the r4
    stacked path, plus the psum rounds (3 classic / 1 gear, HLO-pinned in
    ``test_parallel.py``).

    ``algo='gear'`` uses the Chronopoulos–Gear recurrence so the three
    per-iteration scalars reduce in ONE stacked ``psum`` instead of
    classic PCG's three collective rounds (p·Ap / r·z / stopping ‖r‖²);
    ``algo='cheby'`` drops the per-iteration collectives to ZERO
    (Chebyshev semi-iteration, one psum per 16-iteration stopping block +
    a one-time Lanczos bounds pass) at ~1.9× the iteration count
    (``solvers/chebyshev.py``).
    On a latency-dominated fabric the per-iteration collective count
    (3 / 1 / 1-per-16) is what scales; on one device both cost more than
    classic.  ``benchmarks/multihost.py`` A/Bs the three on a 2-process
    CPU runtime.
    Default follows ``OFTPU_CG_ALGO`` ('classic' unless set:
    same-recurrence-everywhere keeps sharded-vs-single-device parity at
    the 1e-8 the test suite pins).
    """
    if algo is None:
        from optical_flow_tpu.solvers.cg import CG_ALGO

        algo = CG_ALGO
    _check_algo(algo)
    # loop-invariant weight halos: exchanged once, one stacked ppermute pair
    wu_v_e, wv_v_e = halo_exchange_rows_multi([sys.wu_v, sys.wv_v], 1, axis_name)
    wu_h_p = _zero_row_pad(sys.wu_h)
    wv_h_p = _zero_row_pad(sys.wv_h)
    du = sys.a11 + weighted_laplacian_diag(wu_h_p, wu_v_e)[1:-1]
    dv = sys.a22 + weighted_laplacian_diag(wv_h_p, wv_v_e)[1:-1]

    def apply_A(xu, xv):
        xu_e, xv_e = halo_exchange_rows_multi([xu, xv], 1, axis_name)
        yu = sys.a11 * xu + sys.a12 * xv + weighted_laplacian_apply(
            wu_h_p, wu_v_e, xu_e
        )[1:-1]
        yv = sys.a12 * xu + sys.a22 * xv + weighted_laplacian_apply(
            wv_h_p, wv_v_e, xv_e
        )[1:-1]
        return yu, yv

    # a12 is per-pixel local: the block-Jacobi preconditioner shards freely
    x0_split = None if x0 is None else (x0[..., 0], x0[..., 1])
    # shared psum-reduced dot for the classic and cheby recurrences (gear
    # folds its three scalars into one stacked psum instead)
    dot2 = lambda au, av, bu_, bv_: lax.psum(
        jnp.sum(au * bu_) + jnp.sum(av * bv_), axis_name
    )
    if algo == "cheby":
        from optical_flow_tpu.solvers.cg import _block_jacobi_split
        from optical_flow_tpu.solvers.chebyshev import (
            cheby_solve_split,
            lanczos_bounds_split,
        )

        precond = _block_jacobi_split(du, dv, sys.a12)
        # bounds: 12 Lanczos steps with psum'd dots (once per solve); the
        # small eigvalsh is replicated per shard — identical inputs,
        # identical program, identical scalars on every shard
        lo, hi = lanczos_bounds_split(
            apply_A, precond, sys.b_u, sys.b_v, k=12, dot2=dot2
        )
        # 4x the caller's maxiter, mirroring the single-chip cheby path
        # (solvers/cg.py): the minimax polynomial needs ~1.9x CG's
        # iterations plus K-block rounding — an unscaled budget would
        # truncate at the CG-sized cap and silently return an
        # unconverged solution
        xu, xv = cheby_solve_split(
            apply_A, sys.b_u, sys.b_v, du, dv, lo, hi, rtol, 4 * maxiter,
            a12=sys.a12, x0=x0_split, dot2=dot2, sync_axes=sync_axes,
        )
    elif algo == "gear":

        def dots3(ru, rv, uu, uv, wu, wv):
            partial_sums = jnp.stack(
                [
                    jnp.sum(ru * uu) + jnp.sum(rv * uv),
                    jnp.sum(wu * uu) + jnp.sum(wv * uv),
                    jnp.sum(ru * ru) + jnp.sum(rv * rv),
                ]
            )
            s = lax.psum(partial_sums, axis_name)  # one collective, 3 scalars
            return s[0], s[1], s[2]

        xu, xv = pcg_solve_split_gear(
            apply_A, sys.b_u, sys.b_v, du, dv, rtol, maxiter,
            a12=sys.a12, x0=x0_split, dots3=dots3, sync_axes=sync_axes,
        )
    else:
        xu, xv = pcg_solve_split(
            apply_A, sys.b_u, sys.b_v, du, dv, rtol, maxiter,
            a12=sys.a12, x0=x0_split, dot2=dot2, sync_axes=sync_axes,
        )
    return jnp.stack([xu, xv], axis=-1)


def solve_flow_system_sharded(
    sys: FlowSystem,
    mesh,
    rtol: float = 1e-3,
    maxiter: int = 200,
    axis_name: str = SPACE_AXIS,
    algo: str | None = None,
):
    """Host-callable distributed solve: rows of every field sharded."""
    spec2 = P(axis_name)
    spec3 = P(axis_name)
    fn = shard_map(
        partial(
            solve_flow_system_local,
            axis_name=axis_name,
            rtol=rtol,
            maxiter=maxiter,
            algo=algo,
        ),
        mesh=mesh,
        in_specs=(FlowSystem(*([spec2] * 9)),),
        out_specs=spec3,
        check_rep=False,
    )
    return fn(sys)
