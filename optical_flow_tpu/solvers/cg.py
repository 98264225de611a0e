"""Jacobi-preconditioned conjugate gradient, matrix-free and jittable.

This replaces the reference's three solver paths (``base.py:87-172``):

* ``'pcg'``       — CG at the reference's rtol 1e-3 / maxiter 200
                    (``base.py:116-136``), upgraded from diagonal Jacobi to
                    a per-pixel 2x2 block-Jacobi preconditioner (same fixed
                    point and stopping rule, ~25% fewer iterations).
* ``'backslash'`` — the reference's direct ``spsolve``.  The systems are SPD,
                    so here this maps to tight-tolerance CG (machine-
                    precision-limited); an explicit dense solve for tiny
                    grids lives in :mod:`optical_flow_tpu.solvers.direct`.
* ``'sor'``       — red-black SOR in :mod:`optical_flow_tpu.solvers.sor`.

Each CG iteration is one stencil apply (one fused elementwise pass) plus
two scalar reductions.  Under ``shard_map`` the apply uses halo exchange and the
reductions become ``psum`` over the mesh — see
:mod:`optical_flow_tpu.parallel`.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from optical_flow_tpu.ops.stencil import (
    FlowSystem,
    system_apply_split,
    weighted_laplacian_diag,
)

# 'classic' | 'gear' | 'cheby' — iteration recurrence for the XLA CG
# paths.  READ AT TRACE TIME: set OFTPU_CG_ALGO before the first flow is
# computed.  The sharded level programs carry CG_ALGO in their jit cache
# key (parallel/spatial.py) so a mid-process flip retraces them, but the
# single-chip method programs are keyed on their frozen config dataclasses
# alone — already-compiled programs keep the recurrence they were traced
# with (bench/study code that must flip mid-process calls the solver
# functions directly, which read the current value eagerly).
#
# 'gear' (Chronopoulos–Gear PCG) makes the three per-iteration scalar
# reductions (r·u, w·u, ‖r‖²) mutually independent: on a device mesh they
# ride ONE stacked psum instead of classic PCG's three collective rounds
# (parallel/dist.py).  'cheby' (Chebyshev semi-iteration,
# solvers/chebyshev.py) carries ZERO collectives in the body — 1 psum per
# 16-iteration stopping block — at ~1.9× the iteration count.  Both trade
# extra single-device work for fewer collectives; the default stays
# 'classic'.
CG_ALGO = os.environ.get("OFTPU_CG_ALGO", "classic")


def _dot(a, b):
    return jnp.sum(a * b)


_CG_ALGOS = ("classic", "gear", "cheby")


def _check_algo(algo: str) -> str:
    """Reject unknown algo names loudly: a typo ('Gear', 'chrono') must not
    silently fall through to classic and deny the user the collective
    saving they asked for."""
    if algo not in _CG_ALGOS:
        raise ValueError(
            f"Unknown CG algo {algo!r} (OFTPU_CG_ALGO?): expected one of {_CG_ALGOS}"
        )
    return algo


def _block_jacobi_stacked(diag, a12):
    """Preconditioner for (..., 2)-stacked state: exact inverse of the
    per-pixel 2x2 block [[diag_u, a12], [a12, diag_v]]; falls back to the
    reference's zeroed-inverse diagonal (base.py:132) where the block is
    singular or ``a12`` is None."""
    dinv = jnp.where(jnp.abs(diag) > 1e-12, 1.0 / diag, 0.0)
    if a12 is None:
        return lambda r: dinv * r
    du, dv = diag[..., 0], diag[..., 1]
    det = du * dv - a12 * a12
    ok = jnp.abs(det) > 1e-12
    safe = jnp.where(ok, det, 1.0)
    i00 = jnp.where(ok, dv / safe, dinv[..., 0])
    i01 = jnp.where(ok, -a12 / safe, 0.0)
    i11 = jnp.where(ok, du / safe, dinv[..., 1])

    def precond(r):
        return jnp.stack(
            [
                i00 * r[..., 0] + i01 * r[..., 1],
                i01 * r[..., 0] + i11 * r[..., 1],
            ],
            axis=-1,
        )

    return precond


def _block_jacobi_split(du, dv, a12):
    """Same 2x2 block inverse as :func:`_block_jacobi_stacked`, acting on
    channel-split (ru, rv) plane pairs."""
    dinv_u = jnp.where(jnp.abs(du) > 1e-12, 1.0 / du, 0.0)
    dinv_v = jnp.where(jnp.abs(dv) > 1e-12, 1.0 / dv, 0.0)
    if a12 is None:
        return lambda ru, rv: (dinv_u * ru, dinv_v * rv)
    det = du * dv - a12 * a12
    ok = jnp.abs(det) > 1e-12
    safe = jnp.where(ok, det, 1.0)
    i00 = jnp.where(ok, dv / safe, dinv_u)
    i01 = jnp.where(ok, -a12 / safe, 0.0)
    i11 = jnp.where(ok, du / safe, dinv_v)
    return lambda ru, rv: (i00 * ru + i01 * rv, i01 * ru + i11 * rv)


def pcg_solve(apply_A, b, diag, rtol, maxiter, x0=None, dot=_dot, sync_axes=(), a12=None):
    """PCG on ``A x = b``, block-Jacobi (2x2 per-pixel) preconditioned.

    ``apply_A`` maps pytree-shaped arrays to like-shaped arrays.  The
    convergence test matches ``scipy.sparse.linalg.cg``:
    ``||r||_2 <= rtol * ||b||_2`` checked every iteration.  ``dot`` is
    injectable so the distributed path can psum-reduce partial products.

    ``a12``: optional per-pixel u-v coupling of the data term.  When given,
    the preconditioner is the exact inverse of the per-pixel 2x2 block
    ``[[diag_u, a12], [a12, diag_v]]`` instead of the reference's diagonal
    (``base.py:116-136``) — a strict upgrade (same fixed point, same
    stopping rule) measured at 137 -> 103 iterations on the stage-2
    RubberWhale system for ~3 extra elementwise ops per iteration; the
    image-domain coupling ``Ix*Iy`` is near-maximal (|a12|/sqrt(a11*a22) -> 1)
    wherever the local gradient is diagonal, which is exactly what diagonal
    Jacobi cannot see.

    ``sync_axes``: mesh axis names over which the loop must run a UNIFORM
    number of iterations.  When independent systems solve concurrently on
    disjoint mesh groups (e.g. data-parallel pairs, each row-sharded), the
    halo-exchange collectives inside ``apply_A`` lower to one program-wide
    op — a group that exits its while_loop early deadlocks the others.
    Reducing the convergence flag with ``pmax`` keeps every group iterating
    until all have converged (extra iterations only polish the residual).
    """
    if x0 is None:
        x0 = jnp.zeros_like(b)
    # reference zeroes the inverse diagonal where |diag| <= 1e-12 (base.py:132)
    precond = _block_jacobi_stacked(diag, a12)

    r0 = b - apply_A(x0)
    z0 = precond(r0)
    rz0 = dot(r0, z0)
    tol2 = (rtol**2) * dot(b, b)

    def cond(state):
        k, x, r, z, p, rz = state
        unconverged = (dot(r, r) > tol2).astype(jnp.int32)
        for axn in sync_axes:
            unconverged = jax.lax.pmax(unconverged, axn)
        return jnp.logical_and(k < maxiter, unconverged > 0)

    def body(state):
        k, x, r, z, p, rz = state
        Ap = apply_A(p)
        pAp = dot(p, Ap)
        alpha = jnp.where(pAp != 0.0, rz / pAp, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = dot(r, z)
        beta = jnp.where(rz != 0.0, rz_new / rz, 0.0)
        p = z + beta * p
        return (k + 1, x, r, z, p, rz_new)

    state = (jnp.asarray(0), x0, r0, z0, z0, rz0)
    _, x, _, _, _, _ = jax.lax.while_loop(cond, body, state)
    return x

def pcg_solve_split(
    apply_A, bu, bv, du, dv, rtol, maxiter, a12=None, x0=None, dot2=None,
    sync_axes=(), return_iters=False,
):
    """Block-Jacobi PCG with CHANNEL-SPLIT state: two (H, W) planes.

    Same math, fixed point, preconditioner, and stopping rule as
    :func:`pcg_solve`; the only numerical difference is dot-product
    reduction order (two per-plane sums added, instead of one sum over the
    interleaved (H, W, 2) stack).  The layout is the point: a trailing
    dimension of 2 makes every elementwise op of the CG body stride over an
    interleaved minor axis, while two (H, W) planes vectorize fully.

    ``apply_A``: (xu, xv) -> (yu, yv) plane pairs
    (:func:`~optical_flow_tpu.ops.stencil.system_apply_split`).

    ``dot2(au, av, bu, bv) -> scalar`` is injectable so the sharded caller
    (``parallel/dist.py``) can psum-reduce the per-shard partials;
    ``sync_axes`` forces a uniform trip count across mesh axes running
    independent solves (see :func:`pcg_solve`).
    """
    if x0 is None:
        xu = jnp.zeros_like(bu)
        xv = jnp.zeros_like(bv)
    else:
        xu, xv = x0
    precond = _block_jacobi_split(du, dv, a12)

    if dot2 is None:

        def dot2(au, av, bu_, bv_):
            return jnp.sum(au * bu_) + jnp.sum(av * bv_)

    Axu, Axv = apply_A(xu, xv)
    ru, rv = bu - Axu, bv - Axv
    zu, zv = precond(ru, rv)
    rz0 = dot2(ru, rv, zu, zv)
    tol2 = (rtol**2) * dot2(bu, bv, bu, bv)

    def cond(state):
        k, _xu, _xv, ru, rv, _zu, _zv, _pu, _pv, _rz = state
        unconverged = (dot2(ru, rv, ru, rv) > tol2).astype(jnp.int32)
        for axn in sync_axes:
            unconverged = jax.lax.pmax(unconverged, axn)
        return jnp.logical_and(k < maxiter, unconverged > 0)

    def body(state):
        k, xu, xv, ru, rv, zu, zv, pu, pv, rz = state
        Apu, Apv = apply_A(pu, pv)
        pAp = dot2(pu, pv, Apu, Apv)
        alpha = jnp.where(pAp != 0.0, rz / pAp, 0.0)
        xu = xu + alpha * pu
        xv = xv + alpha * pv
        ru = ru - alpha * Apu
        rv = rv - alpha * Apv
        zu, zv = precond(ru, rv)
        rz_new = dot2(ru, rv, zu, zv)
        beta = jnp.where(rz != 0.0, rz_new / rz, 0.0)
        pu = zu + beta * pu
        pv = zv + beta * pv
        return (k + 1, xu, xv, ru, rv, zu, zv, pu, pv, rz_new)

    state = (jnp.asarray(0), xu, xv, ru, rv, zu, zv, zu, zv, rz0)
    out = jax.lax.while_loop(cond, body, state)
    if return_iters:
        return out[1], out[2], out[0]
    return out[1], out[2]


def pcg_solve_split_gear(
    apply_A, bu, bv, du, dv, rtol, maxiter, a12=None, x0=None, dots3=None, sync_axes=()
):
    """Chronopoulos–Gear PCG, channel-split: ONE fused reduce pass/iteration.

    Classic PCG has a true data dependency between its two per-iteration
    reductions (p·Ap feeds alpha which feeds the r update which feeds r·z),
    so XLA must emit two reduce passes over device-memory-resident planes.
    The Chronopoulos–Gear recurrence [C&G 1989, "s-step iterative methods"]
    computes alpha and beta from gamma = (r, u) and delta = (w, u) where
    u = M^-1 r and w = A u are both available BEFORE any scalar is needed:

        beta_k  = gamma_k / gamma_{k-1}
        alpha_k = gamma_k / (delta_k - beta_k * gamma_k / alpha_{k-1})

    (the identity (p, Ap) = delta - beta * gamma / alpha_prev follows from
    p = u + beta p_prev and the M-orthogonality of residuals).  gamma,
    delta, and the stopping-rule ||r||^2 are then mutually independent
    sibling reductions over (r, u, w).  Cost: two extra carried plane
    pairs (w, s = A p) and one extra axpy pair per iteration.

    The recurrence pays where a reduce costs a COLLECTIVE round: the mesh
    path (``parallel/dist.py``, 3 psums -> 1 per iteration, HLO-verified).
    On one device the extra carried planes cost more than the fused
    reduce saves.  Solutions equal classic's within recurrence rounding
    (``test_stencil.py::test_pcg_gear_matches_classic``).

    Same fixed point, preconditioner, and stopping rule
    (||r|| <= rtol ||b||, checked every iteration) as
    :func:`pcg_solve_split`; in exact arithmetic the iterates are
    identical — only floating-point accumulation of the recurrence
    differs, bounded by the CG tolerance like every other solver-path
    variation (reference semantics: ``base.py:116-136``).

    ``dots3(ru, rv, uu, uv, wu, wv) -> (r·u, w·u, r·r)`` is injectable so
    the sharded caller (``parallel/dist.py``) can reduce all three scalars
    in ONE stacked ``psum``; ``sync_axes`` as in :func:`pcg_solve`.
    """
    if x0 is None:
        xu = jnp.zeros_like(bu)
        xv = jnp.zeros_like(bv)
    else:
        xu, xv = x0
    precond = _block_jacobi_split(du, dv, a12)

    def dot2(au, av, bu_, bv_):
        return jnp.sum(au * bu_) + jnp.sum(av * bv_)

    if dots3 is None:

        def dots3(ru, rv, uu, uv, wu, wv):
            return (
                dot2(ru, rv, uu, uv),
                dot2(wu, wv, uu, uv),
                dot2(ru, rv, ru, rv),
            )

    Axu, Axv = apply_A(xu, xv)
    ru, rv = bu - Axu, bv - Axv
    uu, uv = precond(ru, rv)
    wu, wv = apply_A(uu, uv)
    gamma0, delta0, rr0 = dots3(ru, rv, uu, uv, wu, wv)
    # the [2] slot of dots3 is r·r; the other two duplicate b·b and CSE away
    tol2 = (rtol**2) * dots3(bu, bv, bu, bv, bu, bv)[2]
    alpha0 = jnp.where(delta0 != 0.0, gamma0 / delta0, 0.0)
    beta0 = jnp.zeros_like(gamma0)
    zu = jnp.zeros_like(bu)
    zv = jnp.zeros_like(bv)

    def cond(state):
        k = state[0]
        rr = state[-1]
        unconverged = (rr > tol2).astype(jnp.int32)
        for axn in sync_axes:
            unconverged = jax.lax.pmax(unconverged, axn)
        return jnp.logical_and(k < maxiter, unconverged > 0)

    def body(state):
        (k, xu, xv, ru, rv, uu, uv, wu, wv, pu, pv, su, sv,
         gamma, alpha, beta, _rr) = state
        pu = uu + beta * pu
        pv = uv + beta * pv
        su = wu + beta * su
        sv = wv + beta * sv
        xu = xu + alpha * pu
        xv = xv + alpha * pv
        ru = ru - alpha * su
        rv = rv - alpha * sv
        uu, uv = precond(ru, rv)
        wu, wv = apply_A(uu, uv)
        # the three reductions below are mutually independent — one fused pass
        gamma_new, delta, rr = dots3(ru, rv, uu, uv, wu, wv)
        beta_new = jnp.where(gamma != 0.0, gamma_new / gamma, 0.0)
        denom = delta - beta_new * jnp.where(
            alpha != 0.0, gamma_new / alpha, 0.0
        )
        alpha_new = jnp.where(denom != 0.0, gamma_new / denom, 0.0)
        return (k + 1, xu, xv, ru, rv, uu, uv, wu, wv, pu, pv, su, sv,
                gamma_new, alpha_new, beta_new, rr)

    state = (jnp.asarray(0), xu, xv, ru, rv, uu, uv, wu, wv, zu, zv, zu, zv,
             gamma0, alpha0, beta0, rr0)
    out = jax.lax.while_loop(cond, body, state)
    return out[1], out[2]


def solve_flow_system(
    sys: FlowSystem,
    solver: str = "pcg",
    pcg_rtol: float = 1e-3,
    pcg_maxiter: int = 200,
    backslash_rtol: float = 1e-7,
    backslash_maxiter: int = 1000,
    sor_omega: float = 1.9,
    sor_max_iters: int = 10000,
    sor_tol: float = 1e-2,
    x0=None,
):
    """Solve a :class:`FlowSystem` for the (H, W, 2) update field.

    SOR defaults match the reference's (omega 1.9, 10000 iterations,
    tol 1e-2 — ``base.py:138-172``); method objects thread their
    ``sor_omega`` / ``sor_max_iters`` / ``sor_tol`` attributes through
    ``BaseOpticalFlow._solver_cfg``.
    """
    _check_algo(CG_ALGO)
    if solver in ("pcg", "backslash"):
        # channel-split XLA path (pcg_solve_split docstring has the layout
        # argument); stack/unstack happens exactly once per solve
        rt, mi = (
            (pcg_rtol, pcg_maxiter)
            if solver == "pcg"
            else (backslash_rtol, backslash_maxiter)
        )
        du = sys.a11 + weighted_laplacian_diag(sys.wu_h, sys.wu_v)
        dv = sys.a22 + weighted_laplacian_diag(sys.wv_h, sys.wv_v)
        x0_split = None if x0 is None else (x0[..., 0], x0[..., 1])
        apply_split = lambda xu, xv: system_apply_split(sys, xu, xv)
        if CG_ALGO == "cheby":
            # kept reachable on one device so the env knob has uniform
            # semantics with the mesh path, where it saves collectives
            from optical_flow_tpu.solvers.chebyshev import (
                cheby_solve_split,
                lanczos_bounds_split,
            )

            precond = _block_jacobi_split(du, dv, sys.a12)
            lo, hi = lanczos_bounds_split(apply_split, precond, sys.b_u, sys.b_v)
            xu, xv = cheby_solve_split(
                apply_split, sys.b_u, sys.b_v, du, dv, lo, hi, rt,
                4 * mi, a12=sys.a12, x0=x0_split,  # ~1.9x iters + K-block rounding
            )
            return jnp.stack([xu, xv], axis=-1)
        split_impl = pcg_solve_split_gear if CG_ALGO == "gear" else pcg_solve_split
        xu, xv = split_impl(
            apply_split,
            sys.b_u,
            sys.b_v,
            du,
            dv,
            rt,
            mi,
            a12=sys.a12,
            x0=x0_split,
        )
        return jnp.stack([xu, xv], axis=-1)
    if solver == "sor":
        from optical_flow_tpu.solvers.sor import sor_solve

        return sor_solve(sys, omega=sor_omega, max_iters=sor_max_iters, tol=sor_tol)
    raise ValueError(f"Unknown solver: {solver}")
