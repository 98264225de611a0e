"""Chebyshev semi-iteration for the flow system: a reduce-free solver.

Classic PCG needs two reduce passes per iteration (p·Ap, then r·z fused
with the stopping ‖r‖²).  Chebyshev semi-iteration [Golub & Varga 1961;
Saad, *Iterative Methods*, §12.3] replaces the inner products with a fixed
three-term recurrence driven by eigenvalue bounds [λmin, λmax] of the
preconditioned operator M⁻¹A — ZERO reductions in the iteration body.  The
residual norm is only needed for STOPPING, so it is checked every
``check_every`` iterations.

The price is iteration count: CG builds the optimal polynomial for the
actual spectrum (and exploits clustering — the block-Jacobi-preconditioned
flow systems cluster hard near 1); Chebyshev commits to the minimax
polynomial on the whole interval [λmin, λmax], so it needs
~sqrt(κ)·ln(2/ε)/2 iterations REGARDLESS of clustering — about 1.9x CG's
count on Classic+NL systems (κ≈107, Lanczos-measured).  On one device that
is a loss; on a MESH the body needs NO collectives, only 1 psum per K-block
stopping check vs gear's 1/iter (``parallel/dist.py`` ``algo='cheby'``;
benchmarks/multihost.py A/Bs all three on a 2-process runtime).

Eigenvalue bounds come from :func:`lanczos_bounds_split`: k steps of the
preconditioned Lanczos recurrence (mathematically the PCG coefficient
recursion), eigenvalues of the small tridiagonal via ``eigvalsh``, with
the standard safety widening (Ritz values UNDERestimate λmax and
OVERestimate λmin; the widening factors make the interval safe — a λ
outside the interval makes Chebyshev stagnate, not just slow down).

Reference counterpart: none — the reference's only solvers are spsolve /
scipy CG / SOR (``base.py:87-172``); this is performance engineering
on the same fixed point (stopping rule ‖r‖ ≤ rtol‖b‖ preserved).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _dot2(au, av, bu, bv):
    return jnp.sum(au * bu) + jnp.sum(av * bv)


def lanczos_bounds_split(apply_A, precond, bu, bv, k: int = 12,
                         widen: float = 1.05, shrink: float = 0.8, dot2=None):
    """Estimate (λmin, λmax) of M⁻¹A from k Lanczos steps.

    Runs the M-inner-product Lanczos recurrence (the PCG alpha/beta
    recursion) seeded with the right-hand side, assembles the k×k
    tridiagonal, and returns its extreme eigenvalues widened by
    ``widen`` (λmax) and ``shrink`` (λmin) — Ritz values always lie
    INSIDE the true spectrum, and Chebyshev needs the interval to
    contain it.  Cost: k operator applies + 2k reductions, paid once per
    system (amortized over the solve's hundreds of reduce-free
    iterations).  ``dot2`` is injectable for the sharded path (psum).
    """
    if dot2 is None:
        dot2 = _dot2
    # PCG recursion on a zero initial guess: r0 = b
    ru, rv = bu, bv
    zu, zv = precond(ru, rv)
    rz = dot2(ru, rv, zu, zv)
    pu, pv = zu, zv

    def body(carry, _):
        ru, rv, zu, zv, pu, pv, rz, alpha_prev, beta_prev = carry
        Apu, Apv = apply_A(pu, pv)
        pAp = dot2(pu, pv, Apu, Apv)
        alpha = jnp.where(pAp != 0.0, rz / pAp, 1.0)
        ru2 = ru - alpha * Apu
        rv2 = rv - alpha * Apv
        zu2, zv2 = precond(ru2, rv2)
        rz2 = dot2(ru2, rv2, zu2, zv2)
        beta = jnp.where(rz != 0.0, rz2 / rz, 0.0)
        pu2 = zu2 + beta * pu
        pv2 = zv2 + beta * pv
        out = (alpha, beta, alpha_prev, beta_prev)
        return (ru2, rv2, zu2, zv2, pu2, pv2, rz2, alpha, beta), out

    zero = jnp.zeros_like(rz)
    carry0 = (ru, rv, zu, zv, pu, pv, rz, zero, zero)
    _, (alphas, betas, alphas_prev, betas_prev) = jax.lax.scan(
        body, carry0, None, length=k
    )
    # tridiagonal of M⁻¹A in the M-inner product (Saad §6.7.3):
    #   T[j,j]   = 1/alpha_j + beta_{j-1}/alpha_{j-1}
    #   T[j,j+1] = sqrt(beta_j)/alpha_j
    safe_a = jnp.where(alphas != 0.0, alphas, 1.0)
    safe_ap = jnp.where(alphas_prev != 0.0, alphas_prev, 1.0)
    diag = 1.0 / safe_a + jnp.where(
        jnp.arange(k) == 0, 0.0, betas_prev / safe_ap
    )
    off = jnp.sqrt(jnp.maximum(betas, 0.0)) / safe_a
    T = jnp.diag(diag) + jnp.diag(off[:-1], 1) + jnp.diag(off[:-1], -1)
    eig = jnp.linalg.eigvalsh(T)
    return eig[0] * shrink, eig[-1] * widen


def cheby_solve_split(
    apply_A, bu, bv, du, dv, lmin, lmax, rtol, maxiter,
    a12=None, x0=None, check_every: int = 16, dot2=None, return_iters=False,
    sync_axes=(),
):
    """Preconditioned Chebyshev iteration, channel-split state.

    Same fixed point and stopping rule (‖r‖ ≤ rtol‖b‖) as
    :func:`~optical_flow_tpu.solvers.cg.pcg_solve_split`; the iteration
    body contains ZERO reductions — the convergence check runs once per
    ``check_every``-iteration block (up to check_every-1 extra
    polish iterations vs CG's every-iteration check).

    Recurrence (Templates §5.3 / Saad Alg. 12.1), on z = M⁻¹r:

        d = (λmax+λmin)/2,  c = (λmax−λmin)/2
        α₁ = 1/d;  αₖ = 1/(d − c²αₖ₋₁/4);  βₖ = (c·αₖ₋₁/2)²·... (folded)
        p ← z + β p;  x ← x + α p;  r ← r − α A p

    STAGNATION DIAGNOSTIC: eigenvalues outside [lmin, lmax] make the
    iteration stagnate (not diverge) — the loop then spins to ``maxiter``
    and returns with the stopping rule unmet, exactly like CG at an
    exhausted budget (reference semantics).  The 12-step Lanczos bounds'
    smallest Ritz value converges slowest, so ``shrink=0.8`` is margin,
    not a guarantee; callers that need certainty pass
    ``return_iters=True`` and treat ``k >= maxiter`` as not-converged.
    """
    from optical_flow_tpu.solvers.cg import _block_jacobi_split

    if dot2 is None:
        dot2 = _dot2
    precond = _block_jacobi_split(du, dv, a12)
    if x0 is None:
        xu = jnp.zeros_like(bu)
        xv = jnp.zeros_like(bv)
    else:
        xu, xv = x0

    d = (lmax + lmin) / 2.0
    c = (lmax - lmin) / 2.0

    Axu, Axv = apply_A(xu, xv)
    ru, rv = bu - Axu, bv - Axv
    tol2 = (rtol**2) * dot2(bu, bv, bu, bv)

    def k_block(state):
        k, xu, xv, ru, rv, pu, pv, alpha = state

        def one_iter(i, s):
            xu, xv, ru, rv, pu, pv, alpha = s
            zu, zv = precond(ru, rv)
            # first-ever iteration: beta=0, alpha=1/d (alpha carries 0 in)
            beta = jnp.where(alpha == 0.0, 0.0, (c * alpha / 2.0) ** 2)
            alpha_new = 1.0 / (d - beta / jnp.where(alpha == 0.0, 1.0, alpha))
            pu = zu + beta * pu
            pv = zv + beta * pv
            Apu, Apv = apply_A(pu, pv)
            xu = xu + alpha_new * pu
            xv = xv + alpha_new * pv
            ru = ru - alpha_new * Apu
            rv = rv - alpha_new * Apv
            return (xu, xv, ru, rv, pu, pv, alpha_new)

        xu, xv, ru, rv, pu, pv, alpha = jax.lax.fori_loop(
            0, check_every, one_iter, (xu, xv, ru, rv, pu, pv, alpha)
        )
        return (k + check_every, xu, xv, ru, rv, pu, pv, alpha)

    def cond(state):
        k, _xu, _xv, ru, rv, _pu, _pv, _alpha = state
        unconverged = (dot2(ru, rv, ru, rv) > tol2).astype(jnp.int32)
        for axn in sync_axes:
            unconverged = jax.lax.pmax(unconverged, axn)
        return jnp.logical_and(k < maxiter, unconverged > 0)

    zero_p = jnp.zeros_like(bu)
    state = (jnp.asarray(0), xu, xv, ru, rv, zero_p, jnp.zeros_like(bv),
             jnp.zeros_like(d))
    out = jax.lax.while_loop(cond, k_block, state)
    if return_iters:
        return out[1], out[2], out[0]
    return out[1], out[2]
