"""Matrix-free FlowSystem vs dense materialization vs the reference sparse A.

The central structural claim of this framework: the reference's sparse
system  bmat([[duu, dduv], [dduv, dvv]])  (with FᵀWF spatial terms) equals
the coupled 5-point stencil in ops/stencil.py.  These tests verify it
numerically against the reference ``flow_operator`` implementations.
"""
import numpy as np
import pytest

from optical_flow_tpu.ops.derivatives import partial_deriv
from optical_flow_tpu.ops.penalties import Robust
from optical_flow_tpu.ops.stencil import (
    build_hs_system,
    build_irls_system,
    system_apply,
    system_diag,
    system_rhs,
)
from optical_flow_tpu.solvers.direct import dense_matrix, dense_solve
from optical_flow_tpu.solvers.cg import solve_flow_system


def _rand_system(rng, h=7, w=9):
    images = np.stack([rng.uniform(0, 255, (h, w)), rng.uniform(0, 255, (h, w))], 2)
    uv = 0.3 * rng.standard_normal((h, w, 2))
    duv = 0.1 * rng.standard_normal((h, w, 2))
    It, Ix, Iy = partial_deriv(images, uv, "cubic")
    return images, uv, duv, np.asarray(It), np.asarray(Ix), np.asarray(Iy)


def test_apply_matches_dense(rng):
    _, uv, duv, It, Ix, Iy = _rand_system(rng)
    rho = Robust("charbonnier", (0.1,))
    sys = build_irls_system(uv, duv, It, Ix, Iy, (rho, rho), (rho, rho), rho, 2.5)
    A = dense_matrix(sys)
    # symmetric
    np.testing.assert_allclose(A, A.T, atol=1e-12)
    x = rng.standard_normal(uv.shape)
    H, W = uv.shape[:2]
    x_flat = np.concatenate([x[:, :, 0].ravel(order="F"), x[:, :, 1].ravel(order="F")])
    ref = A @ x_flat
    mine = np.asarray(system_apply(sys, x))
    mine_flat = np.concatenate(
        [mine[:, :, 0].ravel(order="F"), mine[:, :, 1].ravel(order="F")]
    )
    np.testing.assert_allclose(mine_flat, ref, rtol=1e-10, atol=1e-10)
    # diagonal extraction
    d = np.asarray(system_diag(sys))
    d_flat = np.concatenate([d[:, :, 0].ravel(order="F"), d[:, :, 1].ravel(order="F")])
    np.testing.assert_allclose(d_flat, np.diag(A), rtol=1e-10)


def _ref_irls_operator(reference_pkg, uv, duv, It, Ix, Iy, rho_name, rho_params, lam):
    """Build the reference's sparse A, b via a configured BA object."""
    from optical_flow.methods.ba import BAOpticalFlow
    from optical_flow.robust.robust_function import RobustFunction

    ope = BAOpticalFlow()
    ope.lambda_ = lam
    rf = lambda: RobustFunction(rho_name, *rho_params)
    ope.rho_spatial_u = [rf(), rf()]
    ope.rho_spatial_v = [rf(), rf()]
    ope.rho_data = rf()
    A, b, _, _ = ope.flow_operator(uv, duv, It, Ix, Iy)
    return A.toarray(), np.asarray(b)


@pytest.mark.parametrize(
    "rho_name,rho_params,lam",
    [
        ("quadratic", (1.0,), 3.0),
        ("lorentzian", (0.03,), 0.06),
        ("charbonnier", (1e-3,), 5.0),
        ("generalized_charbonnier", (1e-3, 0.45), 3.0),
    ],
)
def test_irls_system_matches_reference_sparse(reference_pkg, rng, rho_name, rho_params, lam):
    _, uv, duv, It, Ix, Iy = _rand_system(rng)
    A_ref, b_ref = _ref_irls_operator(
        reference_pkg, uv, duv, It, Ix, Iy, rho_name, rho_params, lam
    )
    rho = Robust(rho_name, rho_params)
    sys = build_irls_system(uv, duv, It, Ix, Iy, (rho, rho), (rho, rho), rho, lam)
    A_mine = dense_matrix(sys)
    np.testing.assert_allclose(A_mine, A_ref, rtol=1e-9, atol=1e-9)
    b_mine = np.asarray(system_rhs(sys))
    b_flat = np.concatenate(
        [b_mine[:, :, 0].ravel(order="F"), b_mine[:, :, 1].ravel(order="F")]
    )
    np.testing.assert_allclose(b_flat, b_ref, rtol=1e-9, atol=1e-9)


def test_hs_system_matches_reference_sparse(reference_pkg, rng):
    from optical_flow.methods.hs import HSOpticalFlow

    h, w = 7, 9
    images = np.stack([rng.uniform(0, 255, (h, w)), rng.uniform(0, 255, (h, w))], 2)
    uv = 0.3 * rng.standard_normal((h, w, 2))

    ope = HSOpticalFlow()
    ope.images = images
    ope.lambda_ = 10.0
    A_ref, b_ref, _, _ = ope.flow_operator(uv)
    A_ref = A_ref.toarray()

    It, Ix, Iy = partial_deriv(images, uv, "cubic")
    sys = build_hs_system(uv, np.asarray(It), np.asarray(Ix), np.asarray(Iy), 10.0, 1.0, 1.0)
    # reference A = D - lam*M  where M = -L  =>  ours should equal -A_ref?  No:
    # ours IS  D + lam*L  which equals the reference matrix directly.
    A_mine = dense_matrix(sys)
    np.testing.assert_allclose(A_mine, A_ref, rtol=1e-9, atol=1e-9)
    b_mine = np.asarray(system_rhs(sys))
    b_flat = np.concatenate(
        [b_mine[:, :, 0].ravel(order="F"), b_mine[:, :, 1].ravel(order="F")]
    )
    np.testing.assert_allclose(b_flat, np.asarray(b_ref), rtol=1e-9, atol=1e-9)


def test_pcg_matches_dense_solve(rng):
    _, uv, duv, It, Ix, Iy = _rand_system(rng)
    rho = Robust("charbonnier", (0.1,))
    sys = build_irls_system(uv, duv, It, Ix, Iy, (rho, rho), (rho, rho), rho, 2.5)
    x_exact = dense_solve(sys)
    x_pcg = np.asarray(solve_flow_system(sys, "backslash", 1e-3, 200, 1e-12, 4000))
    np.testing.assert_allclose(x_pcg, x_exact, rtol=1e-6, atol=1e-8)


def test_sor_converges(rng):
    from optical_flow_tpu.solvers.sor import sor_solve

    _, uv, duv, It, Ix, Iy = _rand_system(rng)
    rho = Robust("quadratic", (1.0,))
    sys = build_irls_system(uv, duv, It, Ix, Iy, (rho, rho), (rho, rho), rho, 2.5)
    x_exact = dense_solve(sys)
    x_sor = np.asarray(sor_solve(sys, omega=1.9, max_iters=2000, tol=1e-10))
    np.testing.assert_allclose(x_sor, x_exact, rtol=1e-4, atol=1e-6)


def test_sor_config_threaded_through_solver_cfg(rng):
    """The method object's SOR knobs reach the solver (VERDICT r1 item 8)."""
    from optical_flow_tpu.methods.hs import HSOpticalFlow

    ope = HSOpticalFlow()
    ope.solver = "sor"
    ope.sor_omega = 1.5
    ope.sor_max_iters = 7
    ope.sor_tol = 1e-6
    assert ope._solver_cfg()[5:] == (1.5, 7, 1e-6)

    # and the knobs change the solve: few iterations must be visibly less
    # converged than the reference default of 10000
    _, uv, duv, It, Ix, Iy = _rand_system(rng)
    rho = Robust("quadratic", (1.0,))
    sys = build_irls_system(uv, duv, It, Ix, Iy, (rho, rho), (rho, rho), rho, 2.5)
    x_exact = dense_solve(sys)
    few = np.asarray(
        solve_flow_system(sys, "sor", sor_omega=1.9, sor_max_iters=2, sor_tol=1e-12)
    )
    many = np.asarray(
        solve_flow_system(sys, "sor", sor_omega=1.9, sor_max_iters=10000, sor_tol=1e-12)
    )
    err_few = np.abs(few - x_exact).max()
    err_many = np.abs(many - x_exact).max()
    assert err_many < 1e-5
    assert err_few > 10 * err_many


def test_pcg_split_matches_stacked(rng):
    """The r4 channel-split CG state (two (H, W) planes) is the same solver
    as the stacked formulation: identical fixed point, preconditioner, and
    stopping rule — only dot-product reduction order differs, so agreement
    is to float-reduction precision, and both match the dense solve."""
    from optical_flow_tpu.ops.stencil import (
        system_apply,
        system_apply_split,
        system_diag,
        system_rhs,
        weighted_laplacian_diag,
    )
    from optical_flow_tpu.solvers.cg import pcg_solve, pcg_solve_split

    _, uv, duv, It, Ix, Iy = _rand_system(rng)
    rho = Robust("charbonnier", (0.1,))
    sys = build_irls_system(uv, duv, It, Ix, Iy, (rho, rho), (rho, rho), rho, 2.5)

    x_stacked = np.asarray(
        pcg_solve(
            lambda x: system_apply(sys, x),
            system_rhs(sys),
            system_diag(sys),
            1e-10,
            4000,
            a12=sys.a12,
        )
    )
    du = sys.a11 + weighted_laplacian_diag(sys.wu_h, sys.wu_v)
    dv = sys.a22 + weighted_laplacian_diag(sys.wv_h, sys.wv_v)
    xu, xv = pcg_solve_split(
        lambda xu, xv: system_apply_split(sys, xu, xv),
        sys.b_u,
        sys.b_v,
        du,
        dv,
        1e-10,
        4000,
        a12=sys.a12,
    )
    x_split = np.stack([np.asarray(xu), np.asarray(xv)], axis=-1)
    np.testing.assert_allclose(x_split, x_stacked, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(x_split, dense_solve(sys), rtol=1e-6, atol=1e-8)


def test_pcg_gear_matches_classic(rng):
    """The Chronopoulos–Gear recurrence (one fused reduce pass/iteration)
    is the same solver as classic PCG: identical fixed point,
    preconditioner, and stopping rule — in exact arithmetic the iterates
    coincide, so agreement is to recurrence-rounding precision even at a
    tight tolerance, and both match the dense solve."""
    from optical_flow_tpu.ops.stencil import (
        system_apply_split,
        weighted_laplacian_diag,
    )
    from optical_flow_tpu.solvers.cg import pcg_solve_split, pcg_solve_split_gear

    _, uv, duv, It, Ix, Iy = _rand_system(rng)
    rho = Robust("charbonnier", (0.1,))
    sys = build_irls_system(uv, duv, It, Ix, Iy, (rho, rho), (rho, rho), rho, 2.5)

    du = sys.a11 + weighted_laplacian_diag(sys.wu_h, sys.wu_v)
    dv = sys.a22 + weighted_laplacian_diag(sys.wv_h, sys.wv_v)
    ap = lambda xu, xv: system_apply_split(sys, xu, xv)
    args = (ap, sys.b_u, sys.b_v, du, dv, 1e-10, 4000)
    xu_c, xv_c = pcg_solve_split(*args, a12=sys.a12)
    xu_g, xv_g = pcg_solve_split_gear(*args, a12=sys.a12)
    x_classic = np.stack([np.asarray(xu_c), np.asarray(xv_c)], axis=-1)
    x_gear = np.stack([np.asarray(xu_g), np.asarray(xv_g)], axis=-1)
    np.testing.assert_allclose(x_gear, x_classic, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(x_gear, dense_solve(sys), rtol=1e-5, atol=1e-7)

    # the diagonal-only preconditioner branch (a12=None) as well
    xu_c, xv_c = pcg_solve_split(*args)
    xu_g, xv_g = pcg_solve_split_gear(*args)
    np.testing.assert_allclose(
        np.asarray(xu_g), np.asarray(xu_c), rtol=1e-5, atol=1e-8
    )
    np.testing.assert_allclose(
        np.asarray(xv_g), np.asarray(xv_c), rtol=1e-5, atol=1e-8
    )


def test_cheby_meets_stopping_rule(rng):
    """Chebyshev semi-iteration (reduce-free body, solvers/chebyshev.py)
    reaches the SAME stopping rule as PCG (||r|| <= rtol ||b||) with
    Lanczos-estimated bounds, and at tight tolerance matches the dense
    solve — same fixed point, different polynomial."""
    from functools import partial as _partial

    import jax.numpy as jnp

    from optical_flow_tpu.ops.stencil import (
        system_apply_split,
        weighted_laplacian_diag,
    )
    from optical_flow_tpu.solvers.cg import _block_jacobi_split
    from optical_flow_tpu.solvers.chebyshev import (
        cheby_solve_split,
        lanczos_bounds_split,
    )

    _, uv, duv, It, Ix, Iy = _rand_system(rng, h=16, w=20)
    rho = Robust("charbonnier", (0.1,))
    sys = build_irls_system(uv, duv, It, Ix, Iy, (rho, rho), (rho, rho), rho, 2.5)
    du = sys.a11 + weighted_laplacian_diag(sys.wu_h, sys.wu_v)
    dv = sys.a22 + weighted_laplacian_diag(sys.wv_h, sys.wv_v)
    ap = _partial(system_apply_split, sys)
    precond = _block_jacobi_split(du, dv, sys.a12)
    lmin, lmax = lanczos_bounds_split(ap, precond, sys.b_u, sys.b_v, k=12)
    assert float(lmin) > 0 and float(lmax) > float(lmin)

    for rtol, max_iter in ((1e-3, 4000), (1e-8, 20000)):
        xu, xv = cheby_solve_split(
            ap, sys.b_u, sys.b_v, du, dv, lmin, lmax, rtol, max_iter,
            a12=sys.a12, check_every=8,
        )
        yu, yv = ap(jnp.asarray(xu), jnp.asarray(xv))
        r = np.stack([sys.b_u - np.asarray(yu), sys.b_v - np.asarray(yv)], -1)
        b = np.stack([np.asarray(sys.b_u), np.asarray(sys.b_v)], -1)
        assert np.linalg.norm(r) <= rtol * np.linalg.norm(b) * 1.001
    x = np.stack([np.asarray(xu), np.asarray(xv)], -1)
    np.testing.assert_allclose(x, dense_solve(sys), rtol=1e-4, atol=1e-6)


def test_cg_algo_validation():
    """Typos in OFTPU_CG_ALGO / algo= must raise, not silently run classic."""
    import pytest as _pytest

    from optical_flow_tpu.solvers.cg import _check_algo

    assert _check_algo("classic") == "classic"
    assert _check_algo("gear") == "gear"
    with _pytest.raises(ValueError, match="Unknown CG algo"):
        _check_algo("Gear")


def test_solve_flow_system_cheby_env_optin(rng, monkeypatch):
    """OFTPU_CG_ALGO=cheby is a uniform opt-in: the single-chip XLA path
    must run it (measured-rejected for speed, but correct) rather than
    crash, and reach the same fixed point as classic at its rtol."""
    from optical_flow_tpu.solvers import cg as cg_mod

    _, uv, duv, It, Ix, Iy = _rand_system(rng)
    rho = Robust("charbonnier", (0.1,))
    sys = build_irls_system(uv, duv, It, Ix, Iy, (rho, rho), (rho, rho), rho, 2.5)
    x_classic = np.asarray(solve_flow_system(sys, "backslash", 1e-3, 200, 1e-10, 4000))
    monkeypatch.setattr(cg_mod, "CG_ALGO", "cheby")
    x_cheby = np.asarray(solve_flow_system(sys, "backslash", 1e-3, 200, 1e-10, 4000))
    np.testing.assert_allclose(x_cheby, x_classic, rtol=1e-5, atol=1e-7)
