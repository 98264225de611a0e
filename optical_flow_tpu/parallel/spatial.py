"""End-to-end spatially-sharded level programs (SP/CP over image rows).

The pixel grid is the "sequence": image rows are tiled across the ``space``
mesh axis, and a WHOLE pyramid-level solve — warp + derivatives, the
robust IRLS (or Horn–Schunck) system, distributed PCG, occlusion detection,
(weighted) median filtering — runs inside one ``shard_map``, exchanging
only halo strips (``ppermute``) and CG inner products (``psum``).
This is the capability seam the reference cannot scale past
(``/root/reference/optical_flow/methods/base.py:87-172``: a global spsolve;
SURVEY §2's tiling table).

All four method families are covered:

* :func:`classic_nl_level_local` — Classic+NL (and, with ``use_color=False``
  and the occlusion term dead-code-eliminated, exactly the BA IRLS body:
  same α-blended solve, same duv-trick median —
  ``/root/reference/optical_flow/methods/ba.py:140-206``).
* :func:`hs_level_local` — Horn–Schunck (``methods/hs.py:109-142``): the
  early-stop ``while_loop`` tests the GLOBAL update norm via ``psum``.
* :func:`alt_ba_level_local` — Alt-BA (``methods/alt_ba.py``): the shared
  IRLS core plus the elementwise coupling term and the halo-exchanged
  Li–Osher median loop.

Interpolation paths: ``'bi-cubic'`` (Hermite), ``'bi-linear'``, and
``'cubic'`` (scipy cubic B-spline — the hs/ba/classic-c default).  The
spline *prefilter* is a global operator, but it is flow-independent
per-level preprocessing: the host wrapper computes the coefficient tables
globally (matmuls, :func:`~optical_flow_tpu.ops.interp.spline_coeffs_2d`)
outside ``shard_map`` and shards them; only the 4x4 *evaluation* gathers
run locally with halo reads.

Exactness contract
------------------
Each sharded level step computes the *same function* as its single-device
counterpart (up to float reduction order in CG/psum dot products):

* every boundary convention is reproduced at the true image edges via
  :func:`~optical_flow_tpu.parallel.halo.halo_exchange_rows` fill modes
  (symmetric for derivative filters, reflect for medians and spline
  tables, edge for clamped warp reads);
* when the row count does not divide the mesh, rows are padded at the
  bottom.  The padded rows are masked out of the linear system (their
  coefficients, RHS, and the H-1 coupling edge are zeroed), so CG iterates
  — including the convergence test — are bit-for-bit those of the unpadded
  problem, and boundary-dependent reads (mirror fills for filters and the
  median) are re-synthesized in the pad region each iteration
  (:func:`_fixup_bottom`).

The per-shard warp gather is exact for displacements up to the static
``halo`` radius; beyond that local indices clamp to the halo (the same
graceful degradation as any overlap-and-discard tiling).  The method
drivers size the halo per level from the measured incoming-flow bound
plus the per-iteration ±1 update clip (``spatial_halo='auto'``), so the
clamp is never hit on real footage.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map

from optical_flow_tpu.ops.derivatives import HERMITE_CORNER_SHIFTS, hermite_eval
from optical_flow_tpu.ops.filters import correlate2d
from optical_flow_tpu.ops.gather import gather_planes
from optical_flow_tpu.ops.interp import _bspline3, spline_coeffs_2d
from optical_flow_tpu.ops.stencil import FlowSystem, add_coupling, blend_systems
from optical_flow_tpu.ops.wmedian import wmedfilt_prepadded
from optical_flow_tpu.parallel.halo import halo_exchange_rows
from optical_flow_tpu.parallel.mesh import SPACE_AXIS
from optical_flow_tpu.parallel.dist import (
    sharded_laplacian_apply_local,
    solve_flow_system_local,
)

SUPPORTED_INTERP = ("bi-cubic", "bi-linear", "cubic")
SUPPORTED_SOLVERS = ("pcg", "backslash")

CUBIC_OFFSETS = (-1, 0, 1, 2)


def check_spatial_config(interp: str, solver: str):
    """Loudly reject configurations the sharded level programs cannot run.

    A ``mesh=`` request must never silently compute unsharded: anything
    here either shards exactly or raises.
    """
    if interp not in SUPPORTED_INTERP:
        raise ValueError(
            f"spatial sharding (mesh=) does not support interpolation_method="
            f"{interp!r}; supported: {SUPPORTED_INTERP}"
        )
    if solver not in SUPPORTED_SOLVERS:
        raise ValueError(
            f"spatial sharding (mesh=) does not support solver={solver!r} "
            f"(SOR's sequential row sweep is inherently global); supported: "
            f"{SUPPORTED_SOLVERS}"
        )


@dataclasses.dataclass(frozen=True)
class SpatialConfig:
    """Static row-sharding geometry for one pyramid level."""

    axis_name: str
    n: int  # shards along the space axis
    Hs: int  # local rows per shard (includes the pad)
    pad: int  # bottom pad rows (0 when H divides n)
    halo: int  # warp-gather halo radius (max exact displacement)
    H_true: int  # true global row count
    W: int
    # extra mesh axes carrying INDEPENDENT solves (e.g. 'batch'): the CG
    # trip count is pmax-synced over them so group-divergent while_loops
    # cannot deadlock the program-wide halo collectives
    sync_axes: tuple = ()


def spatial_plan(H, W, n, boundary_radius, halo, axis_name=SPACE_AXIS,
                 warp_margin: int = 0):
    """Geometry for sharding H rows over n devices, or None if infeasible.

    ``boundary_radius`` is the largest filter radius whose mirror fill must
    be synthesized inside the pad region (the weighted-median ``area_hsz``
    for the color path, the plain median radius otherwise).  ``warp_margin``
    is extra rows the warp reads past the halo (2 for the cubic B-spline's
    4x4 support, 0 otherwise).
    """
    if n <= 1:
        return None
    if H % n == 0:
        pad = 0
    else:
        # pad >= boundary_radius so every mirror read of a valid row lands
        # inside the fix-up region (never past the padded bottom edge)
        req = max(int(boundary_radius), 2)
        pad = req + (-(H + req)) % n
    Hp = H + pad
    Hs = Hp // n
    # single-hop halo exchange and in-shard fix-up feasibility
    if Hs < max(2 * pad + 1, boundary_radius + 1, halo + 1 + warp_margin, 8):
        return None
    if pad > max(H - 1, 0):
        return None  # mirror pads need enough true rows
    return SpatialConfig(
        axis_name=axis_name, n=int(n), Hs=int(Hs), pad=int(pad),
        halo=int(halo), H_true=int(H), W=int(W),
    )


def _fixup_bottom(x, scfg: SpatialConfig, mode: str):
    """Overwrite the pad rows (last shard only) with mirrored true rows.

    ``mode``: 'reflect' (np.pad reflect — weighted median, spline tables),
    'symmetric' (scipy reflect — plain filters), or 'edge' (clamped warp
    reads).  Static slices only; a no-op when there is no pad.
    """
    pad = scfg.pad
    if pad == 0:
        return x
    off = scfg.Hs - pad  # local row of the first pad row == H_true on shard n-1
    if mode == "reflect":
        fill = x[off - 1 - pad : off - 1][::-1]
    elif mode == "symmetric":
        fill = x[off - pad : off][::-1]
    else:  # edge
        fill = jnp.broadcast_to(x[off - 1 : off], (pad,) + x.shape[1:])
    fixed = jnp.concatenate([x[:off], fill], axis=0)
    idx = lax.axis_index(scfg.axis_name)
    return jnp.where(idx == scfg.n - 1, fixed, x)


def _median_filter_local(scfg: SpatialConfig, x, kh: int, kw: int):
    """scipy-'reflect' median filter on a row shard, exact at true edges."""
    from optical_flow_tpu.ops.filters import _median_views_scrubbed

    cy, cx = kh // 2, kw // 2
    x = _fixup_bottom(x, scfg, "symmetric")
    x_ext = halo_exchange_rows(x, cy, scfg.axis_name, mode="symmetric")
    padded = jnp.pad(x_ext, ((0, 0), (cx, kw - 1 - cx)), mode="symmetric")
    # same pruned-network selection as median_filter2d (bit-equal to sort,
    # incl. its NaNs-last behavior — parent scrubbed once)
    return _median_views_scrubbed(padded, scfg.Hs, scfg.W, kh, kw)


# ---------------------------------------------------------------------------
# shared warp + derivative machinery (inside shard_map)
# ---------------------------------------------------------------------------


def _warp_setup(scfg: SpatialConfig, images, interp, deriv_filter, blend,
                spline_tables, dtype):
    """Flow-independent warp tables and samplers on a row shard.

    Mirrors :func:`~optical_flow_tpu.ops.derivatives.precompute_warp` +
    :func:`warp_deriv` for all three interpolation paths.  ``spline_tables``
    (the 'cubic' path only) are row shards of the GLOBAL spline coefficient
    arrays, pad rows already reflect-filled by the host wrapper.
    """
    ax = scfg.axis_name
    R, Hs, W, H_true = scfg.halo, scfg.Hs, scfg.W, scfg.H_true

    f = np.asarray(deriv_filter, dtype=np.float64)
    fx_k, fy_k, fxy_k = f.reshape(1, -1), f.reshape(-1, 1), np.outer(f, f)
    rv = fy_k.shape[0] // 2  # vertical radius of the derivative filter

    row0 = lax.axis_index(ax) * Hs
    g_col = row0 + lax.broadcasted_iota(jnp.int32, (Hs, 1), 0)  # global row ids

    nc = images.shape[2] // 2
    im1s = tuple(images[:, :, c] for c in range(nc))

    # one symmetric halo exchange of the pair serves every derivative filter;
    # with pad > 0 the image pad rows already hold symmetric-mirrored content
    # (set by the host wrapper), so plain interior arithmetic is exact at the
    # true bottom edge.
    im_ext = halo_exchange_rows(images, rv, ax, mode="symmetric")

    def corr(x_ext, kernel):
        """Correlation on a vertically pre-extended block (radius rv)."""
        kernel = np.atleast_2d(kernel)
        kh, kw = kernel.shape
        cy, cx = kh // 2, kw // 2
        padded = jnp.pad(x_ext, ((0, 0), (cx, kw - 1 - cx)), mode="symmetric")
        out = jnp.zeros((Hs, W), dtype=x_ext.dtype)
        base = rv - cy
        for dy in range(kh):
            for dx in range(kw):
                w = float(kernel[dy, dx])
                if w != 0.0:
                    out = out + w * padded[base + dy : base + dy + Hs, dx : dx + W]
        return out

    I1x = tuple(corr(im_ext[:, :, c], fx_k) for c in range(nc))
    I1y = tuple(corr(im_ext[:, :, c], fy_k) for c in range(nc))

    def table_ext(A):
        # pad rows -> edge copies of the true last row (matches the global
        # edge-padded corner reads), then the warp halo + one edge row/col
        # for the ceil-corner shifts
        A = _fixup_bottom(A, scfg, "edge")
        A = halo_exchange_rows(A, R, ax, mode="edge")
        return jnp.pad(A, ((0, 1), (0, 1)), mode="edge")

    def to_local_rows(iy_global):
        return jnp.clip(iy_global - row0 + R, 0, Hs + 2 * R - 1)

    def shifted_planes(tabs, shifts):
        return jnp.stack(
            [T[a : a + Hs + 2 * R, b : b + W] for T in tabs for (a, b) in shifts],
            axis=-1,
        )

    def hermite_local(tabs, yq, xq):
        fy = jnp.floor(yq)
        fxq = jnp.floor(xq)
        oob = (fxq < 0) | (fxq + 1 > W - 1) | (fy < 0) | (fy + 1 > H_true - 1)
        iy0 = to_local_rows(jnp.clip(fy, 0, H_true - 1).astype(jnp.int32))
        ix0 = jnp.clip(fxq, 0, W - 1).astype(jnp.int32)
        taps = gather_planes(shifted_planes(tabs, HERMITE_CORNER_SHIFTS), iy0, ix0)
        val, vx, vy = hermite_eval(taps, xq - fxq, yq - fy, dtype)
        return val, vx, vy, oob

    def bilinear_local(tab, yq, xq):
        ysc = jnp.clip(yq, 0.0, H_true - 1.0)
        xsc = jnp.clip(xq, 0.0, W - 1.0)
        y0f = jnp.floor(ysc)
        x0f = jnp.floor(xsc)
        ay, axx = ysc - y0f, xsc - x0f
        iy0 = to_local_rows(y0f.astype(jnp.int32))
        ix0 = x0f.astype(jnp.int32)
        taps = gather_planes(
            shifted_planes((tab,), ((0, 0), (0, 1), (1, 0), (1, 1))), iy0, ix0
        )
        v00, v01, v10, v11 = (taps[..., k] for k in range(4))
        top = v00 * (1.0 - axx) + v01 * axx
        bot = v10 * (1.0 - axx) + v11 * axx
        return top * (1.0 - ay) + bot * ay

    occ_tabs = warp_tables = cubic_tabs = None
    if interp == "bi-cubic":
        warp_tables = tuple(
            tuple(
                table_ext(T)
                for T in (
                    images[:, :, nc + c],
                    corr(im_ext[:, :, nc + c], fx_k),
                    corr(im_ext[:, :, nc + c], fy_k),
                    corr(im_ext[:, :, nc + c], fxy_k),
                )
            )
            for c in range(nc)
        )
        occ_tabs = tuple(warp_tables[c][0] for c in range(nc))
    elif interp == "bi-linear":
        warp_tables = tuple(
            tuple(
                table_ext(T)
                for T in (
                    images[:, :, nc + c],
                    corr(im_ext[:, :, nc + c], fx_k),
                    corr(im_ext[:, :, nc + c], fy_k),
                )
            )
            for c in range(nc)
        )
        occ_tabs = tuple(warp_tables[c][0] for c in range(nc))
    else:  # 'cubic': spline coefficients arrive global-computed and sharded
        def cubic_ext(C):
            # reflect fills match jnp.pad(coeffs, 2, 'reflect'): clamped
            # reads touch at most 2 rows/cols past the true edges
            Ce = halo_exchange_rows(C, R + 2, ax, mode="reflect")
            return jnp.pad(Ce, ((0, 0), (2, 2)), mode="reflect")

        cubic_tabs = tuple(
            tuple(cubic_ext(C) for C in tabs) for tabs in spline_tables
        )
        occ_tabs = tuple(table_ext(images[:, :, nc + c]) for c in range(nc))

    HH = Hs + 2 * R + 1
    cub_shifts = tuple(
        (dy + 1, dx + 1) for dy in CUBIC_OFFSETS for dx in CUBIC_OFFSETS
    )

    def cubic_local(tabs, yq, xq):
        """B-spline evaluation of each table in ``tabs`` at (yq, xq).

        Tap (dy, dx) of base (iy, ix) reads global coefficient row iy+dy —
        local row (iy - row0 + R + 1) + (dy + 1) of the (R+2)-halo'd table.
        Weights use the unclamped fractional offsets, exactly as
        :func:`~optical_flow_tpu.ops.interp.sample_cubic_spline`.
        """
        fy = jnp.floor(yq)
        fxq = jnp.floor(xq)
        iy = jnp.clip(fy, 0, H_true - 1).astype(jnp.int32)
        ix = jnp.clip(fxq, 0, W - 1).astype(jnp.int32)
        liy = jnp.clip(iy - row0 + R + 1, 0, HH - 1)
        lix = ix + 1
        planes = jnp.stack(
            [
                T[a : a + HH, b : b + W + 1]
                for T in tabs
                for (a, b) in cub_shifts
            ],
            axis=-1,
        )
        taps = gather_planes(planes, liy, lix)
        wy = [_bspline3(yq - (fy + dy)) for dy in CUBIC_OFFSETS]
        wx = [_bspline3(xq - (fxq + dx)) for dx in CUBIC_OFFSETS]
        outs = []
        for t in range(len(tabs)):
            out = jnp.zeros_like(yq)
            for a in range(4):
                for b in range(4):
                    out = out + wy[a] * wx[b] * taps[..., t * 16 + a * 4 + b]
            outs.append(out)
        return outs

    ygrid = (g_col + jnp.zeros((Hs, W), jnp.int32)).astype(dtype)
    xgrid = lax.broadcasted_iota(jnp.int32, (Hs, W), 1).astype(dtype)

    def warp_deriv_local(uv):
        xq = xgrid + uv[:, :, 0]
        yq = ygrid + uv[:, :, 1]
        B = (xq > W - 1) | (xq < 0) | (yq > H_true - 1) | (yq < 0)
        Its, Ixs, Iys = [], [], []
        for c in range(nc):
            if interp == "bi-cubic":
                warp, wx, wy, mask = hermite_local(warp_tables[c], yq, xq)
            elif interp == "bi-linear":
                t_im, t_dx, t_dy = warp_tables[c]
                warp = bilinear_local(t_im, yq, xq)
                wx = bilinear_local(t_dx, yq, xq)
                wy = bilinear_local(t_dy, yq, xq)
                mask = B
            else:  # cubic
                warp, wx, wy = cubic_local(cubic_tabs[c], yq, xq)
                mask = B
            zero = jnp.zeros((), dtype=dtype)
            Its.append(jnp.where(mask, zero, warp - im1s[c]))
            Ixs.append(jnp.where(mask, zero, blend * wx + (1 - blend) * I1x[c]))
            Iys.append(jnp.where(mask, zero, blend * wy + (1 - blend) * I1y[c]))
        if nc == 1:
            return Its[0], Ixs[0], Iys[0]
        return tuple(jnp.stack(t, axis=2) for t in (Its, Ixs, Iys))

    def occ_sample(c, yq, xq):
        """Clamped bilinear read of raw frame 2 (occlusion detection)."""
        return bilinear_local(occ_tabs[c], yq, xq)

    return SimpleNamespace(
        nc=nc,
        im1s=im1s,
        ygrid=ygrid,
        xgrid=xgrid,
        g_col=g_col,
        warp_deriv=warp_deriv_local,
        occ_sample=occ_sample,
    )


def _global_spline_tables(images, deriv_filter, scfg: SpatialConfig):
    """GLOBAL spline coefficient tables for the 'cubic' warp path.

    Runs jitted but *outside* shard_map in the host wrapper: the B-spline
    prefilter is a global tridiagonal solve (recast as dense-inverse
    matmuls in ops/interp.py), but it is flow-independent per-level
    preprocessing — only the 4x4 evaluation must be local, and it is
    (see ``cubic_local``).  Pad rows are reflect-filled so clamped
    bottom-edge reads (up to 2 rows past H_true) match
    ``jnp.pad(coeffs, 2, 'reflect')``.
    """
    f = np.asarray(deriv_filter, np.float64)
    fx, fy = f.reshape(1, -1), f.reshape(-1, 1)
    nc = images.shape[2] // 2
    out = []
    for c in range(nc):
        im2 = images[:, :, nc + c]
        tabs = (
            spline_coeffs_2d(im2),
            spline_coeffs_2d(correlate2d(im2, fx, "reflect")),
            spline_coeffs_2d(correlate2d(im2, fy, "reflect")),
        )
        if scfg.pad:
            tabs = tuple(
                jnp.pad(T, ((0, scfg.pad), (0, 0)), mode="reflect") for T in tabs
            )
        out.append(tabs)
    return tuple(out)


# ---------------------------------------------------------------------------
# the local (inside-shard_map) level programs
# ---------------------------------------------------------------------------


def _solver_params(irls):
    """(rtol, maxiter) for the level's solver (check_spatial_config already
    rejected everything but pcg/backslash)."""
    if irls.solver[0] == "pcg":
        return irls.solver[1], irls.solver[2]
    return irls.solver[3], irls.solver[4]


def _make_sys_builder(scfg: SpatialConfig, valid, vmask, dtype):
    """Per-shard IRLS system assembly (mirrors ops/stencil.build_irls_system).

    Shared by the Classic+NL/BA and Alt-BA local level programs: returns
    ``build_sys_local(uv, duv, It, Ix, Iy, rsu, rsv, rd, lam)`` producing a
    FlowSystem whose pad-row coefficients and RHS are zeroed (the masked
    bottom-pad convention — CG iterates are bit-for-bit the unpadded
    problem's).
    """
    ax = scfg.axis_name
    Hs, W = scfg.Hs, scfg.W
    zero = jnp.zeros((), dtype=dtype)

    def cmean(x):
        return jnp.mean(x, axis=2) if x.ndim == 3 else x

    def build_sys_local(uv, duv, It, Ix, Iy, rsu, rsv, rd, lam):
        u, v = uv[:, :, 0], uv[:, :, 1]
        up = u + duv[:, :, 0]
        vp = v + duv[:, :, 1]
        up_e = halo_exchange_rows(up, 1, ax, mode="edge")
        vp_e = halo_exchange_rows(vp, 1, ax, mode="edge")

        def fdh(x):  # horizontal forward diff, 0 in the last column
            return jnp.pad(x[:, 1:] - x[:, :-1], ((0, 0), (0, 1)))

        wu_h = rsu[0].deriv_over_x(fdh(up))
        wu_v = rsu[1].deriv_over_x(up_e[2:] - up_e[1:-1])
        wv_h = rsv[0].deriv_over_x(fdh(vp))
        wv_v = rsv[1].deriv_over_x(vp_e[2:] - vp_e[1:-1])
        col_mask = jnp.ones((Hs, W), dtype=dtype).at[:, -1].set(0.0)
        wu_h = jnp.where(valid, lam * wu_h * col_mask, zero)
        wv_h = jnp.where(valid, lam * wv_h * col_mask, zero)
        wu_v = jnp.where(vmask, lam * wu_v, zero)
        wv_v = jnp.where(vmask, lam * wv_v, zero)

        if It.ndim == 3:
            It_lin = It + Ix * duv[:, :, 0:1] + Iy * duv[:, :, 1:2]
        else:
            It_lin = It + Ix * duv[:, :, 0] + Iy * duv[:, :, 1]
        pp_d = cmean(rd.deriv_over_x(It_lin))
        a11 = jnp.where(valid, pp_d * cmean(Ix**2), zero)
        a12 = jnp.where(valid, pp_d * cmean(Ix * Iy), zero)
        a22 = jnp.where(valid, pp_d * cmean(Iy**2), zero)
        b_u = -sharded_laplacian_apply_local(wu_h, wu_v, u, ax) - pp_d * cmean(It_lin * Ix)
        b_v = -sharded_laplacian_apply_local(wv_h, wv_v, v, ax) - pp_d * cmean(It_lin * Iy)
        b_u = jnp.where(valid, b_u, zero)
        b_v = jnp.where(valid, b_v, zero)
        return FlowSystem(a11, a12, a22, wu_h, wu_v, wv_h, wv_v, b_u, b_v)

    return build_sys_local


def classic_nl_level_local(cfg, scfg: SpatialConfig, images, color, uv, alpha,
                           spline_tables=()):
    """One Classic+NL pyramid level on a row shard.

    ``images`` (Hs, W, 2), ``color`` (Hs, W, 3) [or any shape when
    ``cfg.use_color`` is False], ``uv`` (Hs, W, 2).  Mirrors
    ``classic_nl_level_step`` exactly (see module docstring).  With
    ``use_color=False`` this is also the sharded BA level body: the plain
    median branch ignores occlusion (dead code under XLA DCE), matching
    ``ba_level_step``'s duv-trick median (``ba.py:194-202``).
    """
    irls = cfg.irls
    ax = scfg.axis_name
    Hs, W, H_true = scfg.Hs, scfg.W, scfg.H_true
    dtype = uv.dtype
    check_spatial_config(irls.interp, irls.solver[0])

    m = _warp_setup(
        scfg, images, irls.interp, np.asarray(irls.deriv_filter), irls.blend,
        spline_tables, dtype,
    )
    nc = m.nc

    valid = m.g_col < H_true  # (Hs, 1): true rows
    vmask = m.g_col < H_true - 1  # rows owning a live vertical edge

    build_sys_local = _make_sys_builder(scfg, valid, vmask, dtype)
    rtol, maxiter = _solver_params(irls)

    def blended_solve_local(uv, duv, It, Ix, Iy):
        sys_q = build_sys_local(
            uv, duv, It, Ix, Iy,
            irls.qua_rho_spatial_u, irls.qua_rho_spatial_v, irls.qua_rho_data,
            irls.lambda_q,
        )
        sys_r = build_sys_local(
            uv, duv, It, Ix, Iy,
            irls.rho_spatial_u, irls.rho_spatial_v, irls.rho_data,
            irls.lambda_,
        )
        sys = blend_systems(alpha, sys_q, sys_r)
        x = solve_flow_system_local(sys, ax, rtol, maxiter, sync_axes=scfg.sync_axes)
        if irls.limit_update:
            x = jnp.clip(x, -1.0, 1.0)
        return x

    # ------------------------------------------------------------------
    # occlusion (ops/occlusion.py, sharded)
    # ------------------------------------------------------------------
    sigma_d, sigma_i_occ = 0.3, 20.0

    def occlusion_local(uv):
        u, v = uv[:, :, 0], uv[:, :, 1]
        dudx = jnp.pad(u[:, 1:] - u[:, :-1], ((0, 0), (1, 0)))
        v_e = halo_exchange_rows(v, 1, ax, mode="edge")  # top fill => 0 diff at row 0
        dvdy = v_e[1:-1] - v_e[:-2]
        div = dudx + dvdy
        xq = m.xgrid + u
        yq = m.ygrid + v
        It = jnp.zeros_like(u)
        for c in range(nc):
            warp = m.occ_sample(c, yq, xq)
            It = It + jnp.abs(warp - m.im1s[c])
        It = It / nc
        return jnp.exp(-(div**2) / (2.0 * sigma_d**2)) * jnp.exp(
            -(It**2) / (2.0 * sigma_i_occ**2)
        )

    # ------------------------------------------------------------------
    # non-local term (ops/wmedian.py, sharded; reflect boundary at true edges)
    # ------------------------------------------------------------------
    if irls.median_filter_size is not None and cfg.use_color:
        hsz = int(cfg.area_hsz)
        color_fixed = _fixup_bottom(color, scfg, "reflect")
        color_pad = jnp.pad(
            halo_exchange_rows(color_fixed, hsz, ax, mode="reflect"),
            ((0, 0), (hsz, hsz), (0, 0)),
            mode="reflect",
        )

        def nl_filter(new_uv, occ):
            def prep(x):
                x = _fixup_bottom(x, scfg, "reflect")
                x = halo_exchange_rows(x, hsz, ax, mode="reflect")
                return jnp.pad(x, ((0, 0), (hsz, hsz)), mode="reflect")

            return wmedfilt_prepadded(
                prep(new_uv[:, :, 0]), prep(new_uv[:, :, 1]), prep(occ),
                color_pad, color_fixed, Hs, W, hsz, float(cfg.sigma_i),
            )

    elif irls.median_filter_size is not None:
        kh, kw = irls.median_filter_size

        def nl_filter(new_uv, occ):
            return jnp.stack(
                [
                    _median_filter_local(scfg, new_uv[:, :, 0], kh, kw),
                    _median_filter_local(scfg, new_uv[:, :, 1], kh, kw),
                ],
                axis=-1,
            )

    # ------------------------------------------------------------------
    # warping loop (classic_nl.py:228-277)
    # ------------------------------------------------------------------
    def warp_iter(_, uv):
        It, Ix, Iy = m.warp_deriv(uv)
        duv = jnp.zeros_like(uv)
        for _j in range(irls.max_linear):
            duv = blended_solve_local(uv, duv, It, Ix, Iy)
            if irls.median_filter_size is not None:
                new_uv = uv + duv
                occ = occlusion_local(new_uv)
                duv = nl_filter(new_uv, occ) - uv
        return uv + duv

    return lax.fori_loop(0, irls.max_iters, warp_iter, uv)


def alt_ba_level_local(cfg, scfg: SpatialConfig, images, uv, uvhat, alpha,
                       replacement, spline_tables=()):
    """One Alt-BA pyramid level on a row shard.

    Mirrors ``alt_ba_level_step`` (``methods/alt_ba.py``; reference
    ``/root/reference/optical_flow/methods/alt_ba.py:189-274``): the same
    α-blended IRLS body as BA/Classic+NL plus (a) the per-pixel diagonal
    coupling term ``lambda2·rho'(uv−uvhat)`` — elementwise, masked to true
    rows so pad-row CG iterates stay exactly zero — and (b) the Li–Osher
    auxiliary-field update, whose iterated median runs through the same
    halo-exchanged selection network as the plain-median path.  The guard
    runs OUTSIDE shard_map on the global pair (see the host wrapper).
    """
    irls = cfg.irls
    ax = scfg.axis_name
    dtype = uv.dtype
    check_spatial_config(irls.interp, irls.solver[0])

    m = _warp_setup(
        scfg, images, irls.interp, np.asarray(irls.deriv_filter), irls.blend,
        spline_tables, dtype,
    )
    valid = m.g_col < scfg.H_true
    vmask = m.g_col < scfg.H_true - 1

    build_sys_local = _make_sys_builder(scfg, valid, vmask, dtype)
    rtol, maxiter = _solver_params(irls)

    # lambda2 annealing schedule (alt_ba.py:209-212)
    lambda2s = jnp.asarray(
        np.logspace(np.log10(1e-4), np.log10(cfg.lambda2), irls.max_iters), dtype
    )

    mfsz = irls.median_filter_size
    if mfsz is not None and not isinstance(mfsz, (tuple, list)):
        mfsz = (int(mfsz), int(mfsz))

    def denoise_lo_local(un, lam_lo):
        """Sharded ops/denoise.denoise_LO: u <- medfilt(u + λ(un−u))."""
        if mfsz is None:
            return un
        u = un
        for _ in range(int(cfg.iters_lo)):
            u_tilde = u + lam_lo * (un - u)
            u = _median_filter_local(scfg, u_tilde, int(mfsz[0]), int(mfsz[1]))
        return u

    def warp_iter(i, state):
        uv, uvhat = state
        lambda2 = lambda2s[i]
        It, Ix, Iy = m.warp_deriv(uv)
        duv = jnp.zeros_like(uv)
        for _j in range(irls.max_linear):
            sys_q = build_sys_local(
                uv, duv, It, Ix, Iy,
                irls.qua_rho_spatial_u, irls.qua_rho_spatial_v, irls.qua_rho_data,
                irls.lambda_q,
            )
            sys_r = build_sys_local(
                uv, duv, It, Ix, Iy,
                irls.rho_spatial_u, irls.rho_spatial_v, irls.rho_data,
                irls.lambda_,
            )
            sys = blend_systems(alpha, sys_q, sys_r)

            # coupling term (alt_ba.py:236-242): diagonal-only, so masking
            # it to true rows keeps the pad rows fully decoupled (zero
            # residual) and CG bit-identical to the unpadded problem
            tmp = cfg.rho_couple.deriv_over_x(uv - uvhat)
            tmp = jnp.where(valid[:, :, None], tmp, jnp.zeros((), dtype))
            sys = add_coupling(sys, lambda2 * tmp)
            delta = lambda2 * tmp * (uvhat - uv)
            sys = sys._replace(
                b_u=sys.b_u + delta[:, :, 0], b_v=sys.b_v + delta[:, :, 1]
            )

            x = solve_flow_system_local(sys, ax, rtol, maxiter, sync_axes=scfg.sync_axes)
            if irls.limit_update:
                x = jnp.clip(x, -1.0, 1.0)
            duv = x

        uv = uv + duv
        lam_lo = lambda2 / cfg.lambda3
        uvhat = jnp.stack(
            [
                denoise_lo_local(uv[:, :, 0], lam_lo),
                denoise_lo_local(uv[:, :, 1], lam_lo),
            ],
            axis=-1,
        )
        uv = jnp.where(replacement, uvhat, uv)
        return (uv, uvhat)

    return lax.fori_loop(0, irls.max_iters, warp_iter, (uv, uvhat))


def hs_level_local(cfg, scfg: SpatialConfig, images, uv, spline_tables=()):
    """One Horn–Schunck pyramid level on a row shard (``hs.py:109-142``).

    The early stop tests the GLOBAL update norm — ``psum`` over the space
    axis makes every shard's ``while_loop`` take the same trip count; over
    ``scfg.sync_axes`` (independent solves, e.g. a batch axis) the loop is
    pmax-synced and each group's flow freezes at its own convergence.
    """
    ax = scfg.axis_name
    Hs, W, H_true = scfg.Hs, scfg.W, scfg.H_true
    dtype = uv.dtype
    check_spatial_config(cfg.interp, cfg.solver[0])

    m = _warp_setup(
        scfg, images, cfg.interp, np.asarray(cfg.deriv_filter), cfg.blend,
        spline_tables, dtype,
    )

    valid = m.g_col < H_true
    vmask = m.g_col < H_true - 1
    zero = jnp.zeros((), dtype=dtype)

    def cmean(x):
        return jnp.mean(x, axis=2) if x.ndim == 3 else x

    # unit edge weights (the Neumann graph Laplacian), pad rows decoupled
    w_edge = cfg.lambda_ / cfg.sigmaS2
    col_mask = jnp.ones((Hs, W), dtype=dtype).at[:, -1].set(0.0)
    wh = jnp.where(valid, w_edge * col_mask, zero)
    wv = jnp.where(vmask, jnp.full((Hs, W), w_edge, dtype), zero)

    def build_sys(uv, It, Ix, Iy):
        a11 = jnp.where(valid, cmean(Ix**2) / cfg.sigmaD2, zero)
        a12 = jnp.where(valid, cmean(Ix * Iy) / cfg.sigmaD2, zero)
        a22 = jnp.where(valid, cmean(Iy**2) / cfg.sigmaD2, zero)
        Itx = cmean(It * Ix) / cfg.sigmaD2
        Ity = cmean(It * Iy) / cfg.sigmaD2
        u, v = uv[:, :, 0], uv[:, :, 1]
        b_u = jnp.where(valid, -sharded_laplacian_apply_local(wh, wv, u, ax) - Itx, zero)
        b_v = jnp.where(valid, -sharded_laplacian_apply_local(wh, wv, v, ax) - Ity, zero)
        return FlowSystem(a11, a12, a22, wh, wv, wh, wv, b_u, b_v)

    solver = cfg.solver[0]
    if solver == "pcg":
        rtol, maxiter = cfg.solver[1], cfg.solver[2]
    else:  # backslash
        rtol, maxiter = cfg.solver[3], cfg.solver[4]

    def median_pass(uv):
        if cfg.median_filter_size is None:
            return uv
        kh, kw = cfg.median_filter_size
        for _ in range(cfg.mf_iter):
            uv = jnp.stack(
                [
                    _median_filter_local(scfg, uv[:, :, 0], kh, kw),
                    _median_filter_local(scfg, uv[:, :, 1], kh, kw),
                ],
                axis=-1,
            )
        return uv

    def cond(state):
        k, _, cont = state
        c = cont.astype(jnp.int32)
        for axn in scfg.sync_axes:
            c = lax.pmax(c, axn)
        return jnp.logical_and(k < cfg.max_warping_iters, c > 0)

    def body(state):
        k, uv, _ = state
        It, Ix, Iy = m.warp_deriv(uv)
        sys = build_sys(uv, It, Ix, Iy)
        x = solve_flow_system_local(sys, ax, rtol, maxiter, sync_axes=scfg.sync_axes)
        # early stop discards the sub-threshold update (hs.py:127); the norm
        # is GLOBAL (pad rows contribute exactly 0: their system is masked)
        cont = jnp.sqrt(lax.psum(jnp.sum(x * x), ax)) >= 1e-3
        if cfg.limit_update:
            x = jnp.clip(x, -1.0, 1.0)
        new_uv = median_pass(uv + x)
        uv = jnp.where(cont, new_uv, uv)
        return (k + 1, uv, cont)

    _, uv, _ = lax.while_loop(cond, body, (jnp.asarray(0), uv, jnp.asarray(True)))
    return uv


# ---------------------------------------------------------------------------
# host-callable wrappers
# ---------------------------------------------------------------------------

_spatial_cache: dict = {}


def _pad_images(images, pad):
    """Symmetric image pad == scipy-'reflect' filter reads beyond the edge."""
    return jnp.pad(images, ((0, pad), (0, 0), (0, 0)), mode="symmetric")


def classic_nl_level_step_spatial(cfg, images, color, uv, alpha, mesh,
                                  halo: int = 6, fallback=None):
    """Row-sharded ``classic_nl_level_step``.

    Unsupported *configurations* raise (:func:`check_spatial_config` — never
    a silent unsharded run); levels geometrically too small to tile (coarse
    pyramid levels) fall back single-device, which is the intended schedule:
    coarse levels run replicated, fine levels sharded.  ``fallback``
    overrides the single-device program used in that case (the BA wrapper
    passes its own level step, so the feasibility decision lives in ONE
    place — here).
    """
    H, W = images.shape[:2]
    check_spatial_config(cfg.irls.interp, cfg.irls.solver[0])
    n = int(mesh.shape[SPACE_AXIS])
    if cfg.use_color:
        boundary_radius = int(cfg.area_hsz)
    elif cfg.irls.median_filter_size is not None:
        boundary_radius = int(cfg.irls.median_filter_size[0]) // 2
    else:
        boundary_radius = 2
    margin = 2 if cfg.irls.interp == "cubic" else 0
    scfg = spatial_plan(H, W, n, boundary_radius, halo, warp_margin=margin)
    if scfg is None:
        if fallback is not None:
            return fallback()
        from optical_flow_tpu.methods.classic_nl import classic_nl_level_step

        return classic_nl_level_step(cfg, images, color, uv, alpha)

    # CG_ALGO is read at TRACE time (parallel/dist.py) — it must be part
    # of the key or an env/monkeypatch flip would silently reuse the old
    # program (the multihost gear A/B depends on this)
    from optical_flow_tpu.solvers import cg as _cg

    key = (cfg, scfg, mesh, _cg.CG_ALGO)
    if key not in _spatial_cache:
        spec = P(SPACE_AXIS)
        color_spec = spec if cfg.use_color else P()
        cubic = cfg.irls.interp == "cubic"
        smapped = shard_map(
            partial(classic_nl_level_local, cfg, scfg),
            mesh=mesh,
            in_specs=(spec, color_spec, spec, P(), spec),
            out_specs=spec,
            check_rep=False,
        )

        def run(images, color, uv, alpha):
            tables = ()
            if cubic:
                # global prefilter on the TRUE rows, before any padding
                tables = _global_spline_tables(images, cfg.irls.deriv_filter, scfg)
            if scfg.pad:
                images = _pad_images(images, scfg.pad)
                if cfg.use_color:
                    # color pad mirrors the median's np-'reflect'
                    color = jnp.pad(
                        color, ((0, scfg.pad), (0, 0), (0, 0)), mode="reflect"
                    )
                uv = jnp.pad(uv, ((0, scfg.pad), (0, 0), (0, 0)))
            out = smapped(images, color, uv, alpha, tables)
            out = out[:H] if scfg.pad else out
            if cfg.irls.guard:
                # guard on the GLOBAL view, outside shard_map: a per-shard
                # rollback would splice healthy and rolled-back tiles
                from optical_flow_tpu.utils.guard import guard_level

                out = guard_level(out, uv[:H], cfg.irls.guard)
            return out

        _spatial_cache[key] = jax.jit(run)
    return _spatial_cache[key](images, color, uv, jnp.asarray(alpha, uv.dtype))


def ba_level_step_spatial(cfg, images, uv, alpha, mesh, halo: int = 6):
    """Row-sharded ``ba_level_step`` (``cfg``: IRLSLevelConfig).

    The BA level body IS the Classic+NL local program with
    ``use_color=False``: identical α-blended IRLS solve, identical
    duv-trick median (``/root/reference/optical_flow/methods/ba.py:140-206``
    vs ``classic_nl.py:200-277``); the occlusion term is dead code and
    XLA-eliminated.
    """
    from optical_flow_tpu.methods.ba import ba_level_step
    from optical_flow_tpu.methods.classic_nl import NLLevelConfig

    ncfg = NLLevelConfig(
        irls=cfg, area_hsz=0, sigma_i=0.0, full_version=False, use_color=False
    )
    dummy_color = jnp.zeros((1, 1), uv.dtype)
    # the too-small-to-tile decision (and its boundary-radius/margin
    # derivation) lives in classic_nl_level_step_spatial alone; only the
    # single-device program it falls back to is BA's own
    return classic_nl_level_step_spatial(
        ncfg, images, dummy_color, uv, alpha, mesh, halo,
        fallback=lambda: ba_level_step(cfg, images, uv, alpha),
    )


def alt_ba_level_step_spatial(cfg, images, uv, uvhat, alpha, replacement,
                              mesh, halo: int = 6):
    """Row-sharded ``alt_ba_level_step`` (``cfg``: AltBALevelConfig).

    Both coupled fields shard over rows; levels too small to tile fall back
    to the single-device step (the intended coarse-level schedule).  The
    divergence guard runs on the GLOBAL (uv, uvhat) pair outside shard_map —
    a per-shard rollback would splice healthy and rolled-back tiles.
    """
    from optical_flow_tpu.methods.alt_ba import alt_ba_level_step

    irls = cfg.irls
    check_spatial_config(irls.interp, irls.solver[0])
    H, W = images.shape[:2]
    n = int(mesh.shape[SPACE_AXIS])
    mfsz = irls.median_filter_size
    br = int(mfsz[0]) // 2 if isinstance(mfsz, (tuple, list)) else (
        int(mfsz) // 2 if mfsz else 2
    )
    margin = 2 if irls.interp == "cubic" else 0
    scfg = spatial_plan(H, W, n, max(br, 2), halo, warp_margin=margin)
    if scfg is None:
        return alt_ba_level_step(cfg, images, uv, uvhat, alpha, replacement)

    # CG_ALGO is read at TRACE time (parallel/dist.py) — it must be part
    # of the key or an env/monkeypatch flip would silently reuse the old
    # program (the multihost gear A/B depends on this)
    from optical_flow_tpu.solvers import cg as _cg

    key = (cfg, scfg, mesh, _cg.CG_ALGO)
    if key not in _spatial_cache:
        spec = P(SPACE_AXIS)
        cubic = irls.interp == "cubic"
        smapped = shard_map(
            partial(alt_ba_level_local, cfg, scfg),
            mesh=mesh,
            in_specs=(spec, spec, spec, P(), P(), spec),
            out_specs=(spec, spec),
            check_rep=False,
        )

        def run(images, uv, uvhat, alpha, replacement):
            tables = ()
            if cubic:
                tables = _global_spline_tables(images, irls.deriv_filter, scfg)
            if scfg.pad:
                images = _pad_images(images, scfg.pad)
                uv = jnp.pad(uv, ((0, scfg.pad), (0, 0), (0, 0)))
                uvhat = jnp.pad(uvhat, ((0, scfg.pad), (0, 0), (0, 0)))
            out_uv, out_uvhat = smapped(images, uv, uvhat, alpha, replacement, tables)
            if scfg.pad:
                out_uv, out_uvhat = out_uv[:H], out_uvhat[:H]
            if irls.guard:
                from optical_flow_tpu.utils.guard import guard_level_pair

                out_uv, out_uvhat = guard_level_pair(
                    out_uv, out_uvhat, uv[:H], uvhat[:H], irls.guard
                )
            return out_uv, out_uvhat

        _spatial_cache[key] = jax.jit(run)
    return _spatial_cache[key](
        images, uv, uvhat, jnp.asarray(alpha, uv.dtype), jnp.asarray(replacement)
    )


def hs_level_step_spatial(cfg, images, uv, mesh, halo: int = 6):
    """Row-sharded ``hs_level_step`` (``cfg``: HSLevelConfig)."""
    H, W = images.shape[:2]
    check_spatial_config(cfg.interp, cfg.solver[0])
    n = int(mesh.shape[SPACE_AXIS])
    br = int(cfg.median_filter_size[0]) // 2 if cfg.median_filter_size else 2
    margin = 2 if cfg.interp == "cubic" else 0
    scfg = spatial_plan(H, W, n, br, halo, warp_margin=margin)
    if scfg is None:
        from optical_flow_tpu.methods.hs import hs_level_step

        return hs_level_step(cfg, images, uv)

    # CG_ALGO is read at TRACE time (parallel/dist.py) — it must be part
    # of the key or an env/monkeypatch flip would silently reuse the old
    # program (the multihost gear A/B depends on this)
    from optical_flow_tpu.solvers import cg as _cg

    key = (cfg, scfg, mesh, _cg.CG_ALGO)
    if key not in _spatial_cache:
        spec = P(SPACE_AXIS)
        cubic = cfg.interp == "cubic"
        smapped = shard_map(
            partial(hs_level_local, cfg, scfg),
            mesh=mesh,
            in_specs=(spec, spec, spec),
            out_specs=spec,
            check_rep=False,
        )

        def run(images, uv):
            tables = ()
            if cubic:
                tables = _global_spline_tables(images, cfg.deriv_filter, scfg)
            if scfg.pad:
                images = _pad_images(images, scfg.pad)
                uv = jnp.pad(uv, ((0, scfg.pad), (0, 0), (0, 0)))
            out = smapped(images, uv, tables)
            out = out[:H] if scfg.pad else out
            if cfg.guard:
                from optical_flow_tpu.utils.guard import guard_level

                out = guard_level(out, uv[:H], cfg.guard)
            return out

        _spatial_cache[key] = jax.jit(run)
    return _spatial_cache[key](images, uv)
