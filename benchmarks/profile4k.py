#!/usr/bin/env python
"""4K stage profile: where does the time go at 3840x2160?

Times each pipeline stage of classic+nl-fast at the finest (full-res)
pyramid level — the level that dominates end-to-end wall time — plus the
preprocessing / pyramid build, and the end-to-end flow.  Each stage is its
own jitted program, warmed once and timed over `--reps` repeats with device
synchronization.

Accounting: at 4K, classic+nl-fast runs its finest level in both GNC
stages (3 warp iterations each, max_linear=1), so e2e wall time should be
roughly  preprocess + pyramids + 6 x (warp_deriv + solve + occlusion +
wmedian) at full res  + the coarser-level tail.

    python benchmarks/profile4k.py [--reps 3] [--fused]

Prints a table to stderr; stdout stays clean (one JSON line).
"""
import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def timed(fn, *args, reps=3):
    """Jit ``fn``, warm once, then best-of-reps wall time, each rep ended by
    ``block_until_ready``."""
    import jax

    cfn = jax.jit(fn)
    out = jax.block_until_ready(cfn(*args))
    trials = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(cfn(*args))
        trials.append(time.perf_counter() - t0)
    return min(trials), out


def timed_host(fn, reps=3):
    """Like :func:`timed` for host-orchestrated pipelines (not jittable as
    one program)."""
    import jax

    out = jax.block_until_ready(fn())
    trials = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        trials.append(time.perf_counter() - t0)
    return min(trials), out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--height", type=int, default=2160)
    ap.add_argument("--width", type=int, default=3840)
    ap.add_argument("--fused", action="store_true", help="also time the fused monolith e2e")
    ap.add_argument("--skip-e2e", action="store_true")
    ap.add_argument(
        "--stage2-detail", action="store_true",
        help="decompose the stage-2 coarse level (1728x3072 at 4K) into its"
        " components with per-component efficiency vs the area-scaled"
        " finest-level kernels",
    )
    ap.add_argument(
        "--solver", default="pcg",
        help="pcg (default; what bench.py runs) or backslash (tight CG)",
    )
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from optical_flow_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from optical_flow_tpu.config import load_of_method
    from optical_flow_tpu.methods.ba import _blended_solve, irls_prepare
    from optical_flow_tpu.ops.derivatives import precompute_warp, warp_deriv
    from optical_flow_tpu.ops.occlusion import detect_occlusion
    from optical_flow_tpu.ops.pyramid import auto_pyramid_levels
    from optical_flow_tpu.ops.wmedian import denoise_color_weighted_medfilt2

    log("devices:", jax.devices())
    H, W = args.height, args.width
    rng = np.random.default_rng(0)
    from scipy.ndimage import gaussian_filter

    base = gaussian_filter(rng.uniform(0, 255, (H, W)), 1.5).astype(np.float32)
    im2 = np.roll(base, 2, axis=1)
    images = jnp.stack([jnp.asarray(base), jnp.asarray(im2)], 2)

    ope = load_of_method("classic+nl-fast")
    ope.display = False
    ope.solver = args.solver
    cfg = ope._nl_cfg(use_color=False, max_linear=1)
    irls = cfg.irls
    levels = auto_pyramid_levels((H, W), ope.pyramid_spacing)
    log(f"profiling {W}x{H}, pyramid levels={levels}, "
        f"warp_iters={irls.max_iters} x gnc_stages={ope.gnc_iters}")

    stages = {}

    # --- preprocessing: ROF structure-texture + both texture pyramids ----
    prep = jax.jit(
        lambda im: irls_prepare(
            im, ope._preprocess_kind(), float(ope.alp), levels,
            float(ope.pyramid_spacing),
            (int(ope.gnc_pyramid_levels), float(ope.gnc_pyramid_spacing)),
        )
    )
    dt, (pyr, gnc_pyr) = timed(prep, images, reps=args.reps)
    stages["rof+pyramids"] = dt
    proc = pyr[0]

    # --- finest-level components (what the warp loop runs 6x at full res)
    uv = jnp.zeros((H, W, 2), dtype=jnp.float32)

    from optical_flow_tpu.ops.derivatives import WarpPrecompute

    # WarpPrecompute carries static leaves (method str, blend float); only the
    # array fields may cross the jit boundary.
    def pre_arrays(im):
        p = precompute_warp(im, irls.interp, np.array(irls.deriv_filter), irls.blend)
        return (p.im1, p.I1x, p.I1y, p.warp_tables, p.hermite_tables)

    dt, arrs = timed(jax.jit(pre_arrays), proc, reps=args.reps)
    stages["precompute_warp (spline prefilter)"] = dt

    # realistic sub-pixel flow so the gather hits the sweep path like a real run
    uv_live = uv + 0.3 * jnp.sin(jnp.arange(H * W * 2, dtype=jnp.float32).reshape(H, W, 2))

    def wd(arrs, f):
        p = WarpPrecompute(irls.interp, float(irls.blend), *arrs)
        return warp_deriv(p, f)

    wd_fn = jax.jit(wd)
    dt, (It, Ix, Iy) = timed(wd_fn, arrs, uv_live, reps=args.reps)
    stages["warp_deriv (bicubic warp gathers)"] = dt

    solve_fn = jax.jit(
        lambda uv, duv, It, Ix, Iy, a: _blended_solve(irls, uv, duv, It, Ix, Iy, a)
    )
    z = jnp.zeros_like(uv)
    dt, duv = timed(solve_fn, uv_live, z, It, Ix, Iy, jnp.float32(0.5), reps=args.reps)
    stages["irls system + PCG solve"] = dt

    occ_fn = jax.jit(lambda f, im: detect_occlusion(f, im))
    dt, occ = timed(occ_fn, uv_live, proc, reps=args.reps)
    stages["occlusion"] = dt

    wm_fn = jax.jit(
        lambda f, o: denoise_color_weighted_medfilt2(
            f, None, o, cfg.area_hsz, irls.median_filter_size, cfg.sigma_i,
            cfg.full_version,
        )
    )
    dt, _ = timed(wm_fn, uv_live, occ, reps=args.reps)
    stages["weighted median"] = dt

    per_iter = (
        stages["warp_deriv (bicubic warp gathers)"]
        + stages["irls system + PCG solve"]
        + stages["occlusion"]
        + stages["weighted median"]
    )
    finest_iters = 2 * irls.max_iters  # finest level runs in both GNC stages

    # --- the coarse tail (the r2 accounting gap): stage-1 levels 1..L-1
    # as ONE jitted program (resamples included), and the stage-2 coarse
    # level (spacing 1.25 => ~0.64x the full-res area — NOT small) --------
    from optical_flow_tpu.methods.classic_nl import classic_nl_level_step
    from optical_flow_tpu.ops.resample import resample_flow

    dummy = jnp.zeros((1, 1), jnp.float32)

    def stage1_tail(pyr_arrays, alpha):
        f = jnp.zeros((*pyr_arrays[-1].shape[:2], 2), jnp.float32)
        for lvl in range(levels - 1, 0, -1):
            f = resample_flow(f, pyr_arrays[lvl].shape[:2])
            f = classic_nl_level_step(cfg, pyr_arrays[lvl], dummy, f, alpha)
        # plus the final resample up to full res that precedes the finest level
        return resample_flow(f, pyr_arrays[0].shape[:2])

    dt, uv_tail = timed(stage1_tail, tuple(pyr), jnp.float32(1.0), reps=args.reps)
    stages["stage1 coarse tail (levels 1..%d + resamples)" % (levels - 1)] = dt

    def stage2_coarse(gp, f, alpha):
        f = resample_flow(f, gp[1].shape[:2])
        f = classic_nl_level_step(cfg, gp[1], dummy, f, alpha)
        return resample_flow(f, gp[0].shape[:2])

    dt, _ = timed(stage2_coarse, tuple(gnc_pyr), uv_tail, jnp.float32(0.0), reps=args.reps)
    stages["stage2 coarse level (%dx%d + resamples)" % gnc_pyr[1].shape[:2]] = dt

    results_stage2 = None
    # --- stage-2 component decomposition --------------------------------
    # The stage-2 coarse level is the same kernels as the finest level at
    # 1/spacing^2 = 0.64x the pixel count: if each component's time is
    # ~0.64x its finest-level time, the level runs at the same per-pixel
    # efficiency as the full-res kernels.
    if args.stage2_detail:
        H2, W2 = gnc_pyr[1].shape[:2]
        proc2 = gnc_pyr[1]
        area = (H2 * W2) / (H * W)
        s2 = {}
        dt, arrs2 = timed(jax.jit(pre_arrays), proc2, reps=args.reps)
        s2["precompute_warp"] = dt
        uv2 = resample_flow(uv_tail, (H2, W2))
        uv2_live = uv2 + 0.3 * jnp.sin(
            jnp.arange(H2 * W2 * 2, dtype=jnp.float32).reshape(H2, W2, 2)
        )
        dt, (It2, Ix2, Iy2) = timed(wd_fn, arrs2, uv2_live, reps=args.reps)
        s2["warp_deriv"] = dt
        z2 = jnp.zeros_like(uv2)
        dt, _ = timed(
            solve_fn, uv2_live, z2, It2, Ix2, Iy2, jnp.float32(0.0), reps=args.reps,
        )
        s2["irls+solve"] = dt
        dt, occ2 = timed(occ_fn, uv2_live, proc2, reps=args.reps)
        s2["occlusion"] = dt
        dt, _ = timed(wm_fn, uv2_live, occ2, reps=args.reps)
        s2["weighted median"] = dt

        from optical_flow_tpu.ops.wmedian import _impl_for

        finest_of = {
            "warp_deriv": "warp_deriv (bicubic warp gathers)",
            "irls+solve": "irls system + PCG solve",
            "occlusion": "occlusion",
            "weighted median": "weighted median",
            "precompute_warp": "precompute_warp (spline prefilter)",
        }
        detail = {}
        log(f"\nstage-2 level {W2}x{H2} (area ratio {area:.3f}):")
        for k, v in s2.items():
            fin = stages[finest_of[k]]
            eff = v / (fin * area) if fin > 0 else float("nan")
            detail[k] = {
                "s": round(v, 4),
                "finest_s": round(fin, 4),
                "vs_area_scaled_finest": round(eff, 3),
            }
            log(f"  {k:<18} {v*1000:8.1f} ms   ({eff:.2f}x of area-scaled finest)")
        detail["_wmedian_impl"] = _impl_for(H2, W2, cfg.area_hsz, 1, jnp.float32)
        results_stage2 = detail

    accounted = (
        stages["rof+pyramids"]
        + 2 * stages["precompute_warp (spline prefilter)"]
        + finest_iters * per_iter
        + stages["stage1 coarse tail (levels 1..%d + resamples)" % (levels - 1)]
        + stages["stage2 coarse level (%dx%d + resamples)" % gnc_pyr[1].shape[:2]]
    )

    # --- end-to-end -------------------------------------------------------
    results = {
        "shape": [H, W],
        "levels": levels,
        "stages_s": {k: round(v, 4) for k, v in stages.items()},
        "per_warp_iter_s": round(per_iter, 4),
        "finest_level_iters": finest_iters,
        "accounted_s": round(accounted, 3),
        "accounting_note": (
            "accounted = rof+pyramids + 2*precompute + finest_iters*per_iter"
            " + stage1 coarse tail + stage2 coarse level; the remaining gap vs"
            " e2e is per-level dispatch (per-level path only)"
        ),
    }
    if results_stage2 is not None:
        results["stage2_detail"] = results_stage2

    if not args.skip_e2e:
        ope2 = load_of_method("classic+nl-fast")
        ope2.display = False
        ope2.solver = args.solver
        ope2.fuse = False  # per-level programs: comparable to the r1 number
        ope2.images = images
        dt, _ = timed_host(lambda: ope2.compute_flow(), reps=max(1, args.reps - 1))
        results["e2e_perlevel_s"] = round(dt, 3)
        log(f"e2e (per-level): {dt:.2f}s  accounted: {accounted:.2f}s")

    if args.fused:
        ope3 = load_of_method("classic+nl-fast")
        ope3.display = False
        ope3.solver = args.solver
        ope3.fuse = True
        ope3.images = images
        dt, _ = timed_host(lambda: ope3.compute_flow(), reps=max(1, args.reps - 1))
        results["e2e_fused_s"] = round(dt, 3)
        log(f"e2e (fused): {dt:.2f}s")

    width = max(len(k) for k in stages)
    for k, v in stages.items():
        log(f"  {k:<{width}}  {v * 1000:9.1f} ms")
    log(f"  {'per warp iter (x' + str(finest_iters) + ' at full res)':<{width}}  {per_iter * 1000:9.1f} ms")

    dev = jax.devices()[0]
    print(json.dumps({
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "metric": f"classic+nl-fast s/frame @{W}x{H}",
        "value": results.get("e2e_perlevel_s", results["accounted_s"]),
        "unit": "s",
        **results,
    }))


if __name__ == "__main__":
    main()
