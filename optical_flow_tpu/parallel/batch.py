"""Batched (data-parallel) flow estimation over frame pairs.

The reference processes one pair per process (SURVEY §2); here a batch of
pairs of identical shape runs as one vmapped program, and the batch axis
shards over the ``batch`` mesh axis — XLA's partitioner keeps every pair
on its own device with zero communication.

The per-level programs (``hs_level_step`` / ``ba_level_step`` /
``classic_nl_level_step``) are pure functions of statically-configured
pytrees, so ``jax.vmap`` lifts the *entire* level solve — warping, IRLS,
CG, weighted median — without modification.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from optical_flow_tpu.config import load_of_method
from optical_flow_tpu.methods.classic_nl import (
    ClassicNLOpticalFlow,
    classic_nl_flow_program,
    classic_nl_level_resampled,
)
from optical_flow_tpu.methods.hs import HSOpticalFlow, hs_flow_program, hs_level_resampled
from optical_flow_tpu.methods.ba import BAOpticalFlow, ba_flow_program, ba_level_resampled
from optical_flow_tpu.methods.alt_ba import (
    AltBAOpticalFlow,
    alt_ba_flow_program,
    alt_ba_level_resampled,
)
from optical_flow_tpu.ops.rof import structure_texture_decomposition_rof
from optical_flow_tpu.utils.compat import scale_image
from optical_flow_tpu.parallel.mesh import BATCH_AXIS

_vmapped_cache = {}


def _vmapped(fn, n_array_args):
    """jit(vmap(level_resampled)): the inter-level flow resample is fused
    INSIDE the jitted program — per-call host work is one dispatch per
    level, with no eager ops in between."""
    key = (fn, n_array_args)
    if key not in _vmapped_cache:
        _vmapped_cache[key] = jax.jit(
            jax.vmap(fn, in_axes=(None,) + (0,) * n_array_args),
            static_argnums=(0,),
        )
    return _vmapped_cache[key]


def _median_pair_sized(size, uv):
    """(static size, uv) argument order for the :func:`_vmapped` helper."""
    from optical_flow_tpu.methods.base import jit_median_pair

    return jit_median_pair.__wrapped__(uv, size)


_pyramid_cache = {}


def _batched_pyramid(levels: int, spacing: float):
    """One jitted program building ALL pyramid levels of a (B, H, W) batch."""
    key = (levels, float(spacing))
    if key not in _pyramid_cache:
        from optical_flow_tpu.ops.pyramid import pyramid_filter, pyramid_shapes
        from optical_flow_tpu.ops.filters import correlate2d_multi
        from optical_flow_tpu.ops.interp import matlab_imresize_bilinear

        def build(pb):
            f = pyramid_filter(spacing)
            shapes = pyramid_shapes(pb.shape[1:3], levels, 1.0 / spacing)
            out = [pb]
            cur = pb
            for lvl in range(1, levels):
                smooth = jax.vmap(lambda im: correlate2d_multi(im, f, "reflect"))(cur)
                cur = jax.vmap(lambda im: matlab_imresize_bilinear(im, shapes[lvl]))(
                    smooth
                )
                out.append(cur)
            return tuple(out)

        _pyramid_cache[key] = jax.jit(build)
    return _pyramid_cache[key]


def preprocess_color_batch(im1_batch, im2_batch, dtype=jnp.float32):
    """(B, H, W, 3) RGB pairs -> (grayscale pair batch, [0,255]-Lab guides).

    The vmapped equivalent of the single-pair interface preprocessing
    (``interface.py:46-64``): MATLAB-exact rgb2gray + BT.709 rgb2lab.
    """
    from optical_flow_tpu.interface import _preprocess_color_pair

    im1_batch = jnp.asarray(im1_batch, dtype=dtype)
    im2_batch = jnp.asarray(im2_batch, dtype=dtype)
    return jax.jit(jax.vmap(_preprocess_color_pair.__wrapped__))(im1_batch, im2_batch)


_rgb_prog_cache = {}


def _vmapped_rgb(fn):
    """jit(vmap(flow_from_rgb)) with (plan, im1, im2, dtype) argument order."""
    if fn not in _rgb_prog_cache:
        _rgb_prog_cache[fn] = jax.jit(
            jax.vmap(fn, in_axes=(None, 0, 0, None)), static_argnums=(0, 3)
        )
    return _rgb_prog_cache[fn]


def estimate_flow_batched_rgb(
    im1_batch,
    im2_batch,
    method: str = "classic+nl-fast",
    mesh=None,
    params=None,
):
    """(B, H, W, 3) RGB frame pairs -> (B, H, W, 2) flows, ONE program.

    The batched analog of the single-pair from-RGB path: rgb2gray/rgb2lab
    preprocessing is folded into the vmapped whole-flow monolith and the
    frames ship in their smallest exact representation (uint8 for PNG-style
    integral data) — the serving shape: raw frames in, flows out, one
    dispatch per batch.  Falls back to ``preprocess_color_batch`` +
    :func:`estimate_flow_batched` when the method doesn't fuse (CPU
    default, or ``fuse=False`` / ``mesh`` given).
    """
    from optical_flow_tpu.interface import _maybe_cast_out, _ship_exact
    from optical_flow_tpu.methods.hs import hs_flow_from_rgb
    from optical_flow_tpu.methods.ba import ba_flow_from_rgb
    from optical_flow_tpu.methods.alt_ba import alt_ba_flow_from_rgb
    from optical_flow_tpu.methods.classic_nl import classic_nl_flow_from_rgb

    ope = load_of_method(method)
    if params is not None:
        ope.parse_input_parameter(params)
    if type(ope) not in (
        HSOpticalFlow, BAOpticalFlow, AltBAOpticalFlow, ClassicNLOpticalFlow
    ):
        raise ValueError(f"Batched estimation not supported for method '{method}'")

    im1_batch = np.asarray(im1_batch)
    im2_batch = np.asarray(im2_batch)
    H, W = im1_batch.shape[1:3]

    if ope._fuse_enabled() and mesh is None:
        a1 = _ship_exact(im1_batch, ope.dtype)
        a2 = _ship_exact(im2_batch, ope.dtype)
        if type(ope) is HSOpticalFlow:
            fn, plan = hs_flow_from_rgb, ope._make_plan((H, W))
        elif type(ope) is BAOpticalFlow:
            fn, plan = ba_flow_from_rgb, ope._make_plan((H, W))
        elif type(ope) is AltBAOpticalFlow:
            fn, plan = alt_ba_flow_from_rgb, ope._make_alt_plan((H, W))
        else:
            fn = classic_nl_flow_from_rgb
            plan = ope._make_nl_plan((H, W), use_color=ope.color_images is not None)
        uv = _vmapped_rgb(fn.__wrapped__)(plan, a1, a2, ope.dtype)
        return _maybe_cast_out(uv, ope.out_dtype)

    images, color = preprocess_color_batch(im1_batch, im2_batch, dtype=ope.dtype)
    want_color = ope.color_images is not None and type(ope) is ClassicNLOpticalFlow
    return estimate_flow_batched(
        images, method, mesh=mesh, params=params,
        color_batch=color if want_color else None,
    )


def estimate_flow_batched(
    images_batch,
    method: str = "hs-brightness",
    mesh=None,
    params=None,
    color_batch=None,
):
    """Estimate flow for a (B, H, W, 2) batch of frame pairs.

    All pairs share one pyramid schedule; every level runs as a single
    vmapped program.  With ``mesh`` given, the batch axis is sharded over
    its ``batch`` axis (pure data parallelism, no communication).

    ``color_batch`` — optional (B, H, W, 3) guides for the Classic+NL
    non-local term ([0,255]-scaled Lab of frame 1, as produced by
    :func:`preprocess_color_batch`).  With it, the batched path runs the
    SAME color-guided weighted median as the single-pair flagship; without
    it, the plain-median fallback applies (the reference's own behavior
    when color is absent, ``weighted_median.py:42-47``).

    On the GPU (``fuse=None`` auto, like the single-pair path) each pair's
    ENTIRE coarse-to-fine flow runs as one vmapped whole-flow program —
    one dispatch per batch instead of one per pyramid level.
    ``fuse=False`` (via ``params``) keeps the per-level batched programs; a
    ``mesh`` also forces per-level (the Pallas weighted-median call has no
    SPMD partitioning rule, so the fused program cannot be sharded).

    Supports all four method families: HS / BA / Alt-BA / Classic+NL.
    """
    ope = load_of_method(method)
    if params is not None:
        ope.parse_input_parameter(params)
    if type(ope) not in (
        HSOpticalFlow, BAOpticalFlow, AltBAOpticalFlow, ClassicNLOpticalFlow
    ):
        # exact-type dispatch: a custom subclass must not silently run as
        # its parent family
        raise ValueError(f"Batched estimation not supported for method '{method}'")

    images_batch = jnp.asarray(images_batch, dtype=ope.dtype)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        sharding = NamedSharding(mesh, P(BATCH_AXIS))
        images_batch = jax.device_put(images_batch, sharding)
        if color_batch is not None:
            color_batch = jax.device_put(
                jnp.asarray(color_batch, dtype=ope.dtype), sharding
            )
    B, H, W = images_batch.shape[:3]
    npdt = np.dtype(ope.dtype)

    def cast(uv):
        from optical_flow_tpu.interface import _maybe_cast_out

        return _maybe_cast_out(uv, ope.out_dtype)

    fused = ope._fuse_enabled() and mesh is None

    if fused:
        uv0 = np.zeros((B, H, W, 2), dtype=npdt)
        if type(ope) is HSOpticalFlow:
            prog = _vmapped(hs_flow_program.__wrapped__, 2)
            return cast(prog(ope._make_plan((H, W)), images_batch, uv0))
        if type(ope) is BAOpticalFlow:
            prog = _vmapped(ba_flow_program.__wrapped__, 2)
            return cast(prog(ope._make_plan((H, W)), images_batch, uv0))
        if type(ope) is AltBAOpticalFlow:
            prog = _vmapped(alt_ba_flow_program.__wrapped__, 3)
            return cast(prog(ope._make_alt_plan((H, W)), images_batch, uv0, uv0))
        use_color = color_batch is not None
        plan = ope._make_nl_plan((H, W), use_color=use_color)
        color = (
            jnp.asarray(color_batch, dtype=ope.dtype)
            if use_color
            else np.zeros((B, 1, 1), dtype=npdt)
        )
        prog = _vmapped(classic_nl_flow_program.__wrapped__, 3)
        return cast(prog(plan, images_batch, color, uv0))

    # preprocessing, batched (scale_image normalizes per pair); Alt-BA's
    # texture path pins alp=0.95 regardless of self.alp (the reference's
    # own quirk — alt_ba.py:101-104, mirrored in AltBA.compute_flow)
    alp = 0.95 if isinstance(ope, AltBAOpticalFlow) else ope.alp
    if ope.texture:
        pre = jax.jit(jax.vmap(lambda im: structure_texture_decomposition_rof(im, 1.0 / 8, 100, alp)))
    else:
        pre = jax.jit(jax.vmap(lambda im: scale_image(im, 0, 255)))
    proc = pre(images_batch)

    if ope.auto_level:
        from optical_flow_tpu.ops.pyramid import auto_pyramid_levels

        ope.pyramid_levels = auto_pyramid_levels((H, W), ope.pyramid_spacing)

    # All per-level host work below is ONE jitted dispatch per level (the
    # flow resample rides inside the level program); alphas and the zero
    # init are numpy constants, so nothing in the loop dispatches eagerly.
    uv = np.zeros((B, H, W, 2), dtype=npdt)
    alpha = 1.0

    if isinstance(ope, HSOpticalFlow):
        cfg = ope._level_cfg()
        pyramid = _batched_pyramid(ope.pyramid_levels, ope.pyramid_spacing)(proc)
        step = _vmapped(hs_level_resampled.__wrapped__, 2)
        for level in range(ope.pyramid_levels - 1, -1, -1):
            uv = step(cfg, pyramid[level], uv)
        if cfg.median_filter_size is not None:
            # final median pass (reference hs.py:95-97) — the fused program
            # applies it inside hs_flow_program
            uv = _vmapped(_median_pair_sized, 1)(cfg.median_filter_size, uv)
        return cast(uv)

    if isinstance(ope, ClassicNLOpticalFlow):
        use_color = color_batch is not None
        pyr = _batched_pyramid(ope.pyramid_levels, ope.pyramid_spacing)
        gnc_pyr = _batched_pyramid(ope.gnc_pyramid_levels, ope.gnc_pyramid_spacing)
        pyramid, gnc_pyramid = pyr(proc), gnc_pyr(proc)
        if use_color:
            color_pyr, color_gnc_pyr = pyr(color_batch), gnc_pyr(color_batch)
        dummy_guide = np.zeros((B, 1, 1), dtype=npdt)
        step = _vmapped(classic_nl_level_resampled.__wrapped__, 4)
        for ignc in range(ope.gnc_iters):
            if ignc == 0:
                levels, cur = ope.pyramid_levels, pyramid
                ccur = color_pyr if use_color else None
            else:
                levels, cur = ope.gnc_pyramid_levels, gnc_pyramid
                ccur = color_gnc_pyr if use_color else None
            cfg = ope._nl_cfg(use_color=use_color, max_linear=1 if ignc == 0 else None)
            for level in range(levels - 1, -1, -1):
                guide = ccur[level] if use_color else dummy_guide
                uv = step(cfg, cur[level], guide, uv, np.full((B,), alpha, npdt))
            if ope.gnc_iters > 1:
                alpha = max(0.0, min(alpha, 1.0 - (ignc + 1) / (ope.gnc_iters - 1)))
        return cast(uv)

    if isinstance(ope, AltBAOpticalFlow):
        # must dispatch before the BAOpticalFlow branch (AltBA subclasses BA)
        pyramid = _batched_pyramid(ope.pyramid_levels, ope.pyramid_spacing)(proc)
        gnc_pyramid = _batched_pyramid(ope.gnc_pyramid_levels, ope.gnc_pyramid_spacing)(proc)
        step = _vmapped(alt_ba_level_resampled.__wrapped__, 5)
        uvhat = uv
        for ignc in range(ope.gnc_iters):
            replacement = ignc != ope.gnc_iters - 1
            levels, cur = (
                (ope.pyramid_levels, pyramid)
                if ignc == 0
                else (ope.gnc_pyramid_levels, gnc_pyramid)
            )
            cfg = ope._alt_cfg()
            for level in range(levels - 1, -1, -1):
                uv, uvhat = step(
                    cfg, cur[level], uv, uvhat, np.full((B,), alpha, npdt),
                    np.full((B,), replacement),
                )
            if ope.gnc_iters > 1:
                alpha = max(0.0, min(alpha, 1.0 - (ignc + 1) / (ope.gnc_iters - 1)))
        # Alt-BA returns the auxiliary field (alt_ba.py:185-187)
        return cast(uvhat)

    if isinstance(ope, BAOpticalFlow):
        pyramid = _batched_pyramid(ope.pyramid_levels, ope.pyramid_spacing)(proc)
        gnc_pyramid = _batched_pyramid(ope.gnc_pyramid_levels, ope.gnc_pyramid_spacing)(proc)
        step = _vmapped(ba_level_resampled.__wrapped__, 3)
        for ignc in range(ope.gnc_iters):
            levels, cur = (
                (ope.pyramid_levels, pyramid)
                if ignc == 0
                else (ope.gnc_pyramid_levels, gnc_pyramid)
            )
            cfg = ope._level_cfg(max_linear=1 if ignc == 0 else None)
            for level in range(levels - 1, -1, -1):
                uv = step(cfg, cur[level], uv, np.full((B,), alpha, npdt))
            if ope.gnc_iters > 1:
                alpha = max(0.0, min(alpha, 1.0 - (ignc + 1) / (ope.gnc_iters - 1)))
        return cast(uv)

    raise ValueError(f"Batched estimation not supported for method '{method}'")
