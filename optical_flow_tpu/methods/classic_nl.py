"""Classic+NL optical flow: robust IRLS + non-local weighted-median term.

Reference: ``methods/classic_nl.py``.  Structure follows BA, with the
non-local step after each linear solve: occlusion detection + color-guided
weighted median filtering applied through the duv trick
(``classic_nl.py:260-275``).  Three pyramids (texture, original, Lab color)
are maintained per GNC stage set (``classic_nl.py:120-136``).
"""
from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from optical_flow_tpu.methods.ba import (
    BAOpticalFlow,
    IRLSLevelConfig,
    _blended_solve,
    irls_prepare,
)
from optical_flow_tpu.ops.pyramid import pyramid_pair
from optical_flow_tpu.ops.derivatives import precompute_warp, warp_deriv
from optical_flow_tpu.ops.occlusion import detect_occlusion
from optical_flow_tpu.ops.penalties import Robust
from optical_flow_tpu.ops.resample import resample_flow
from optical_flow_tpu.ops.wmedian import denoise_color_weighted_medfilt2


@dataclasses.dataclass(frozen=True)
class NLLevelConfig:
    """Static per-level configuration for Classic+NL."""

    irls: IRLSLevelConfig
    area_hsz: int
    sigma_i: float
    full_version: bool
    use_color: bool


@partial(jax.jit, static_argnums=(0,))
def classic_nl_level_step(cfg: NLLevelConfig, images, color_images, uv, alpha):
    """One pyramid level of Classic+NL (``classic_nl.py:200-277``)."""
    irls = cfg.irls
    pre = precompute_warp(images, irls.interp, np.array(irls.deriv_filter), irls.blend)

    def warp_iter(_, uv):
        It, Ix, Iy = warp_deriv(pre, uv)
        duv = jnp.zeros_like(uv)
        for _j in range(irls.max_linear):
            duv = _blended_solve(irls, uv, duv, It, Ix, Iy, alpha)
            if irls.median_filter_size is not None:
                new_uv = uv + duv
                occ = detect_occlusion(new_uv, images)
                filtered = denoise_color_weighted_medfilt2(
                    new_uv,
                    color_images if cfg.use_color else None,
                    occ,
                    cfg.area_hsz,
                    irls.median_filter_size,
                    cfg.sigma_i,
                    cfg.full_version,
                )
                duv = filtered - uv
        return uv + duv

    out = jax.lax.fori_loop(0, irls.max_iters, warp_iter, uv)
    if irls.guard:
        from optical_flow_tpu.utils.guard import guard_level

        out = guard_level(out, uv, irls.guard)
    return out


@dataclasses.dataclass(frozen=True)
class NLFlowPlan:
    """Static whole-flow schedule for Classic+NL."""

    preprocess: str
    alp: float
    levels: int
    spacing: float
    gnc_levels: int
    gnc_spacing: float
    shapes: Tuple[Tuple[int, int], ...]
    gnc_shapes: Tuple[Tuple[int, int], ...]
    stages: Tuple[Tuple[NLLevelConfig, float], ...]
    use_color: bool


@partial(jax.jit, static_argnums=(0,))
def classic_nl_level_resampled(cfg: NLLevelConfig, images, color_images, uv, alpha):
    """Level step with the inter-level flow resample fused in (1 dispatch)."""
    from optical_flow_tpu.ops.resample import resample_flow

    uv = resample_flow(uv, images.shape[:2])
    return classic_nl_level_step(cfg, images, color_images, uv, alpha)


@partial(jax.jit, static_argnums=(0,))
def classic_nl_flow_program(plan: NLFlowPlan, images, color, uv):
    """Whole GNC + coarse-to-fine Classic+NL flow as one device program.

    The original-image pyramid of the reference feeds only the inert
    ``seg`` attribute (``classic_nl.py:174``), so it is not built here;
    the Lab color pyramid (the weighted-median guide) is.
    """
    from optical_flow_tpu.methods.ba import _preprocess_traced
    from optical_flow_tpu.ops.pyramid import build_pyramid
    from optical_flow_tpu.ops.resample import resample_flow

    proc = _preprocess_traced(plan.preprocess, images, plan.alp)
    pyramid = build_pyramid(proc, plan.levels, plan.spacing)
    gnc_pyramid = build_pyramid(proc, plan.gnc_levels, plan.gnc_spacing)
    if plan.use_color:
        color_pyr = build_pyramid(color, plan.levels, plan.spacing)
        color_gnc_pyr = build_pyramid(color, plan.gnc_levels, plan.gnc_spacing)
    else:
        dummy = jnp.zeros((1, 1), dtype=uv.dtype)
        color_pyr = [dummy] * plan.levels
        color_gnc_pyr = [dummy] * plan.gnc_levels

    for stage_idx, (cfg, alpha) in enumerate(plan.stages):
        if stage_idx == 0:
            levels, cur, ccur, shapes = plan.levels, pyramid, color_pyr, plan.shapes
        else:
            levels, cur, ccur, shapes = (
                plan.gnc_levels,
                gnc_pyramid,
                color_gnc_pyr,
                plan.gnc_shapes,
            )
        for level in range(levels - 1, -1, -1):
            uv = resample_flow(uv, shapes[level])
            uv = classic_nl_level_step(
                cfg, cur[level], ccur[level], uv, jnp.asarray(alpha, uv.dtype)
            )
    return uv


@partial(jax.jit, static_argnums=(0, 3))
def classic_nl_flow_from_rgb(plan: NLFlowPlan, im1, im2, dtype):
    """Preprocessing + the whole Classic+NL flow as one device program.

    Folds the reference's host-side rgb2gray / rgb2lab / [0,255] rescale
    (``interface.py:46-64``) into the monolith so the raw frame pair (uint8
    when exact) is the only host->device transfer and ONE dispatch covers
    the entire estimation.
    """
    from optical_flow_tpu.utils.compat import preprocess_color_pair, rgb2gray

    im1 = jnp.asarray(im1, dtype)
    im2 = jnp.asarray(im2, dtype)
    if plan.use_color:
        images, color = preprocess_color_pair(im1, im2)
    else:
        images = jnp.stack([rgb2gray(im1), rgb2gray(im2)], axis=2)
        color = jnp.zeros((1, 1), dtype)
    uv = jnp.zeros((*images.shape[:2], 2), dtype)
    return classic_nl_flow_program(plan, images, color, uv)


@partial(jax.jit, static_argnums=(0, 3))
def classic_nl_flow_from_gray(plan: NLFlowPlan, im1, im2, dtype):
    """Raw grayscale pair + the whole Classic+NL flow as ONE device program.

    The weighted-median guide for grayscale input is the raw first frame
    itself (reference ``interface.py:61-63``: ``lab1 = im1.copy()`` — no Lab
    conversion, no rescale), exactly as the per-stage path receives it.
    """
    im1 = jnp.asarray(im1, dtype)
    im2 = jnp.asarray(im2, dtype)
    images = jnp.stack([im1, im2], axis=2)
    color = im1 if plan.use_color else jnp.zeros((1, 1), dtype)
    uv = jnp.zeros((*images.shape[:2], 2), dtype)
    return classic_nl_flow_program(plan, images, color, uv)


class ClassicNLOpticalFlow(BAOpticalFlow):
    """Classic+NL with generalized Charbonnier penalties and NL term."""

    def __init__(self):
        super().__init__()
        self.lambda_ = 1.0
        self.lambda_q = 1.0
        self.lambda2 = 0.1
        self.lambda3 = 1.0
        self.solver = "backslash"
        self.texture = False
        self.fc = False
        self.median_filter_size = None
        self.interpolation_method = "bi-cubic"

        self.gnc_iters = 3
        self.alpha = 1.0
        self.max_iters = 10
        self.max_linear = 1
        self.pyramid_levels = 4
        self.pyramid_spacing = 2.0
        self.gnc_pyramid_levels = 2
        self.gnc_pyramid_spacing = 1.25

        method = "generalized_charbonnier"
        a = 0.45
        sig = 1e-3
        self.rho_spatial_u = [Robust(method, (sig, a)), Robust(method, (sig, a))]
        self.rho_spatial_v = [Robust(method, (sig, a)), Robust(method, (sig, a))]
        self.rho_data = Robust(method, (sig, a))

        # non-local / segmentation settings (classic_nl.py:72-87)
        self.seg = None
        self.mfT = 15
        self.imfsz = [7, 7]
        self.filter_weight = None
        self.alp = 0.95
        self.hybrid = False
        self.area_hsz = 10
        self.affine_hsz = 4
        self.sigma_i = 7
        self.color_images = None
        self.auto_level = True
        self.input_seg = None
        self.input_occ = None
        self.fullVersion = False

    # ------------------------------------------------------------------
    def _quadratic_relaxation(self):
        """Classic+NL reuses each penalty's own sigma (``classic_nl.py:216-226``)."""
        qsu = tuple(Robust("quadratic", (r.param[0],)) for r in self.rho_spatial_u)
        qsv = tuple(Robust("quadratic", (r.param[0],)) for r in self.rho_spatial_v)
        qd = Robust("quadratic", (self.rho_data.param[0],))
        return qsu, qsv, qd

    def _nl_cfg(self, use_color: bool, max_linear=None) -> NLLevelConfig:
        return NLLevelConfig(
            irls=self._level_cfg(max_linear=max_linear),
            area_hsz=int(self.area_hsz),
            sigma_i=float(self.sigma_i),
            full_version=bool(self.fullVersion),
            use_color=use_color,
        )

    def _make_nl_plan(self, sz, use_color: bool) -> NLFlowPlan:
        """Static whole-flow schedule for ``classic_nl_flow_program``."""
        from optical_flow_tpu.ops.pyramid import auto_pyramid_levels, pyramid_shapes

        if self.auto_level:
            self.pyramid_levels = auto_pyramid_levels(sz, self.pyramid_spacing)
        stages = tuple(
            (self._nl_cfg(use_color=use_color, max_linear=1 if i == 0 else None), alpha)
            for i, alpha in enumerate(self._gnc_alphas())
        )
        return NLFlowPlan(
            preprocess=self._preprocess_kind(),
            alp=float(self.alp),
            levels=int(self.pyramid_levels),
            spacing=float(self.pyramid_spacing),
            gnc_levels=int(self.gnc_pyramid_levels),
            gnc_spacing=float(self.gnc_pyramid_spacing),
            shapes=tuple(pyramid_shapes(sz, self.pyramid_levels, 1.0 / self.pyramid_spacing)),
            gnc_shapes=tuple(
                pyramid_shapes(sz, self.gnc_pyramid_levels, 1.0 / self.gnc_pyramid_spacing)
            ),
            stages=stages,
            use_color=use_color,
        )

    # ------------------------------------------------------------------
    def compute_flow_from_rgb(self, im1, im2):
        if not (
            self._fuse_enabled()
            and self.spatial_mesh is None
            and not self.display
            and self.checkpoint is None
            and type(self) is ClassicNLOpticalFlow
        ):
            return None
        sz = tuple(int(s) for s in im1.shape[:2])
        plan = self._make_nl_plan(sz, use_color=self.color_images is not None)
        return classic_nl_flow_from_rgb(plan, im1, im2, self.dtype)

    def compute_flow_from_gray(self, im1, im2):
        if not (
            self._fuse_enabled()
            and self.spatial_mesh is None
            and not self.display
            and self.checkpoint is None
            and type(self) is ClassicNLOpticalFlow
        ):
            return None
        sz = tuple(int(s) for s in im1.shape[:2])
        plan = self._make_nl_plan(sz, use_color=self.color_images is not None)
        return classic_nl_flow_from_gray(plan, im1, im2, self.dtype)

    def compute_flow(self, init=None, gt=None):
        """GNC + coarse-to-fine with triple pyramids (``classic_nl.py:89-198``)."""
        images = self._as_dtype(self.images)
        sz = images.shape[:2]
        uv = jnp.zeros((*sz, 2), dtype=self.dtype) if init is None else self._as_dtype(init)

        color = None
        if self.color_images is not None:
            color = self._as_dtype(self.color_images)
            # the (1,1,3) placeholder from the config table means "no color"
            if int(np.prod(color.shape[:2])) < sz[0] * sz[1]:
                color = None

        if (self._fuse_enabled() and self.spatial_mesh is None and not self.display and gt is None
                and self.checkpoint is None and type(self) is ClassicNLOpticalFlow):
            plan = self._make_nl_plan(sz, use_color=color is not None)
            if color is None:
                color = jnp.zeros((1, 1), dtype=self.dtype)
            return classic_nl_flow_program(plan, images, color, uv)

        if self.auto_level:
            self.pyramid_levels = self._auto_pyramid_levels(images)

        # preprocessing + both texture pyramids fused into one dispatch;
        # the original-image pyramid of the reference feeds only the inert
        # ``seg`` attribute (classic_nl.py:174) and is not built
        pyr, gnc_pyr = irls_prepare(
            images,
            self._preprocess_kind(),
            float(self.alp),
            int(self.pyramid_levels),
            float(self.pyramid_spacing),
            (int(self.gnc_pyramid_levels), float(self.gnc_pyramid_spacing)),
        )
        if color is not None:
            color_pyr, color_gnc_pyr = pyramid_pair(
                color,
                int(self.pyramid_levels),
                float(self.pyramid_spacing),
                int(self.gnc_pyramid_levels),
                float(self.gnc_pyramid_spacing),
            )
        else:
            color_pyr = [None] * self.pyramid_levels
            color_gnc_pyr = [None] * self.gnc_pyramid_levels

        start_time = time.time()
        alpha = float(self.alpha)

        for ignc in range(self.gnc_iters):
            if self.display:
                print(f"GNC stage: {ignc + 1}")
            if ignc == 0:
                levels = self.pyramid_levels
                cur, cur_color = pyr, color_pyr
            else:
                levels = self.gnc_pyramid_levels
                cur, cur_color = gnc_pyr, color_gnc_pyr

            cfg = self._nl_cfg(
                use_color=color is not None,
                max_linear=1 if ignc == 0 else None,
            )
            for level in range(levels - 1, -1, -1):
                if self.display:
                    print(f"  Pyramid level: {level + 1}")
                nsz = cur[level].shape[:2]
                # the adaptive affine window (classic_nl.py:176) only matters
                # for the (unimplemented-in-reference) full version
                self.affine_hsz = min(4, max(2, int(np.ceil(min(nsz) / 75))))
                color_level = cur_color[level]
                if color_level is None:
                    color_level = jnp.zeros((1, 1), dtype=self.dtype)
                if self.spatial_mesh is not None:
                    from optical_flow_tpu.parallel.spatial import (
                        classic_nl_level_step_spatial,
                    )

                    uv = resample_flow(uv, tuple(int(s) for s in nsz))
                    halo = self._resolve_spatial_halo(uv, self.max_iters)
                    uv = classic_nl_level_step_spatial(
                        cfg, cur[level], color_level, uv,
                        jnp.asarray(alpha, self.dtype),
                        self.spatial_mesh, halo,
                    )
                else:
                    uv = classic_nl_level_resampled(
                        cfg, cur[level], color_level, uv, jnp.asarray(alpha, self.dtype)
                    )
                if self.checkpoint is not None:
                    self.checkpoint(ignc, level, uv)

            if self.gnc_iters > 1:
                new_alpha = 1.0 - (ignc + 1) / (self.gnc_iters - 1)
                alpha = max(0.0, min(alpha, new_alpha))

            if self.display:
                elapsed = (time.time() - start_time) / 60
                msg = f"GNC stage {ignc + 1} finished, {elapsed:.2f} minutes passed"
                if gt is not None:
                    from optical_flow_tpu.evaluation.metrics import flow_angular_error

                    gt_arr = np.asarray(gt)
                    uv_arr = np.asarray(uv)
                    aae, stdae, aepe = flow_angular_error(
                        gt_arr[:, :, 0], gt_arr[:, :, 1], uv_arr[:, :, 0], uv_arr[:, :, 1], 0
                    )
                    msg += f"  AAE {aae:.3f} STD {stdae:.3f} EPE {aepe:.3f}"
                print(msg)

        return uv

    def compute_flow_base(self, uv):
        images = self._as_dtype(self.images)
        use_color = self.color_images is not None and int(
            np.prod(np.asarray(self.color_images).shape[:2])
        ) >= images.shape[0] * images.shape[1]
        color = (
            self._as_dtype(self.color_images)
            if use_color
            else jnp.zeros((1, 1), dtype=self.dtype)
        )
        cfg = self._nl_cfg(use_color=use_color)
        return classic_nl_level_step(
            cfg, images, color, self._as_dtype(uv), jnp.asarray(self.alpha, self.dtype)
        )
