"""Black–Anandan optical flow: robust IRLS with GNC.

Reference: ``methods/ba.py``.  The GNC/pyramid schedule runs host-side;
each level is one jitted program.  The GNC blend
``alpha * A_quadratic + (1 - alpha) * A_robust`` (``ba.py:170-182``) is a
linear blend of stencil coefficient fields, so one uniform program covers
alpha = 1, (0, 1), and 0 with a traced alpha scalar — no recompilation per
GNC stage.
"""
from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from optical_flow_tpu.methods.base import BaseOpticalFlow, jit_scale255
from optical_flow_tpu.ops.derivatives import precompute_warp, warp_deriv
from optical_flow_tpu.ops.filters import correlate2d_multi, median_filter2d
from optical_flow_tpu.ops.penalties import Robust
from optical_flow_tpu.ops.rof import structure_texture_decomposition_rof
from optical_flow_tpu.ops.resample import resample_flow
from optical_flow_tpu.ops.stencil import blend_systems, build_irls_system
from optical_flow_tpu.solvers.cg import solve_flow_system
from optical_flow_tpu.utils.compat import fspecial_gaussian, scale_image


@dataclasses.dataclass(frozen=True)
class IRLSLevelConfig:
    """Static per-level configuration for the IRLS family (BA & friends)."""

    lambda_: float
    lambda_q: float
    rho_spatial_u: Tuple[Robust, Robust]
    rho_spatial_v: Tuple[Robust, Robust]
    rho_data: Robust
    qua_rho_spatial_u: Tuple[Robust, Robust]
    qua_rho_spatial_v: Tuple[Robust, Robust]
    qua_rho_data: Robust
    max_iters: int
    max_linear: int
    median_filter_size: Optional[Tuple[int, int]]
    limit_update: bool
    interp: str
    deriv_filter: Tuple[float, ...]
    blend: float
    solver: Tuple
    # failure guard threshold (utils/guard.py); 0.0 = off (reference parity)
    guard: float = 0.0


def _blended_solve(cfg: IRLSLevelConfig, uv, duv, It, Ix, Iy, alpha):
    """Solve the alpha-blended quadratic/robust IRLS system for the update."""
    sys_q = build_irls_system(
        uv, duv, It, Ix, Iy,
        cfg.qua_rho_spatial_u, cfg.qua_rho_spatial_v, cfg.qua_rho_data,
        cfg.lambda_q,
    )
    sys_r = build_irls_system(
        uv, duv, It, Ix, Iy,
        cfg.rho_spatial_u, cfg.rho_spatial_v, cfg.rho_data,
        cfg.lambda_,
    )
    sys = blend_systems(alpha, sys_q, sys_r)
    x = solve_flow_system(sys, *cfg.solver)
    if cfg.limit_update:
        x = jnp.clip(x, -1.0, 1.0)
    return x


@partial(jax.jit, static_argnums=(0,))
def ba_level_step(cfg: IRLSLevelConfig, images, uv, alpha):
    """One pyramid level of BA IRLS (``ba.py:140-206``)."""
    pre = precompute_warp(images, cfg.interp, np.array(cfg.deriv_filter), cfg.blend)

    def median_pass(uv):
        return jnp.stack(
            [
                median_filter2d(uv[:, :, 0], cfg.median_filter_size),
                median_filter2d(uv[:, :, 1], cfg.median_filter_size),
            ],
            axis=-1,
        )

    def warp_iter(_, uv):
        It, Ix, Iy = warp_deriv(pre, uv)
        duv = jnp.zeros_like(uv)
        for _j in range(cfg.max_linear):
            duv = _blended_solve(cfg, uv, duv, It, Ix, Iy, alpha)
            if cfg.median_filter_size is not None:
                # median-filter-in-the-loop via the duv trick (ba.py:194-202)
                duv = median_pass(uv + duv) - uv
        return uv + duv

    out = jax.lax.fori_loop(0, cfg.max_iters, warp_iter, uv)
    if cfg.guard:
        from optical_flow_tpu.utils.guard import guard_level

        out = guard_level(out, uv, cfg.guard)
    return out


@dataclasses.dataclass(frozen=True)
class BAFlowPlan:
    """Static whole-flow schedule: GNC stages x pyramid levels."""

    preprocess: str  # 'texture' | 'fc' | 'scale'
    alp: float
    levels: int
    spacing: float
    gnc_levels: int
    gnc_spacing: float
    shapes: Tuple[Tuple[int, int], ...]
    gnc_shapes: Tuple[Tuple[int, int], ...]
    stages: Tuple[Tuple[IRLSLevelConfig, float], ...]  # (cfg, alpha) per stage


def _preprocess_traced(kind: str, images, alp: float):
    if kind == "texture":
        return structure_texture_decomposition_rof(images, 1.0 / 8, 100, alp)
    if kind == "fc":
        f = fspecial_gaussian(5, 1.5)
        hp = images - alp * correlate2d_multi(images, f, "reflect")
        return scale_image(hp, 0, 255)
    return scale_image(images, 0, 255)


@partial(jax.jit, static_argnums=(1,))
def _jit_highpass(images, alp):
    """The 'fc' Gaussian high-pass prefilter alternative (``ba.py:77-82``)."""
    return _preprocess_traced("fc", images, alp)


@partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def irls_prepare(images, preprocess: str, alp: float, levels: int,
                 spacing: float, gnc_levels_spacing):
    """Preprocess + build both texture pyramids in ONE device program."""
    from optical_flow_tpu.ops.pyramid import build_pyramid

    gnc_levels, gnc_spacing = gnc_levels_spacing
    proc = _preprocess_traced(preprocess, images, alp)
    return (
        tuple(build_pyramid(proc, levels, spacing)),
        tuple(build_pyramid(proc, gnc_levels, gnc_spacing)),
    )


@partial(jax.jit, static_argnums=(0,))
def ba_level_resampled(cfg: IRLSLevelConfig, images, uv, alpha):
    """Level step with the inter-level flow resample fused in."""
    from optical_flow_tpu.ops.resample import resample_flow

    uv = resample_flow(uv, images.shape[:2])
    return ba_level_step(cfg, images, uv, alpha)


@partial(jax.jit, static_argnums=(0,))
def ba_flow_program(plan: BAFlowPlan, images, uv):
    """Whole GNC + coarse-to-fine BA flow as one device program."""
    from optical_flow_tpu.ops.pyramid import build_pyramid
    from optical_flow_tpu.ops.resample import resample_flow

    proc = _preprocess_traced(plan.preprocess, images, plan.alp)
    pyramid = build_pyramid(proc, plan.levels, plan.spacing)
    gnc_pyramid = build_pyramid(proc, plan.gnc_levels, plan.gnc_spacing)

    for stage_idx, (cfg, alpha) in enumerate(plan.stages):
        if stage_idx == 0:
            levels, cur, shapes = plan.levels, pyramid, plan.shapes
        else:
            levels, cur, shapes = plan.gnc_levels, gnc_pyramid, plan.gnc_shapes
        for level in range(levels - 1, -1, -1):
            uv = resample_flow(uv, shapes[level])
            uv = ba_level_step(cfg, cur[level], uv, jnp.asarray(alpha, uv.dtype))
    return uv


@partial(jax.jit, static_argnums=(0, 3))
def ba_flow_from_rgb(plan: "BAFlowPlan", im1, im2, dtype):
    """rgb2gray preprocessing + the whole BA flow as one device program."""
    from optical_flow_tpu.utils.compat import rgb2gray

    im1 = jnp.asarray(im1, dtype)
    im2 = jnp.asarray(im2, dtype)
    images = jnp.stack([rgb2gray(im1), rgb2gray(im2)], axis=2)
    uv = jnp.zeros((*images.shape[:2], 2), dtype)
    return ba_flow_program(plan, images, uv)


@partial(jax.jit, static_argnums=(0, 3))
def ba_flow_from_gray(plan: "BAFlowPlan", im1, im2, dtype):
    """Raw grayscale pair (uint8 when exact) + the whole BA flow, ONE program."""
    images = jnp.stack([jnp.asarray(im1, dtype), jnp.asarray(im2, dtype)], axis=2)
    uv = jnp.zeros((*images.shape[:2], 2), dtype)
    return ba_flow_program(plan, images, uv)


class BAOpticalFlow(BaseOpticalFlow):
    """Black & Anandan optical flow with robust estimation and GNC."""

    spatial_mesh_supported = True

    def __init__(self):
        super().__init__()
        self.lambda_ = 1.0
        self.lambda_q = 1.0
        self.gnc_iters = 3
        self.alpha = 1.0
        self.max_iters = 10
        self.max_linear = 1
        self.pyramid_levels = 4
        self.pyramid_spacing = 2.0
        self.gnc_pyramid_levels = 2
        self.gnc_pyramid_spacing = 1.25
        self.texture = False
        self.fc = False
        self.solver = "backslash"
        self.interpolation_method = "cubic"
        self.limit_update = True
        self.display = False

        method = "lorentzian"
        self.rho_spatial_u = [Robust(method, (0.03,)), Robust(method, (0.03,))]
        self.rho_spatial_v = [Robust(method, (0.03,)), Robust(method, (0.03,))]
        self.rho_data = Robust(method, (1.5,))

    # ------------------------------------------------------------------
    def _quadratic_relaxation(self):
        """BA's quadratic relaxation penalties (``ba.py:150-160``)."""
        ta = self.rho_data.param[0] / self.rho_spatial_u[0].param[0]
        qsu = (Robust("quadratic", (1.0,)), Robust("quadratic", (1.0,)))
        qsv = (Robust("quadratic", (1.0,)), Robust("quadratic", (1.0,)))
        qd = Robust("quadratic", (ta,))
        return qsu, qsv, qd

    def _level_cfg(self, max_linear=None) -> IRLSLevelConfig:
        mfs = self.median_filter_size
        if mfs is not None:
            mfs = (int(mfs[0]), int(mfs[1])) if hasattr(mfs, "__len__") else (int(mfs), int(mfs))
        qsu, qsv, qd = self._quadratic_relaxation()
        return IRLSLevelConfig(
            lambda_=float(self.lambda_),
            lambda_q=float(self.lambda_q),
            rho_spatial_u=tuple(self.rho_spatial_u),
            rho_spatial_v=tuple(self.rho_spatial_v),
            rho_data=self.rho_data,
            qua_rho_spatial_u=qsu,
            qua_rho_spatial_v=qsv,
            qua_rho_data=qd,
            max_iters=int(self.max_iters),
            max_linear=int(self.max_linear if max_linear is None else max_linear),
            median_filter_size=mfs,
            limit_update=bool(self.limit_update),
            interp=str(self.interpolation_method),
            deriv_filter=tuple(float(v) for v in np.asarray(self.deriv_filter).ravel()),
            blend=float(self.blend),
            solver=self._solver_cfg(),
            guard=float(self.guard_flow) if self.guard_flow else 0.0,
        )

    def _preprocess(self, images):
        """Texture / high-pass / rescale preprocessing (``ba.py:74-84``)."""
        if self.texture:
            return structure_texture_decomposition_rof(images, 1.0 / 8, 100, float(self.alp))
        if self.fc:
            return _jit_highpass(images, float(self.alp))
        return jit_scale255(images)

    def _gnc_alphas(self):
        """Host-side GNC alpha schedule (``ba.py:126-130``)."""
        alphas = []
        alpha = float(self.alpha)
        for ignc in range(self.gnc_iters):
            alphas.append(alpha)
            if self.gnc_iters > 1:
                alpha = max(0.0, min(alpha, 1.0 - (ignc + 1) / (self.gnc_iters - 1)))
        return alphas

    def _preprocess_kind(self) -> str:
        return "texture" if self.texture else ("fc" if self.fc else "scale")

    def _make_plan(self, sz) -> "BAFlowPlan":
        from optical_flow_tpu.ops.pyramid import auto_pyramid_levels, pyramid_shapes

        if self.auto_level:
            self.pyramid_levels = auto_pyramid_levels(sz, self.pyramid_spacing)
        stages = tuple(
            (self._level_cfg(max_linear=1 if i == 0 else None), alpha)
            for i, alpha in enumerate(self._gnc_alphas())
        )
        return BAFlowPlan(
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
        )

    # ------------------------------------------------------------------
    def compute_flow_from_rgb(self, im1, im2):
        if not (
            self._fuse_enabled()
            and self.spatial_mesh is None
            and not self.display
            and self.checkpoint is None
            and type(self) is BAOpticalFlow
        ):
            return None
        plan = self._make_plan(tuple(int(s) for s in im1.shape[:2]))
        return ba_flow_from_rgb(plan, im1, im2, self.dtype)

    def compute_flow_from_gray(self, im1, im2):
        if not (
            self._fuse_enabled()
            and self.spatial_mesh is None
            and not self.display
            and self.checkpoint is None
            and type(self) is BAOpticalFlow
        ):
            return None
        plan = self._make_plan(tuple(int(s) for s in im1.shape[:2]))
        return ba_flow_from_gray(plan, im1, im2, self.dtype)

    def compute_flow(self, init=None, gt=None):
        """GNC + coarse-to-fine estimation (``ba.py:57-138``)."""
        images = self._as_dtype(self.images)
        sz = images.shape[:2]
        uv = jnp.zeros((*sz, 2), dtype=self.dtype) if init is None else self._as_dtype(init)

        if (self._fuse_enabled() and self.spatial_mesh is None and not self.display
                and self.checkpoint is None and type(self) is BAOpticalFlow):
            return ba_flow_program(self._make_plan(sz), images, uv)

        if self.auto_level:
            self.pyramid_levels = self._auto_pyramid_levels(images)

        pyramid, gnc_pyramid = irls_prepare(
            images,
            self._preprocess_kind(),
            float(self.alp),
            int(self.pyramid_levels),
            float(self.pyramid_spacing),
            (int(self.gnc_pyramid_levels), float(self.gnc_pyramid_spacing)),
        )

        start_time = time.time()
        alpha = float(self.alpha)

        for ignc in range(self.gnc_iters):
            if self.display:
                print(f"GNC stage: {ignc + 1}")
            if ignc == 0:
                levels, current = self.pyramid_levels, pyramid
            else:
                levels, current = self.gnc_pyramid_levels, gnc_pyramid

            cfg = self._level_cfg(max_linear=1 if ignc == 0 else None)
            for level in range(levels - 1, -1, -1):
                if self.display:
                    print(f"  Pyramid level: {level + 1}")
                if self.spatial_mesh is not None:
                    from optical_flow_tpu.parallel.spatial import ba_level_step_spatial

                    nsz = tuple(int(s) for s in current[level].shape[:2])
                    uv = resample_flow(uv, nsz)
                    halo = self._resolve_spatial_halo(uv, self.max_iters)
                    uv = ba_level_step_spatial(
                        cfg, current[level], uv, jnp.asarray(alpha, self.dtype),
                        self.spatial_mesh, halo,
                    )
                else:
                    uv = ba_level_resampled(
                        cfg, current[level], uv, jnp.asarray(alpha, self.dtype)
                    )
                if self.checkpoint is not None:
                    self.checkpoint(ignc, level, uv)

            if self.gnc_iters > 1:
                new_alpha = 1.0 - (ignc + 1) / (self.gnc_iters - 1)
                alpha = max(0.0, min(alpha, new_alpha))

            if self.display:
                elapsed = (time.time() - start_time) / 60
                print(f"GNC stage {ignc + 1} finished, {elapsed:.2f} minutes passed")

        return uv

    def compute_flow_base(self, uv):
        images = self._as_dtype(self.images)
        return ba_level_step(
            self._level_cfg(), images, self._as_dtype(uv), jnp.asarray(self.alpha, self.dtype)
        )
