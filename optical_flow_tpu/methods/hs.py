"""Horn–Schunck optical flow (quadratic penalties, Laplacian spatial term).

Reference: ``methods/hs.py``.  Each pyramid level runs as one jitted
program: a ``lax.while_loop`` over warping iterations with the reference's
early stop (||x|| < 1e-3, which discards the final small update —
``hs.py:118-140``), matrix-free linear solves, and an in-loop 5x5 median
filter.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from optical_flow_tpu.methods.base import BaseOpticalFlow, jit_median_pair
from optical_flow_tpu.ops.derivatives import precompute_warp, warp_deriv
from optical_flow_tpu.ops.filters import median_filter2d
from optical_flow_tpu.ops.rof import structure_texture_decomposition_rof
from optical_flow_tpu.ops.resample import resample_flow
from optical_flow_tpu.ops.stencil import build_hs_system
from optical_flow_tpu.solvers.cg import solve_flow_system
from optical_flow_tpu.utils.compat import scale_image


@dataclasses.dataclass(frozen=True)
class HSLevelConfig:
    lambda_: float
    sigmaD2: float
    sigmaS2: float
    max_warping_iters: int
    median_filter_size: Optional[Tuple[int, int]]
    mf_iter: int
    limit_update: bool
    interp: str
    deriv_filter: Tuple[float, ...]
    blend: float
    solver: Tuple
    # failure guard threshold (utils/guard.py); 0.0 = off (reference parity)
    guard: float = 0.0


@partial(jax.jit, static_argnums=(1, 2, 3))
def hs_prepare(images, texture: bool, levels: int, spacing: float):
    """Preprocess + full pyramid in ONE device program."""
    from optical_flow_tpu.ops.pyramid import build_pyramid

    if texture:
        images = structure_texture_decomposition_rof(images)
    else:
        images = scale_image(images, 0, 255)
    return tuple(build_pyramid(images, levels, spacing))


@partial(jax.jit, static_argnums=(0,))
def hs_level_resampled(cfg: "HSLevelConfig", images, uv):
    """Level step with the inter-level flow resample fused in."""
    from optical_flow_tpu.ops.resample import resample_flow

    uv = resample_flow(uv, images.shape[:2])
    return hs_level_step(cfg, images, uv)


@partial(jax.jit, static_argnums=(0,))
def hs_level_step(cfg: HSLevelConfig, images, uv):
    """One pyramid level of Horn–Schunck (``hs.py:109-142``)."""
    pre = precompute_warp(
        images, cfg.interp, np.array(cfg.deriv_filter), cfg.blend
    )
    def median_pass(uv):
        if cfg.median_filter_size is None:
            return uv
        for _ in range(cfg.mf_iter):
            uv = jnp.stack(
                [
                    median_filter2d(uv[:, :, 0], cfg.median_filter_size),
                    median_filter2d(uv[:, :, 1], cfg.median_filter_size),
                ],
                axis=-1,
            )
        return uv

    def cond(state):
        k, _, cont = state
        return jnp.logical_and(k < cfg.max_warping_iters, cont)

    def body(state):
        k, uv, _ = state
        It, Ix, Iy = warp_deriv(pre, uv)
        sys = build_hs_system(uv, It, Ix, Iy, cfg.lambda_, cfg.sigmaD2, cfg.sigmaS2)
        x = solve_flow_system(sys, *cfg.solver)
        # early stop discards the sub-threshold update (hs.py:127)
        cont = jnp.linalg.norm(x.ravel()) >= 1e-3
        if cfg.limit_update:
            x = jnp.clip(x, -1.0, 1.0)
        new_uv = median_pass(uv + x)
        uv = jnp.where(cont, new_uv, uv)
        return (k + 1, uv, cont)

    uv0 = uv
    _, uv, _ = jax.lax.while_loop(cond, body, (jnp.asarray(0), uv, jnp.asarray(True)))
    if cfg.guard:
        from optical_flow_tpu.utils.guard import guard_level

        uv = guard_level(uv, uv0, cfg.guard)
    return uv


@dataclasses.dataclass(frozen=True)
class HSFlowPlan:
    """Static whole-flow schedule: preprocessing + pyramid ladder + levels."""

    texture: bool
    levels: int
    spacing: float
    shapes: Tuple[Tuple[int, int], ...]  # finest-first pyramid shapes
    cfg: HSLevelConfig
    final_median: Optional[Tuple[int, int]]


@partial(jax.jit, static_argnums=(0,))
def hs_flow_program(plan: HSFlowPlan, images, uv):
    """The whole coarse-to-fine HS flow as one device program.

    One dispatch executes preprocessing, every pyramid level build, every
    level solve, and the final median — essential when each host->device
    call costs tens of ms of link latency.
    """
    from optical_flow_tpu.ops.pyramid import build_pyramid
    from optical_flow_tpu.ops.resample import resample_flow

    if plan.texture:
        images = structure_texture_decomposition_rof(images)
    else:
        images = scale_image(images, 0, 255)
    pyramid = build_pyramid(images, plan.levels, plan.spacing)
    for level in range(plan.levels - 1, -1, -1):
        uv = resample_flow(uv, plan.shapes[level])
        uv = hs_level_step(plan.cfg, pyramid[level], uv)
    if plan.final_median is not None:
        uv = jnp.stack(
            [
                median_filter2d(uv[:, :, 0], plan.final_median),
                median_filter2d(uv[:, :, 1], plan.final_median),
            ],
            axis=-1,
        )
    return uv


@partial(jax.jit, static_argnums=(0, 3))
def hs_flow_from_rgb(plan: HSFlowPlan, im1, im2, dtype):
    """rgb2gray preprocessing + the whole HS flow as one device program."""
    from optical_flow_tpu.utils.compat import rgb2gray

    im1 = jnp.asarray(im1, dtype)
    im2 = jnp.asarray(im2, dtype)
    images = jnp.stack([rgb2gray(im1), rgb2gray(im2)], axis=2)
    uv = jnp.zeros((*images.shape[:2], 2), dtype)
    return hs_flow_program(plan, images, uv)


@partial(jax.jit, static_argnums=(0, 3))
def hs_flow_from_gray(plan: HSFlowPlan, im1, im2, dtype):
    """Raw grayscale pair (uint8 when exact) + the whole HS flow, ONE program."""
    images = jnp.stack([jnp.asarray(im1, dtype), jnp.asarray(im2, dtype)], axis=2)
    uv = jnp.zeros((*images.shape[:2], 2), dtype)
    return hs_flow_program(plan, images, uv)


class HSOpticalFlow(BaseOpticalFlow):
    """Horn–Schunck with quadratic penalty and Laplacian spatial term."""

    spatial_mesh_supported = True

    def __init__(self):
        super().__init__()
        self.lambda_ = 80
        self.lambda_q = 80
        self.gnc_iters = 1
        self.pyramid_levels = 4
        self.pyramid_spacing = 2.0
        self.max_warping_iters = 10
        self.solver = "backslash"
        self.interpolation_method = "cubic"
        self.texture = False
        self.limit_update = True
        self.display = False
        self.sigmaD2 = 1.0
        self.sigmaS2 = 1.0
        self.mf_iter = 1

    def _level_cfg(self) -> HSLevelConfig:
        mfs = self.median_filter_size
        if mfs is not None:
            mfs = (int(mfs[0]), int(mfs[1])) if hasattr(mfs, "__len__") else (int(mfs), int(mfs))
        return HSLevelConfig(
            lambda_=float(self.lambda_),
            sigmaD2=float(self.sigmaD2),
            sigmaS2=float(self.sigmaS2),
            max_warping_iters=int(self.max_warping_iters),
            median_filter_size=mfs,
            mf_iter=int(self.mf_iter),
            limit_update=bool(self.limit_update),
            interp=str(self.interpolation_method),
            deriv_filter=tuple(float(v) for v in np.asarray(self.deriv_filter).ravel()),
            blend=float(self.blend),
            solver=self._solver_cfg(),
            guard=float(self.guard_flow) if self.guard_flow else 0.0,
        )

    def _make_plan(self, sz) -> HSFlowPlan:
        """Static whole-flow schedule for ``hs_flow_program``.

        HS recomputes the level count unconditionally (reference
        ``hs.py:73-76``), unlike the IRLS methods' ``auto_level`` gate.
        """
        from optical_flow_tpu.ops.pyramid import auto_pyramid_levels, pyramid_shapes

        self.pyramid_levels = auto_pyramid_levels(sz, self.pyramid_spacing)
        mfs = self.median_filter_size
        if mfs is not None:
            mfs = (int(mfs[0]), int(mfs[1])) if hasattr(mfs, "__len__") else (int(mfs), int(mfs))
        return HSFlowPlan(
            texture=bool(self.texture),
            levels=int(self.pyramid_levels),
            spacing=float(self.pyramid_spacing),
            shapes=tuple(pyramid_shapes(sz, self.pyramid_levels, 1.0 / self.pyramid_spacing)),
            cfg=self._level_cfg(),
            final_median=mfs,
        )

    def compute_flow_from_rgb(self, im1, im2):
        if not (
            self._fuse_enabled()
            and self.spatial_mesh is None
            and not self.display
            and self.checkpoint is None
            and type(self) is HSOpticalFlow
        ):
            return None
        plan = self._make_plan(tuple(int(s) for s in im1.shape[:2]))
        return hs_flow_from_rgb(plan, im1, im2, self.dtype)

    def compute_flow_from_gray(self, im1, im2):
        if not (
            self._fuse_enabled()
            and self.spatial_mesh is None
            and not self.display
            and self.checkpoint is None
            and type(self) is HSOpticalFlow
        ):
            return None
        plan = self._make_plan(tuple(int(s) for s in im1.shape[:2]))
        return hs_flow_from_gray(plan, im1, im2, self.dtype)

    def compute_flow(self, init=None, gt=None):
        """Coarse-to-fine Horn–Schunck (``hs.py:49-99``)."""
        images = self._as_dtype(self.images)
        sz = images.shape[:2]
        uv = jnp.zeros((*sz, 2), dtype=self.dtype) if init is None else self._as_dtype(init)

        if (self._fuse_enabled() and self.spatial_mesh is None and not self.display
                and self.checkpoint is None):
            return hs_flow_program(self._make_plan(sz), images, uv)

        self.pyramid_levels = self._auto_pyramid_levels(images)
        pyramid = hs_prepare(
            images, bool(self.texture), int(self.pyramid_levels), float(self.pyramid_spacing)
        )

        cfg = self._level_cfg()
        for level in range(self.pyramid_levels - 1, -1, -1):
            if self.display:
                print(f"Pyramid level: {level + 1}")
            if self.spatial_mesh is not None:
                from optical_flow_tpu.parallel.spatial import hs_level_step_spatial

                nsz = tuple(int(s) for s in pyramid[level].shape[:2])
                uv = resample_flow(uv, nsz)
                halo = self._resolve_spatial_halo(uv, self.max_warping_iters)
                uv = hs_level_step_spatial(
                    cfg, pyramid[level], uv, self.spatial_mesh, halo
                )
            else:
                uv = hs_level_resampled(cfg, pyramid[level], uv)
            if self.checkpoint is not None:
                self.checkpoint(0, level, uv)

        if self.median_filter_size is not None:
            mfs = self.median_filter_size
            mfs = (int(mfs[0]), int(mfs[1])) if hasattr(mfs, "__len__") else (int(mfs), int(mfs))
            uv = jit_median_pair(uv, mfs)
        return uv

    def compute_flow_base(self, uv):
        """Single-level solve on ``self.images`` (reference ``hs.py:109``)."""
        images = self._as_dtype(self.images)
        return hs_level_step(self._level_cfg(), images, self._as_dtype(uv))
