"""Alternative BA: auxiliary field coupling + Li–Osher median denoising.

Reference: ``methods/alt_ba.py``.  The auxiliary field ``uvhat`` couples to
the main flow through a charbonnier penalty whose weight anneals over a
logspace schedule (``alt_ba.py:209-212``); each warping iteration solves the
coupled system, updates ``uvhat`` by Li–Osher median denoising, and
optionally replaces ``uv`` with ``uvhat`` (``alt_ba.py:255-272``).  The
``replacement`` stage flag is a traced scalar so one compiled program serves
every GNC stage.

Note on ``qterm``: the reference SETS it per level (``alt_ba.py:156-160``)
but its ``compute_flow_base`` never reads it — the coupling term is applied
unconditionally (``alt_ba.py:236-242``).  At the coarsest level, where
uv == uvhat == 0, the coupling still contributes a lambda2/sigma Tikhonov
diagonal, so honoring the dead flag changes results; we reproduce the
reference's actual behavior (always coupled) and keep the attribute only
for config parity.
"""
from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from optical_flow_tpu.methods.ba import BAOpticalFlow, IRLSLevelConfig, irls_prepare
from optical_flow_tpu.ops.denoise import denoise_LO
from optical_flow_tpu.ops.derivatives import precompute_warp, warp_deriv
from optical_flow_tpu.ops.penalties import Robust
from optical_flow_tpu.ops.resample import resample_flow
from optical_flow_tpu.ops.rof import structure_texture_decomposition_rof
from optical_flow_tpu.ops.stencil import add_coupling, blend_systems, build_irls_system
from optical_flow_tpu.solvers.cg import solve_flow_system
from optical_flow_tpu.utils.compat import scale_image


@dataclasses.dataclass(frozen=True)
class AltBALevelConfig:
    irls: IRLSLevelConfig
    rho_couple: Robust
    lambda2: float
    lambda3: float
    iters_lo: int


@partial(jax.jit, static_argnums=(0,))
def alt_ba_level_resampled(cfg, images, uv, uvhat, alpha, replacement):
    """Level step with both inter-level flow resamples fused in."""
    from optical_flow_tpu.ops.resample import resample_flow

    nsz = images.shape[:2]
    return alt_ba_level_step(
        cfg, images, resample_flow(uv, nsz), resample_flow(uvhat, nsz),
        alpha, replacement,
    )


@partial(jax.jit, static_argnums=(0,))
def alt_ba_level_step(cfg: AltBALevelConfig, images, uv, uvhat, alpha, replacement):
    """One pyramid level of Alt-BA (``alt_ba.py:189-274``)."""
    irls = cfg.irls
    pre = precompute_warp(images, irls.interp, np.array(irls.deriv_filter), irls.blend)

    # lambda2 annealing schedule: logspace 1e-4 -> lambda2 (alt_ba.py:209-212)
    lambda2s = np.logspace(np.log10(1e-4), np.log10(cfg.lambda2), irls.max_iters)
    lambda2s = jnp.asarray(lambda2s, dtype=uv.dtype)

    def warp_iter(i, state):
        uv, uvhat = state
        lambda2 = lambda2s[i]
        It, Ix, Iy = warp_deriv(pre, uv)
        duv = jnp.zeros_like(uv)
        for _j in range(irls.max_linear):
            sys_q = build_irls_system(
                uv, duv, It, Ix, Iy,
                irls.qua_rho_spatial_u, irls.qua_rho_spatial_v, irls.qua_rho_data,
                irls.lambda_q,
            )
            sys_r = build_irls_system(
                uv, duv, It, Ix, Iy,
                irls.rho_spatial_u, irls.rho_spatial_v, irls.rho_data,
                irls.lambda_,
            )
            sys = blend_systems(alpha, sys_q, sys_r)

            # coupling term — applied unconditionally, like the reference's
            # compute_flow_base (alt_ba.py:236-242; its qterm flag is dead)
            tmp = cfg.rho_couple.deriv_over_x(uv - uvhat)
            sys = add_coupling(sys, lambda2 * tmp)
            delta = lambda2 * tmp * (uvhat - uv)
            sys = sys._replace(
                b_u=sys.b_u + delta[:, :, 0], b_v=sys.b_v + delta[:, :, 1]
            )

            x = solve_flow_system(sys, *irls.solver)
            if irls.limit_update:
                x = jnp.clip(x, -1.0, 1.0)
            duv = x

        uv = uv + duv
        # Li–Osher update of the auxiliary field (alt_ba.py:257-265)
        lam_lo = lambda2 / cfg.lambda3
        uvhat = jnp.stack(
            [
                denoise_LO(uv[:, :, 0], irls.median_filter_size, lam_lo, cfg.iters_lo),
                denoise_LO(uv[:, :, 1], irls.median_filter_size, lam_lo, cfg.iters_lo),
            ],
            axis=-1,
        )
        uv = jnp.where(replacement, uvhat, uv)
        return (uv, uvhat)

    uv0, uvhat0 = uv, uvhat
    uv, uvhat = jax.lax.fori_loop(0, irls.max_iters, warp_iter, (uv, uvhat))
    if irls.guard:
        from optical_flow_tpu.utils.guard import guard_level_pair

        uv, uvhat = guard_level_pair(uv, uvhat, uv0, uvhat0, irls.guard)
    return uv, uvhat


@dataclasses.dataclass(frozen=True)
class AltBAFlowPlan:
    texture: bool
    levels: int
    spacing: float
    gnc_levels: int
    gnc_spacing: float
    shapes: Tuple[Tuple[int, int], ...]
    gnc_shapes: Tuple[Tuple[int, int], ...]
    stages: Tuple[Tuple[AltBALevelConfig, float, bool], ...]  # (cfg, alpha, replacement)


@partial(jax.jit, static_argnums=(0,))
def alt_ba_flow_program(plan: AltBAFlowPlan, images, uv, uvhat):
    """Whole GNC + coarse-to-fine Alt-BA flow as one device program."""
    from optical_flow_tpu.ops.pyramid import build_pyramid
    from optical_flow_tpu.ops.resample import resample_flow

    if plan.texture:
        proc = structure_texture_decomposition_rof(images)
    else:
        proc = scale_image(images, 0, 255)
    pyramid = build_pyramid(proc, plan.levels, plan.spacing)
    gnc_pyramid = build_pyramid(proc, plan.gnc_levels, plan.gnc_spacing)

    for stage_idx, (cfg, alpha, replacement) in enumerate(plan.stages):
        if stage_idx == 0:
            levels, cur, shapes = plan.levels, pyramid, plan.shapes
        else:
            levels, cur, shapes = plan.gnc_levels, gnc_pyramid, plan.gnc_shapes
        for level in range(levels - 1, -1, -1):
            uv = resample_flow(uv, shapes[level])
            uvhat = resample_flow(uvhat, shapes[level])
            uv, uvhat = alt_ba_level_step(
                cfg,
                cur[level],
                uv,
                uvhat,
                jnp.asarray(alpha, uv.dtype),
                jnp.asarray(replacement),
            )
    # Alt-BA returns the auxiliary field (alt_ba.py:185-187)
    return uvhat


@partial(jax.jit, static_argnums=(0, 3))
def alt_ba_flow_from_rgb(plan: AltBAFlowPlan, im1, im2, dtype):
    """rgb2gray preprocessing + the whole Alt-BA flow as one device program."""
    from optical_flow_tpu.utils.compat import rgb2gray

    im1 = jnp.asarray(im1, dtype)
    im2 = jnp.asarray(im2, dtype)
    images = jnp.stack([rgb2gray(im1), rgb2gray(im2)], axis=2)
    uv = jnp.zeros((*images.shape[:2], 2), dtype)
    return alt_ba_flow_program(plan, images, uv, uv)


@partial(jax.jit, static_argnums=(0, 3))
def alt_ba_flow_from_gray(plan: AltBAFlowPlan, im1, im2, dtype):
    """Raw grayscale pair (uint8 when exact) + whole Alt-BA flow, ONE program."""
    images = jnp.stack([jnp.asarray(im1, dtype), jnp.asarray(im2, dtype)], axis=2)
    uv = jnp.zeros((*images.shape[:2], 2), dtype)
    return alt_ba_flow_program(plan, images, uv, uv)


class AltBAOpticalFlow(BAOpticalFlow):
    """Alternative BA with coupled auxiliary field."""

    spatial_mesh_supported = True  # alt_ba_level_step_spatial (parallel/spatial.py)

    def __init__(self):
        super().__init__()
        self.lambda_ = 5.0
        self.lambda_q = 5.0
        self.solver = "backslash"
        self.warping_mode = "backward"
        self.texture = False
        self.median_filter_size = None
        self.interpolation_method = "cubic"

        self.gnc_iters = 3
        self.alpha = 1.0
        self.max_iters = 10
        self.max_linear = 1
        self.pyramid_levels = 4
        self.pyramid_spacing = 2.0
        self.gnc_pyramid_levels = 2
        self.gnc_pyramid_spacing = 1.25

        method = "lorentzian"
        self.rho_spatial_u = [Robust(method, (0.03,)), Robust(method, (0.03,))]
        self.rho_spatial_v = [Robust(method, (0.03,)), Robust(method, (0.03,))]
        self.rho_data = Robust(method, (1.5,))

        # Alt-BA specific (alt_ba.py:68-79)
        self.seg = None
        self.mfT = 15
        self.imfsz = [7, 7]
        self.qterm = True
        self.lambda2 = 0.1
        self.lambda3 = 1.0
        self.weightRatio = 1.0
        self.itersLO = 1
        self.replacement = True
        self.rho_couple = Robust("charbonnier", (1e-3,))
        self.auto_level = True

    def _quadratic_relaxation(self):
        """Alt-BA uses unit sigmas for the relaxation (``alt_ba.py:205-207``)."""
        qsu = (Robust("quadratic", (1.0,)), Robust("quadratic", (1.0,)))
        qsv = (Robust("quadratic", (1.0,)), Robust("quadratic", (1.0,)))
        qd = Robust("quadratic", (1.0,))
        return qsu, qsv, qd

    def _alt_cfg(self, max_linear=None) -> AltBALevelConfig:
        return AltBALevelConfig(
            irls=self._level_cfg(max_linear=max_linear),
            rho_couple=self.rho_couple,
            lambda2=float(self.lambda2),
            lambda3=float(self.lambda3),
            iters_lo=int(self.itersLO),
        )

    def _make_alt_plan(self, sz) -> AltBAFlowPlan:
        from optical_flow_tpu.ops.pyramid import auto_pyramid_levels, pyramid_shapes

        self.pyramid_levels = auto_pyramid_levels(sz, self.pyramid_spacing)
        stages = tuple(
            (self._alt_cfg(), alpha, i != self.gnc_iters - 1)
            for i, alpha in enumerate(self._gnc_alphas())
        )
        return AltBAFlowPlan(
            texture=bool(self.texture),
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

    def compute_flow_from_rgb(self, im1, im2):
        # spatial_mesh must NOT take the fused path: a mesh request has to
        # reach compute_flow's sharded per-level loop.
        if not (
            self._fuse_enabled()
            and self.spatial_mesh is None
            and not self.display
            and self.checkpoint is None
            and type(self) is AltBAOpticalFlow
        ):
            return None
        plan = self._make_alt_plan(tuple(int(s) for s in im1.shape[:2]))
        return alt_ba_flow_from_rgb(plan, im1, im2, self.dtype)

    def compute_flow_from_gray(self, im1, im2):
        if not (
            self._fuse_enabled()
            and self.spatial_mesh is None
            and not self.display
            and self.checkpoint is None
            and type(self) is AltBAOpticalFlow
        ):
            return None
        plan = self._make_alt_plan(tuple(int(s) for s in im1.shape[:2]))
        return alt_ba_flow_from_gray(plan, im1, im2, self.dtype)

    def compute_flow(self, init=None, gt=None):
        """GNC schedule with qterm / replacement flags (``alt_ba.py:81-187``)."""
        images = self._as_dtype(self.images)
        sz = images.shape[:2]
        uv = jnp.zeros((*sz, 2), dtype=self.dtype) if init is None else self._as_dtype(init)
        uvhat = uv

        if (self._fuse_enabled() and self.spatial_mesh is None and not self.display
                and gt is None and self.checkpoint is None):
            return alt_ba_flow_program(self._make_alt_plan(sz), images, uv, uvhat)

        self.pyramid_levels = self._auto_pyramid_levels(images)
        # the reference's Alt-BA texture path uses the default alp=0.95
        # regardless of self.alp (alt_ba.py:101-104)
        pyramid, gnc_pyramid = irls_prepare(
            images,
            "texture" if self.texture else "scale",
            0.95,
            int(self.pyramid_levels),
            float(self.pyramid_spacing),
            (int(self.gnc_pyramid_levels), float(self.gnc_pyramid_spacing)),
        )

        start_time = time.time()
        alpha = float(self.alpha)

        for ignc in range(self.gnc_iters):
            replacement = ignc != self.gnc_iters - 1
            if self.display:
                print(f"GNC stage: {ignc + 1}")
            if ignc == 0:
                levels, current = self.pyramid_levels, pyramid
            else:
                levels, current = self.gnc_pyramid_levels, gnc_pyramid

            cfg = self._alt_cfg()
            for level in range(levels - 1, -1, -1):
                if self.display:
                    print(f"  Pyramid level: {level + 1}")
                if self.spatial_mesh is not None:
                    from optical_flow_tpu.ops.resample import resample_flow
                    from optical_flow_tpu.parallel.spatial import (
                        alt_ba_level_step_spatial,
                    )

                    nsz = tuple(int(s) for s in current[level].shape[:2])
                    uv = resample_flow(uv, nsz)
                    uvhat = resample_flow(uvhat, nsz)
                    # the warp reads only uv; uvhat tracks it through the
                    # median (which never exceeds its input range)
                    halo = self._resolve_spatial_halo(uv, self.max_iters)
                    uv, uvhat = alt_ba_level_step_spatial(
                        cfg, current[level], uv, uvhat,
                        jnp.asarray(alpha, self.dtype),
                        jnp.asarray(replacement), self.spatial_mesh, halo,
                    )
                else:
                    uv, uvhat = alt_ba_level_resampled(
                        cfg,
                        current[level],
                        uv,
                        uvhat,
                        jnp.asarray(alpha, self.dtype),
                        jnp.asarray(replacement),
                    )
                if self.checkpoint is not None:
                    self.checkpoint(ignc, level, uv)

            if self.gnc_iters > 1:
                new_alpha = 1.0 - (ignc + 1) / (self.gnc_iters - 1)
                alpha = max(0.0, min(alpha, new_alpha))

            if self.display:
                elapsed = (time.time() - start_time) / 60
                print(f"GNC stage {ignc + 1} finished, {elapsed:.2f} minutes passed")

        # Alt-BA returns the auxiliary field (alt_ba.py:185-187)
        return uvhat

    def compute_flow_base(self, uv, uvhat=None):
        images = self._as_dtype(self.images)
        uv = self._as_dtype(uv)
        uvhat = uv if uvhat is None else self._as_dtype(uvhat)
        return alt_ba_level_step(
            self._alt_cfg(),
            images,
            uv,
            uvhat,
            jnp.asarray(self.alpha, self.dtype),
            jnp.asarray(bool(self.replacement)),
        )
