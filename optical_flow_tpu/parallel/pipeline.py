"""Pipeline parallelism ACROSS video frames (SURVEY §2's "PP" row).

Within one frame the coarse-to-fine recursion is inherently sequential —
every pyramid level consumes the previous level's flow (reference
``methods/ba.py:112-124``), so intra-frame pipeline parallelism is
impossible.  Across a video stream it is natural: flatten the whole
(GNC stage, pyramid level) schedule into an ordered list of level steps,
partition it into contiguous STAGE GROUPS balanced by pixel count, pin
each group to its own device, and keep several frames in flight — frame
t runs group s while frame t+1 runs group s-1.  The
overlap comes from JAX's asynchronous dispatch: the host submits every
(frame, group) tick in dependency order without blocking, and each
device works through its own queue; inter-group handoffs are
device-to-device transfers of the (resampled-on-arrival) flow state —
a few hundred KB per tick.

The pipeline reuses the SAME jitted per-level programs as the per-level
execution path (``methods/*_level_resampled``, static config
dataclasses), so its output is numerically identical to
``estimate_flow(..., {'fuse': False})`` — only placement changes.
All four method families run (hs / ba / classic+nl / alt-ba; the
classic+nl color-guide pyramid and alt-ba's (uv, uvhat) state pair are
threaded through the schedule like the sequential path does).

Shape heterogeneity is why this is host-orchestrated rather than a
``shard_map``: pyramid levels have different static shapes per stage, so
a single SPMD program over a 'stage' mesh axis cannot express it — each
stage group owns its own set of fixed-shape executables instead.

Scope notes: DP over frames (``parallel/batch.py``) remains the
preferred scale-out when frames are independent and devices are
interchangeable — PP's advantage is latency-bounded streaming (a frame's
result appears after one pipeline traversal, not one full batch) and
per-device working-set reduction (each device compiles/holds only its
levels' executables).
"""
from __future__ import annotations

import collections
from typing import Iterable, List, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from optical_flow_tpu.config import load_of_method

__all__ = ["estimate_flow_pipelined", "build_pipeline_schedule"]


class _Step:
    """One (GNC stage, pyramid level) tick: fn(state, *inputs) -> state."""

    __slots__ = ("fn", "cost", "label")

    def __init__(self, fn, cost, label):
        self.fn = fn
        self.cost = cost
        self.label = label


class _Schedule:
    __slots__ = ("prepare", "steps", "init_state", "extract", "finish")

    def __init__(self, prepare, steps, init_state, extract, finish=None):
        self.prepare = prepare  # (images, color) -> [per-step input tuples]
        self.steps = steps  # list[_Step]
        self.init_state = init_state  # (H, W, dtype) -> state pytree
        self.extract = extract  # state -> uv
        self.finish = finish  # uv -> uv, or None


def _alpha_schedule(ope) -> List[float]:
    """The GNC alpha ladder exactly as the sequential loops compute it
    (``ba.py:126-130``)."""
    alphas, alpha = [], float(ope.alpha)
    for ignc in range(ope.gnc_iters):
        alphas.append(alpha)
        if ope.gnc_iters > 1:
            new_alpha = 1.0 - (ignc + 1) / (ope.gnc_iters - 1)
            alpha = max(0.0, min(alpha, new_alpha))
    return alphas


def _level_shapes(sz, levels, spacing):
    from optical_flow_tpu.ops.pyramid import pyramid_shapes

    return pyramid_shapes(tuple(int(s) for s in sz), int(levels), 1.0 / float(spacing))


def build_pipeline_schedule(ope, sz, use_color: bool) -> _Schedule:
    """Flatten ``ope``'s coarse-to-fine (+GNC) schedule for shape ``sz``."""
    from optical_flow_tpu.methods.alt_ba import AltBAOpticalFlow
    from optical_flow_tpu.methods.ba import BAOpticalFlow, irls_prepare
    from optical_flow_tpu.methods.classic_nl import ClassicNLOpticalFlow
    from optical_flow_tpu.methods.hs import HSOpticalFlow

    dtype = ope.dtype

    if isinstance(ope, HSOpticalFlow):
        from optical_flow_tpu.methods.base import jit_median_pair
        from optical_flow_tpu.methods.hs import hs_level_resampled, hs_prepare

        levels = ope._auto_pyramid_levels(np.zeros((*sz, 1)))
        shapes = _level_shapes(sz, levels, ope.pyramid_spacing)
        cfg = ope._level_cfg()

        def prepare(images, color):
            pyr = hs_prepare(
                images, bool(ope.texture), int(levels), float(ope.pyramid_spacing)
            )
            return [(pyr[lvl],) for lvl in range(levels - 1, -1, -1)]

        steps = [
            _Step(
                lambda state, im, _cfg=cfg: (hs_level_resampled(_cfg, im, state[0]),),
                int(np.prod(shapes[lvl])),
                f"hs L{lvl}",
            )
            for lvl in range(levels - 1, -1, -1)
        ]

        finish = None
        if ope.median_filter_size is not None:
            mfs = ope.median_filter_size
            mfs = (
                (int(mfs[0]), int(mfs[1]))
                if hasattr(mfs, "__len__")
                else (int(mfs), int(mfs))
            )
            finish = lambda uv: jit_median_pair(uv, mfs)

        return _Schedule(
            prepare,
            steps,
            lambda H, W: (jnp.zeros((H, W, 2), dtype),),
            lambda state: state[0],
            finish,
        )

    if isinstance(ope, AltBAOpticalFlow):
        from optical_flow_tpu.methods.alt_ba import alt_ba_level_resampled

        levels = ope._auto_pyramid_levels(np.zeros((*sz, 1)))
        gnc_levels = int(ope.gnc_pyramid_levels)
        shapes = _level_shapes(sz, levels, ope.pyramid_spacing)
        gnc_shapes = _level_shapes(sz, gnc_levels, ope.gnc_pyramid_spacing)
        cfg = ope._alt_cfg()
        alphas = _alpha_schedule(ope)

        def prepare(images, color):
            # Alt-BA's texture path pins alp=0.95 (reference alt_ba.py:101-104)
            pyr, gnc_pyr = irls_prepare(
                images,
                "texture" if ope.texture else "scale",
                0.95,
                int(levels),
                float(ope.pyramid_spacing),
                (gnc_levels, float(ope.gnc_pyramid_spacing)),
            )
            inputs = []
            for ignc in range(ope.gnc_iters):
                cur = pyr if ignc == 0 else gnc_pyr
                n = levels if ignc == 0 else gnc_levels
                for lvl in range(n - 1, -1, -1):
                    inputs.append((cur[lvl],))
            return inputs

        steps = []
        for ignc in range(ope.gnc_iters):
            replacement = ignc != ope.gnc_iters - 1
            cur_shapes = shapes if ignc == 0 else gnc_shapes
            n = levels if ignc == 0 else gnc_levels
            for lvl in range(n - 1, -1, -1):

                def fn(state, im, _a=alphas[ignc], _r=replacement):
                    uv, uvhat = alt_ba_level_resampled(
                        cfg, im, state[0], state[1], jnp.asarray(_a, dtype), jnp.asarray(_r)
                    )
                    return (uv, uvhat)

                steps.append(
                    _Step(fn, int(np.prod(cur_shapes[lvl])), f"altba G{ignc}L{lvl}")
                )

        return _Schedule(
            prepare,
            steps,
            lambda H, W: (jnp.zeros((H, W, 2), dtype), jnp.zeros((H, W, 2), dtype)),
            lambda state: state[1],  # Alt-BA returns uvhat (alt_ba.py:185-187)
        )

    if isinstance(ope, ClassicNLOpticalFlow):
        from optical_flow_tpu.methods.classic_nl import classic_nl_level_resampled
        from optical_flow_tpu.ops.pyramid import pyramid_pair

        if ope.auto_level:
            levels = ope._auto_pyramid_levels(np.zeros((*sz, 1)))
        else:
            levels = int(ope.pyramid_levels)
        gnc_levels = int(ope.gnc_pyramid_levels)
        shapes = _level_shapes(sz, levels, ope.pyramid_spacing)
        gnc_shapes = _level_shapes(sz, gnc_levels, ope.gnc_pyramid_spacing)
        alphas = _alpha_schedule(ope)
        cfg0 = ope._nl_cfg(use_color=use_color, max_linear=1)
        cfg1 = ope._nl_cfg(use_color=use_color)

        def prepare(images, color):
            pyr, gnc_pyr = irls_prepare(
                images,
                ope._preprocess_kind(),
                float(ope.alp),
                int(levels),
                float(ope.pyramid_spacing),
                (gnc_levels, float(ope.gnc_pyramid_spacing)),
            )
            if use_color:
                cpyr, cgnc = pyramid_pair(
                    color,
                    int(levels),
                    float(ope.pyramid_spacing),
                    gnc_levels,
                    float(ope.gnc_pyramid_spacing),
                )
            else:
                dummy = jnp.zeros((1, 1), dtype)
                cpyr, cgnc = [dummy] * levels, [dummy] * gnc_levels
            inputs = []
            for ignc in range(ope.gnc_iters):
                cur, cc = (pyr, cpyr) if ignc == 0 else (gnc_pyr, cgnc)
                n = levels if ignc == 0 else gnc_levels
                for lvl in range(n - 1, -1, -1):
                    inputs.append((cur[lvl], cc[lvl]))
            return inputs

        steps = []
        for ignc in range(ope.gnc_iters):
            cfg = cfg0 if ignc == 0 else cfg1
            cur_shapes = shapes if ignc == 0 else gnc_shapes
            n = levels if ignc == 0 else gnc_levels
            for lvl in range(n - 1, -1, -1):

                def fn(state, im, col, _cfg=cfg, _a=alphas[ignc]):
                    return (
                        classic_nl_level_resampled(
                            _cfg, im, col, state[0], jnp.asarray(_a, dtype)
                        ),
                    )

                steps.append(
                    _Step(fn, int(np.prod(cur_shapes[lvl])), f"nl G{ignc}L{lvl}")
                )

        return _Schedule(
            prepare,
            steps,
            lambda H, W: (jnp.zeros((H, W, 2), dtype),),
            lambda state: state[0],
        )

    if isinstance(ope, BAOpticalFlow):
        from optical_flow_tpu.methods.ba import ba_level_resampled

        if ope.auto_level:
            levels = ope._auto_pyramid_levels(np.zeros((*sz, 1)))
        else:
            levels = int(ope.pyramid_levels)
        gnc_levels = int(ope.gnc_pyramid_levels)
        shapes = _level_shapes(sz, levels, ope.pyramid_spacing)
        gnc_shapes = _level_shapes(sz, gnc_levels, ope.gnc_pyramid_spacing)
        alphas = _alpha_schedule(ope)
        cfg0 = ope._level_cfg(max_linear=1)
        cfg1 = ope._level_cfg()

        def prepare(images, color):
            pyr, gnc_pyr = irls_prepare(
                images,
                ope._preprocess_kind(),
                float(ope.alp),
                int(levels),
                float(ope.pyramid_spacing),
                (gnc_levels, float(ope.gnc_pyramid_spacing)),
            )
            inputs = []
            for ignc in range(ope.gnc_iters):
                cur = pyr if ignc == 0 else gnc_pyr
                n = levels if ignc == 0 else gnc_levels
                for lvl in range(n - 1, -1, -1):
                    inputs.append((cur[lvl],))
            return inputs

        steps = []
        for ignc in range(ope.gnc_iters):
            cfg = cfg0 if ignc == 0 else cfg1
            cur_shapes = shapes if ignc == 0 else gnc_shapes
            n = levels if ignc == 0 else gnc_levels
            for lvl in range(n - 1, -1, -1):

                def fn(state, im, _cfg=cfg, _a=alphas[ignc]):
                    return (
                        ba_level_resampled(_cfg, im, state[0], jnp.asarray(_a, dtype)),
                    )

                steps.append(
                    _Step(fn, int(np.prod(cur_shapes[lvl])), f"ba G{ignc}L{lvl}")
                )

        return _Schedule(
            prepare,
            steps,
            lambda H, W: (jnp.zeros((H, W, 2), dtype),),
            lambda state: state[0],
        )

    raise ValueError(f"no pipeline schedule for method type {type(ope).__name__}")


def _partition(costs: Sequence[int], n_groups: int) -> List[List[int]]:
    """Contiguous partition of step indices, greedily balanced by cost.

    Coarse levels are cheap and finest levels dominate, so the greedy
    target-fill naturally lumps the coarse tail onto the first device and
    gives the finest level(s) their own stage.
    """
    n = len(costs)
    k = max(1, min(n_groups, n))
    # exact minimal-max contiguous partition (classic linear-partition DP;
    # n is the step count — tens at most — so O(n^2 k) is nothing).  The
    # greedy target-fill fails here because costs ASCEND (coarse -> fine),
    # so the threshold is only crossed at the very end.
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + float(c))
    seg = lambda i, j: prefix[j] - prefix[i]  # cost of steps [i, j)

    INF = float("inf")
    best = [[INF] * (k + 1) for _ in range(n + 1)]
    cut = [[0] * (k + 1) for _ in range(n + 1)]
    best[0][0] = 0.0
    for j in range(1, k + 1):
        for i in range(j, n + 1):
            for m in range(j - 1, i):
                v = max(best[m][j - 1], seg(m, i))
                if v < best[i][j]:
                    best[i][j] = v
                    cut[i][j] = m
    bounds, i = [], n
    for j in range(k, 0, -1):
        m = cut[i][j]
        bounds.append((m, i))
        i = m
    bounds.reverse()
    return [list(range(a, b)) for a, b in bounds]


def _prep_pair(ope, im1, im2):
    """Reproduce ``estimate_flow``'s per-stage preprocessing
    (``interface.py`` fallback path) -> (images, color_or_None)."""
    from optical_flow_tpu.interface import _preprocess_color_pair, _stack_gray_pair

    im1 = np.asarray(im1).astype(float)
    im2 = np.asarray(im2).astype(float)
    color = None
    if im1.ndim == 3 and im1.shape[2] >= 3:
        a1 = jnp.asarray(im1, dtype=ope.dtype)
        a2 = jnp.asarray(im2, dtype=ope.dtype)
        images, lab1 = _preprocess_color_pair(a1, a2)
        if ope.color_images is not None:
            color = lab1
    elif im1.ndim == 2:
        images = _stack_gray_pair(
            jnp.asarray(im1, dtype=ope.dtype), jnp.asarray(im2, dtype=ope.dtype)
        )
        if ope.color_images is not None:
            color = jnp.asarray(im1, dtype=ope.dtype)
    else:
        images = jnp.concatenate([jnp.asarray(im1), jnp.asarray(im2)], axis=2)
    return images, color


def estimate_flow_pipelined(
    pairs: Iterable,
    method: str = "classic+nl-fast",
    params=None,
    devices: Optional[Sequence] = None,
    n_stages: Optional[int] = None,
    depth: Optional[int] = None,
):
    """Stream flows for ``pairs`` with pyramid-level groups pipelined
    across devices.

    Args:
        pairs: iterable of (im1, im2) frame pairs (consistent shapes).
        method: preset name.
        params: optional overrides (``estimate_flow`` semantics).
        devices: devices to pipeline over (default ``jax.devices()``).
        n_stages: number of pipeline stage groups (default:
            ``min(len(devices), n_steps)``).
        depth: max frames in flight before yielding (default
            ``n_stages + 1`` — enough to keep every stage busy).

    Yields ``(H, W, 2)`` device arrays in input order.  Numerically
    identical to the per-level path: the same jitted level programs run
    in the same order, only their device placement differs.
    """
    devices = list(devices if devices is not None else jax.devices())

    ope = load_of_method(method)
    ope.display = False
    if params is not None:
        ope.parse_input_parameter(params)

    schedule = None
    groups = group_devices = None
    pending = collections.deque()

    for pair in pairs:
        im1, im2 = pair
        images, color = _prep_pair(ope, im1, im2)
        H, W = int(images.shape[0]), int(images.shape[1])

        if schedule is None:
            sched_hw = (H, W)
            schedule = build_pipeline_schedule(ope, (H, W), use_color=color is not None)
            costs = [s.cost for s in schedule.steps]
            groups = _partition(costs, n_stages or len(devices))
            group_devices = [devices[g % len(devices)] for g in range(len(groups))]
            if depth is None:
                depth = len(groups) + 1
        elif (H, W) != sched_hw:
            # the level schedule (auto level count, per-level shapes, jitted
            # executables) is built from the first frame's shape — fail
            # loudly rather than silently recompiling a wrong schedule
            raise ValueError(
                f"estimate_flow_pipelined requires a consistent frame shape: "
                f"got {(H, W)} after building the schedule for {sched_hw}"
            )

        # stage 0's device owns preprocessing + pyramid builds
        images = jax.device_put(images, group_devices[0])
        if color is not None:
            color = jax.device_put(color, group_devices[0])
        step_inputs = schedule.prepare(images, color)

        state = jax.device_put(schedule.init_state(H, W), group_devices[0])
        for g, group in enumerate(groups):
            dev = group_devices[g]
            if g > 0:
                # inter-stage handoff: the only cross-device traffic
                state = jax.device_put(state, dev)
            for si in group:
                ins = jax.device_put(step_inputs[si], dev)
                state = schedule.steps[si].fn(state, *ins)

        uv = schedule.extract(state)
        if schedule.finish is not None:
            uv = schedule.finish(uv)
        pending.append(uv)

        # bounded pipeline fill: yield (and thereby let the caller block on)
        # the oldest frame once `depth` frames are in flight
        while len(pending) > depth:
            yield pending.popleft()

    while pending:
        yield pending.popleft()
