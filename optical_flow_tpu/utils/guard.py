"""Failure detection & recovery at level-program boundaries (SURVEY §5).

The reference has no failure handling of any kind: a divergent IRLS
trajectory (classic-c-a's default lambda2 annealing reaches ~1e48 on a
real RubberWhale crop, ``/root/reference/optical_flow/methods/alt_ba.py:
189-274`` — captured by ``tests/test_full_parity.py``) silently
propagates non-finite values through every later pyramid level and out
of ``estimate_flow``.  In float32 the failure surface is wider: f32
overflows at 3.4e38 (the same trajectory the reference's f64 survives),
and a wedged device can return garbage.  The framework therefore adds an
explicit, opt-in detection + recovery layer at the pyramid-level
boundary — the natural transaction unit of the coarse-to-fine recursion:
every level starts from a resampled copy of the previous estimate, so
rolling a failed level back to its initialization leaves a finite,
usable flow and lets the remaining levels proceed.

Everything is traced into the jitted level programs (one fused
reduce + select, no host synchronization), so the single-dispatch
whole-flow monoliths and the shard_map spatial path keep their dispatch
profile.  OFF by default at the method-class level — reference parity
includes reproducing the reference's own divergences — with ONE preset
exception: ``classic-c-a`` (the only preset whose default config
diverges) ships with ``guard_flow=1e9`` in its preset table
(``config.py``) so all 11 presets return scoreable flow out of the box;
its parity tests disable it with ``{'guard_flow': None}``.  Enable
elsewhere via:

    ope.guard_flow = 1e9            # method attribute, or
    estimate_flow(im1, im2, 'hs', {'guard_flow': 1e9})

1e9 is the natural threshold — it is the reference's own "unknown flow"
sentinel (``evaluation/metrics.py``: |f| >= 1e9 is excluded from
scoring), so any guarded estimate is scoreable by construction.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def flow_is_healthy(uv, max_flow: float):
    """Traced scalar bool: every component finite and |uv| <= max_flow.

    A single ``all`` reduction: NaN and +/-inf both fail ``<=``, so no
    separate ``isfinite`` pass is needed.
    """
    return jnp.all(jnp.abs(uv) <= max_flow)


def guard_level(uv_new, uv_init, max_flow: float):
    """Roll a level's result back to its initialization if unhealthy.

    The whole field reverts, not per-pixel: a divergent solve poisons its
    neighborhood through the spatial term, so per-pixel splicing would
    keep values that are finite only by accident.  Traced (jit/vmap
    -safe); compiles to a reduce + select.

    The rollback target is guarded too: after repeated rollbacks the
    inter-level ``resample_flow`` scaling (x spacing per level) can push a
    just-under-threshold estimate past ``max_flow`` — in that case the
    level restarts from zero flow, preserving the invariant that a guarded
    result NEVER exceeds ``max_flow`` (so it is scoreable under the
    metrics' |f| >= 1e9 unknown-flow filter, by construction).
    """
    safe_init = jnp.where(flow_is_healthy(uv_init, max_flow), uv_init, 0.0)
    return jnp.where(flow_is_healthy(uv_new, max_flow), uv_new, safe_init)


def guard_level_pair(uv_new, uvhat_new, uv_init, uvhat_init, max_flow: float):
    """Jointly guard Alt-BA's coupled (uv, uvhat) pair.

    The fields are coupled through lambda2*rho'(uv - uvhat): if either
    diverges the other is already contaminated, so both roll back
    together.
    """
    ok = jnp.logical_and(
        flow_is_healthy(uv_new, max_flow), flow_is_healthy(uvhat_new, max_flow)
    )
    init_ok = jnp.logical_and(
        flow_is_healthy(uv_init, max_flow), flow_is_healthy(uvhat_init, max_flow)
    )
    safe_uv = jnp.where(init_ok, uv_init, 0.0)
    safe_uvhat = jnp.where(init_ok, uvhat_init, 0.0)
    return jnp.where(ok, uv_new, safe_uv), jnp.where(ok, uvhat_new, safe_uvhat)


def flow_health(uv) -> dict:
    """Host-side diagnostic summary (for logs / checkpoint metadata)."""
    arr = np.asarray(uv)
    finite = np.isfinite(arr)
    return {
        "finite_frac": float(finite.mean()),
        "max_abs": float(np.abs(arr[finite]).max()) if finite.any() else float("inf"),
        "healthy": bool(finite.all()),
    }
