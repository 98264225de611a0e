"""Failure detection + recovery (utils/guard.py) — SURVEY §5 aux subsystems.

The reference has no failure handling: its classic-c-a divergence
(``/root/reference/optical_flow/methods/alt_ba.py:189-274``, captured in
tests/test_full_parity.py) exits estimate_flow as ~1e48 garbage.  These
tests pin the framework's opt-in level-boundary guard: detection +
rollback on divergent levels, and bit-identical behavior on healthy runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.ndimage import gaussian_filter

from optical_flow_tpu.config import load_of_method


@pytest.fixture(autouse=True)
def _drop_compiled_programs_per_test():
    """Per-TEST cache clearing: guarded monoliths are large executables and
    this jaxlib's XLA:CPU aborts the process once too many accumulate (see
    tests/test_fused.py for the full story)."""
    yield
    jax.clear_caches()
from optical_flow_tpu.utils.guard import (
    flow_health,
    flow_is_healthy,
    guard_level,
    guard_level_pair,
)


def _smooth_pair(seed, h, w):
    rng = np.random.default_rng(seed)
    base = gaussian_filter(rng.uniform(0, 255, (h, w)), 1.0)
    im2 = np.roll(base, 1, axis=1)
    return base.astype(np.float64), im2.astype(np.float64)


def test_guard_level_passthrough_and_rollback():
    good = jnp.ones((4, 5, 2))
    init = jnp.zeros((4, 5, 2))
    np.testing.assert_array_equal(np.asarray(guard_level(good, init, 1e9)), 1.0)

    for poison in (jnp.nan, jnp.inf, -jnp.inf, 2e9):
        bad = good.at[2, 3, 1].set(poison)
        out = np.asarray(guard_level(bad, init, 1e9))
        np.testing.assert_array_equal(out, 0.0)  # whole-field rollback


def test_guard_rollback_target_is_guarded():
    """Over-threshold INIT (resample-scaled past max_flow after repeated
    rollbacks) must restart the level from zero, so a guarded result never
    exceeds max_flow."""
    init = jnp.full((3, 3, 2), 4e9)
    bad = jnp.full((3, 3, 2), jnp.inf)
    np.testing.assert_array_equal(np.asarray(guard_level(bad, init, 1e9)), 0.0)
    # a healthy result still passes through untouched
    good = jnp.ones((3, 3, 2))
    np.testing.assert_array_equal(np.asarray(guard_level(good, init, 1e9)), 1.0)
    a, b = guard_level_pair(bad, bad, init, init, 1e9)
    np.testing.assert_array_equal(np.asarray(a), 0.0)
    np.testing.assert_array_equal(np.asarray(b), 0.0)


def test_guard_level_pair_joint_rollback():
    uv = jnp.ones((3, 3, 2))
    uvhat = 2 * jnp.ones((3, 3, 2))
    z = jnp.zeros((3, 3, 2))
    # healthy pair passes through
    a, b = guard_level_pair(uv, uvhat, z, z, 1e9)
    assert np.asarray(a).max() == 1.0 and np.asarray(b).max() == 2.0
    # one sick field rolls BOTH back (they are coupled)
    a, b = guard_level_pair(uv, uvhat.at[0, 0, 0].set(jnp.nan), z, z, 1e9)
    np.testing.assert_array_equal(np.asarray(a), 0.0)
    np.testing.assert_array_equal(np.asarray(b), 0.0)


def test_flow_is_healthy_traced():
    assert bool(flow_is_healthy(jnp.ones((2, 2)), 1e9))
    assert not bool(flow_is_healthy(jnp.full((2, 2), jnp.nan), 1e9))
    h = flow_health(np.array([[1.0, np.inf]]))
    assert h["finite_frac"] == 0.5 and not h["healthy"]


def test_classic_c_a_guard_recovers():
    """The preset whose default config diverges (reference parity keeps the
    blow-up) returns a finite, scoreable flow with the guard enabled."""
    im1, im2 = _smooth_pair(0, 40, 44)
    images = jnp.asarray(np.stack([im1, im2], 2), jnp.float32)

    ope = load_of_method("classic-c-a")
    ope.display = False
    ope.dtype = jnp.float32  # the device dtype: the divergence overflows f32
    ope.guard_flow = None  # parity switch: reproduce the reference blow-up
    ope.images = images
    blown = np.asarray(ope.compute_flow())
    assert (~np.isfinite(blown)).any() or np.abs(blown).max() > 1e20

    # the preset DEFAULT (config.py: guard_flow=1e9, the reference metrics'
    # unknown-flow sentinel) recovers without the caller setting anything
    ope = load_of_method("classic-c-a")
    assert ope.guard_flow == 1e9
    ope.display = False
    ope.dtype = jnp.float32
    ope.images = images
    uv = np.asarray(ope.compute_flow())
    assert np.isfinite(uv).all()
    assert np.abs(uv).max() <= 1e9


def test_guard_is_noop_on_healthy_run():
    """Guarded and unguarded programs must be bit-identical when no level
    trips — the guard is a select on an all-true predicate."""
    im1, im2 = _smooth_pair(1, 48, 52)
    images = jnp.asarray(np.stack([im1, im2], 2), jnp.float32)

    flows = []
    for guard in (None, 1e9):
        ope = load_of_method("ba")
        ope.display = False
        ope.dtype = jnp.float32
        ope.max_iters = 3
        ope.guard_flow = guard
        ope.images = images
        flows.append(np.asarray(ope.compute_flow()))
    assert np.isfinite(flows[0]).all()
    np.testing.assert_array_equal(flows[0], flows[1])


def test_guard_in_fused_monolith():
    """guard_flow threads into the single-dispatch whole-flow program."""
    im1, im2 = _smooth_pair(2, 48, 52)
    images = jnp.asarray(np.stack([im1, im2], 2), jnp.float32)

    flows = []
    for fuse in (False, True):
        ope = load_of_method("classic+nl-fast")
        ope.display = False
        ope.dtype = jnp.float32
        ope.guard_flow = 1e9
        ope.fuse = fuse
        ope.images = images
        flows.append(np.asarray(ope.compute_flow()))
    assert np.isfinite(flows[0]).all()
    # same tolerance as test_fused.py: fused/per-level f32 reduction order
    np.testing.assert_allclose(flows[0], flows[1], atol=5e-3)
    assert np.abs(flows[0] - flows[1]).mean() < 1e-4


needs_8 = pytest.mark.skipif(
    len(__import__("jax").devices()) < 8, reason="needs 8 virtual devices"
)


@needs_8
def test_guard_in_spatial_sharded_level():
    """The sharded level step guards on the GLOBAL field (outside shard_map):
    guard=1e9 is a no-op on a healthy run; an unreachable threshold rolls the
    whole level back to its initialization (never a per-shard splice)."""
    import dataclasses

    from optical_flow_tpu.methods.classic_nl import classic_nl_level_step
    from optical_flow_tpu.parallel.mesh import flow_mesh
    from optical_flow_tpu.parallel.spatial import classic_nl_level_step_spatial

    mesh = flow_mesh(batch=1, space=8)
    ope = load_of_method("classic+nl-fast")
    ope.display = False
    cfg = ope._nl_cfg(use_color=True, max_linear=1)

    rng = np.random.default_rng(5)
    H, W = 64, 48
    im1 = gaussian_filter(rng.uniform(0, 255, (H, W)), 1.5)
    images = jnp.asarray(np.stack([im1, np.roll(im1, 1, 1)], -1), jnp.float64)
    color = jnp.asarray(rng.uniform(0, 255, (H, W, 3)), jnp.float64)
    uv = jnp.asarray(0.1 * rng.standard_normal((H, W, 2)), jnp.float64)
    alpha = jnp.asarray(0.4, jnp.float64)

    ref = np.asarray(classic_nl_level_step(cfg, images, color, uv, alpha))

    cfg_ok = dataclasses.replace(cfg, irls=dataclasses.replace(cfg.irls, guard=1e9))
    out = np.asarray(
        classic_nl_level_step_spatial(cfg_ok, images, color, uv, alpha, mesh, halo=6)
    )
    np.testing.assert_allclose(out, ref, atol=1e-8)

    # threshold below the healthy flow magnitude => whole-field rollback.
    # The init itself also exceeds this threshold, so the guarded rollback
    # target is zero flow (a guarded result NEVER exceeds max_flow).
    assert np.abs(ref).max() > 1e-6
    cfg_trip = dataclasses.replace(cfg, irls=dataclasses.replace(cfg.irls, guard=1e-6))
    out = np.asarray(
        classic_nl_level_step_spatial(cfg_trip, images, color, uv, alpha, mesh, halo=6)
    )
    np.testing.assert_array_equal(out, np.zeros_like(out))

    # with the init below threshold, rollback restores the init exactly
    mid = float(np.abs(ref).max() + np.abs(np.asarray(uv)).max()) / 2
    if np.abs(np.asarray(uv)).max() < mid < np.abs(ref).max():
        cfg_mid = dataclasses.replace(cfg, irls=dataclasses.replace(cfg.irls, guard=mid))
        out = np.asarray(
            classic_nl_level_step_spatial(cfg_mid, images, color, uv, alpha, mesh, halo=6)
        )
        np.testing.assert_array_equal(out, np.asarray(uv))


def test_guard_via_estimate_flow_params():
    """guard_flow is reachable through the public param dict."""
    from optical_flow_tpu.interface import estimate_flow

    im1, im2 = _smooth_pair(3, 40, 44)
    uv = np.asarray(
        estimate_flow(
            im1, im2, "hs-brightness", {"display": False, "guard_flow": 1e9}
        )
    )
    assert np.isfinite(uv).all()
