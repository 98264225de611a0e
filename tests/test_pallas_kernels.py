"""Pallas GPU kernels, verified in interpreter mode against the XLA paths."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest


@pytest.fixture(autouse=True)
def _fresh_compile_state():
    """Interpret-mode kernel compiles are large (K2 unrolled slices); with a
    full suite's worth of live executables XLA:CPU's next big compile can
    abort the process (same issue test_parallel.py works around).  Start
    these tests from a clean compilation cache."""
    jax.clear_caches()
    yield

from optical_flow_tpu.ops.pallas import wmedian_kernel as wk
from optical_flow_tpu.ops.pallas.wmedian_kernel import wmedian_pallas, wmedian_pallas_ok
from optical_flow_tpu.ops.wmedian import denoise_color_weighted_medfilt2


@pytest.mark.parametrize("shape,hsz,C", [((19, 23), 3, 3), ((40, 300), 7, 3), ((16, 260), 2, 1)])
def test_wmedian_kernel_bit_exact(rng, shape, hsz, C):
    """The bit-bisection selection must match sort+cumsum+searchsorted exactly."""
    H, W = shape
    uv = (3 * rng.standard_normal((H, W, 2))).astype(np.float32)
    color = rng.uniform(0, 255, (H, W, C)).astype(np.float32)
    occ = rng.uniform(0.1, 1.0, (H, W)).astype(np.float32)

    ref = np.asarray(
        denoise_color_weighted_medfilt2(
            jnp.asarray(uv), jnp.asarray(color), jnp.asarray(occ), hsz, [5, 5], 7.0
        )
    )
    u_pad = jnp.pad(uv[:, :, 0], hsz, mode="reflect")
    v_pad = jnp.pad(uv[:, :, 1], hsz, mode="reflect")
    occ_pad = jnp.pad(occ, hsz, mode="reflect")
    cmaj = jnp.transpose(
        jnp.pad(color, ((hsz, hsz), (hsz, hsz), (0, 0)), mode="reflect"), (2, 0, 1)
    )
    out = np.asarray(
        wmedian_pallas(u_pad, v_pad, occ_pad, cmaj, (H, W), hsz, 7.0, True)
    )
    np.testing.assert_array_equal(out, ref)


def test_wmedian_kernel_duplicate_values(rng):
    """Mirror padding creates exact duplicates — selection must still match."""
    H, W, hsz = 12, 140, 4
    uv = np.round(rng.standard_normal((H, W, 2)) * 4) / 4  # many ties
    uv = uv.astype(np.float32)
    color = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    occ = rng.uniform(0.1, 1.0, (H, W)).astype(np.float32)
    ref = np.asarray(
        denoise_color_weighted_medfilt2(
            jnp.asarray(uv), jnp.asarray(color), jnp.asarray(occ), hsz, [5, 5], 7.0
        )
    )
    u_pad = jnp.pad(uv[:, :, 0], hsz, mode="reflect")
    v_pad = jnp.pad(uv[:, :, 1], hsz, mode="reflect")
    occ_pad = jnp.pad(occ, hsz, mode="reflect")
    cmaj = jnp.transpose(
        jnp.pad(color, ((hsz, hsz), (hsz, hsz), (0, 0)), mode="reflect"), (2, 0, 1)
    )
    out = np.asarray(
        wmedian_pallas(u_pad, v_pad, occ_pad, cmaj, (H, W), hsz, 7.0, True)
    )
    np.testing.assert_array_equal(out, ref)


def test_wmedian_guard():
    """The patch axis (2*hsz+1)^2 is padded to the kernel's 256 lanes, so
    the kernel applies up to hsz=7 (225 patch values) at any image size."""
    assert wk.LANES == 256 and (wk.LANES & (wk.LANES - 1)) == 0
    assert wk.BLOCK_PIXELS & (wk.BLOCK_PIXELS - 1) == 0
    assert wmedian_pallas_ok(388, 584, 7, 3)
    assert wmedian_pallas_ok(2160, 3840, 7, 3)
    assert not wmedian_pallas_ok(100, 100, 8, 3)  # 289 patch values > 256 lanes
    assert not wmedian_pallas_ok(2**15, 2**15, 7, 3)  # flat indices overflow int32


def test_wmedian_kernel_block_count():
    """One program per BLOCK_PIXELS output pixels, row-major over (H, W):
    the grid covers ceil(H*W / BLOCK_PIXELS) blocks and the tail block's
    masked pixels are cropped away."""
    H, W, hsz, C = 5, 7, 1, 1  # 35 pixels: full blocks + a partial tail
    traced = jax.jit(
        lambda u, v, o, c: wmedian_pallas(u, v, o, c, (H, W), hsz, 7.0, True)
    ).trace(
        *(jax.ShapeDtypeStruct((H + 2 * hsz, W + 2 * hsz), jnp.float32),) * 3,
        jax.ShapeDtypeStruct((C, H + 2 * hsz, W + 2 * hsz), jnp.float32),
    )
    n_blk = -(-(H * W) // wk.BLOCK_PIXELS)
    assert (H * W) % wk.BLOCK_PIXELS != 0
    assert f"f32[1,{n_blk * wk.BLOCK_PIXELS}]" in str(traced.jaxpr)
    assert traced.out_info.shape == (H, W, 2)


def test_wmedian_kernel_vmap_batched(rng):
    """vmap of the kernel routes through the custom batching rule (leading
    batch GRID axis) and must equal the per-pair results bit-exactly."""
    import jax

    H, W, hsz, C, B = 40, 56, 7, 3, 3
    Hp, Wp = H + 2 * hsz, W + 2 * hsz
    u = rng.standard_normal((B, Hp, Wp)).astype(np.float32)
    v = rng.standard_normal((B, Hp, Wp)).astype(np.float32)
    occ = rng.uniform(0.1, 1.0, (B, Hp, Wp)).astype(np.float32)
    col = rng.uniform(0, 255, (B, C, Hp, Wp)).astype(np.float32)

    singles = [
        np.asarray(wmedian_pallas(u[b], v[b], occ[b], col[b], (H, W), hsz, 7.0, True))
        for b in range(B)
    ]
    batched = np.asarray(
        jax.jit(
            jax.vmap(lambda a, b_, c, d: wmedian_pallas(a, b_, c, d, (H, W), hsz, 7.0, True))
        )(u, v, occ, col)
    )
    for b in range(B):
        np.testing.assert_array_equal(batched[b], singles[b])
