"""Pallas GPU kernel (Triton route): color-guided weighted median by bisection.

The XLA formulation (ops/wmedian.py) materializes (H, W, P) patch stacks in
device memory (P = (2·hsz+1)² = 225 at hsz=7; six float32 stacks of ~204 MB
each at 584x388) and key-value sorts every pixel's P pairs.  This kernel
computes the same weighted median with no stack and no sort:

* float32 values are encoded into *order-isomorphic* signed int32 keys
  (sign-magnitude flip), so the weighted median becomes: the smallest key
  ``m`` with S(m) = sum of weights of keys <= m  >=  total/2.
* 32 rounds of integer bisection over the key space find ``m`` exactly —
  the invariant S(lo) < total/2 <= S(hi) contracts to adjacent integers,
  and since S only jumps at present keys, ``hi`` lands exactly on a
  sample.  This reproduces the reference's sort+cumsum+searchsorted
  selection (``weighted_median.py:5-21``) without ordering any data.

Layout: one program per block of ``BLOCK_PIXELS`` output pixels (row-major
over the (H, W) output).  The patch axis is padded to ``LANES`` = 256 lanes
and masked.  Each program gathers its neighbours from the reflect-padded
planes with masked loads through ``[BLOCK_PIXELS, LANES]`` integer index
tensors, computes the color-affinity × occlusion weight once (u and v share
it), encodes both fields' keys, and then runs all 32 bisection rounds of
both fields on those register-resident tensors: each round is a masked
weighted row sum and a lo/hi update, with no memory traffic.

Weight sums are taken in a different order than the sort path's cumulative
sum, so a pixel whose half-weight crossing is a float tie could in
principle select a neighbouring sample; the output is always one of the
window's own values either way.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BLOCK_PIXELS = 2  # output pixels per program (a power of two)
LANES = 256  # patch axis, padded from (2*hsz+1)^2 (a power of two)
NUM_WARPS = 1

_SIGN = np.int32(np.uint32(0x80000000).view(np.int32))  # int32 min
_INT_MAX = np.int32(0x7FFFFFFF)


def _encode_f32(x):
    """Order-isomorphic SIGNED int32 key of a float32 value.

    x >= 0 -> raw bits; x < 0 -> ~bits ^ 0x80000000.  Signed integer order
    then matches float order.
    """
    b = jax.lax.bitcast_convert_type(x, jnp.int32)
    return jnp.where(b < 0, jnp.invert(b) ^ _SIGN, b)


def _decode_i32(key):
    """Inverse of :func:`_encode_f32`."""
    b = jnp.where(key < 0, jnp.invert(key ^ _SIGN), key)
    return jax.lax.bitcast_convert_type(b, jnp.float32)


def _midpoint(lo, hi):
    """Overflow-safe floor((lo + hi) / 2) for signed int32."""
    return (lo & hi) + ((lo ^ hi) >> 1)


def _wmedian_kernel(
    u_ref, v_ref, occ_ref, color_ref, out_u_ref, out_v_ref,
    *, H: int, W: int, Hp: int, Wp: int, hsz: int, n_chan: int,
    inv_2sigma2: float,
):
    k = 2 * hsz + 1
    b = pl.program_id(0)
    i = pl.program_id(1)
    plane = Hp * Wp

    p = i * BLOCK_PIXELS + jax.lax.broadcasted_iota(jnp.int32, (BLOCK_PIXELS,), 0)
    pix_ok = p < H * W
    row = p // W
    col = p % W
    o = jax.lax.broadcasted_iota(jnp.int32, (LANES,), 0)
    lane_ok = o < k * k
    ok = pix_ok[:, None] & lane_ok[None, :]

    # flat indices within one (Hp, Wp) plane; masked lanes point at the
    # plane origin so every address stays in range
    nbr = (row[:, None] + (o // k)[None, :]) * Wp + (col[:, None] + (o % k)[None, :])
    nbr = jnp.where(ok, nbr, 0)
    ctr = jnp.where(pix_ok, (row + hsz) * Wp + (col + hsz), 0)

    def gather(ref, idx, mask, plane_index):
        return plgpu.load(ref.at[idx + plane_index * plane], mask=mask, other=0.0)

    cdiff = jnp.zeros((BLOCK_PIXELS, LANES), jnp.float32)
    for c in range(n_chan):
        cp = b * n_chan + c  # color is (batch * C, Hp, Wp)
        d = gather(color_ref, nbr, ok, cp) - gather(color_ref, ctr, pix_ok, cp)[:, None]
        cdiff = cdiff + d * d
    occ = gather(occ_ref, nbr, ok, b)
    w = jnp.maximum(jnp.exp(-cdiff * inv_2sigma2) * occ, 1e-10)
    w = jnp.where(ok, w, 0.0)
    half = jnp.sum(w, axis=1) * 0.5

    def keys_and_bounds(ref):
        keys = _encode_f32(gather(ref, nbr, ok, b))
        lo = jnp.min(jnp.where(ok, keys, _INT_MAX), axis=1)
        hi = jnp.max(jnp.where(ok, keys, _SIGN), axis=1)
        # S(lo) must be < half: step just below the smallest present key
        # (finite float32 never encodes to int32 min, so this cannot wrap).
        # Padding lanes get the largest key, which no midpoint reaches.
        return jnp.where(ok, keys, _INT_MAX), lo - 1, hi

    ku, lo_u, hi_u = keys_and_bounds(u_ref)
    kv, lo_v, hi_v = keys_and_bounds(v_ref)

    def step(keys, lo, hi):
        mid = _midpoint(lo, hi)
        S = jnp.sum(jnp.where(keys <= mid[:, None], w, 0.0), axis=1)
        ge = S >= half
        return jnp.where(ge, lo, mid), jnp.where(ge, mid, hi)

    def bisect(_, carry):
        lo_u, hi_u, lo_v, hi_v = carry
        return (*step(ku, lo_u, hi_u), *step(kv, lo_v, hi_v))

    _, hi_u, _, hi_v = jax.lax.fori_loop(0, 32, bisect, (lo_u, hi_u, lo_v, hi_v))
    out_u_ref[...] = _decode_i32(hi_u)
    out_v_ref[...] = _decode_i32(hi_v)


def _wmedian_call(u, v, occ, color, *, out_hw, hsz, sigma_i, interpret):
    """Batched kernel invocation: (B, Hp, Wp) fields + (B, C, Hp, Wp) guide
    -> (B, H, W, 2) medians, one pallas_call with a leading batch grid axis."""
    B, Hp, Wp = u.shape
    H, W = out_hw
    C = color.shape[1]
    if B * C * Hp * Wp >= 2**31:
        raise ValueError("weighted-median kernel: flat plane indices overflow int32")
    n_blk = -(-(H * W) // BLOCK_PIXELS)
    kernel = functools.partial(
        _wmedian_kernel, H=H, W=W, Hp=Hp, Wp=Wp, hsz=hsz, n_chan=C,
        inv_2sigma2=float(1.0 / (2.0 * sigma_i**2)),
    )
    out_spec = pl.BlockSpec((None, BLOCK_PIXELS), lambda b, i: (b, i))
    out_shape = jax.ShapeDtypeStruct((B, n_blk * BLOCK_PIXELS), jnp.float32)
    flat = lambda x: x.reshape(-1)
    out_u, out_v = pl.pallas_call(
        kernel,
        grid=(B, n_blk),
        out_shape=(out_shape, out_shape),
        out_specs=(out_spec, out_spec),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="wmedian_bisect",
    )(flat(u), flat(v), flat(occ), flat(color))
    crop = lambda x: x[:, : H * W].reshape(B, H, W)
    return jnp.stack([crop(out_u), crop(out_v)], axis=-1)


@functools.lru_cache(maxsize=None)
def _wmedian_dispatch(out_hw, hsz, sigma_i, interpret):
    """custom_vmap wrapper per static configuration: the vmap rule stacks
    the batch into the kernel's leading GRID axis — one compiled program,
    B x n_blk programs, identical per-block work."""
    call = functools.partial(
        _wmedian_call, out_hw=out_hw, hsz=hsz, sigma_i=sigma_i, interpret=interpret
    )

    @jax.custom_batching.custom_vmap
    def wm(u, v, occ, color):
        return call(u[None], v[None], occ[None], color[None])[0]

    @wm.def_vmap
    def _rule(axis_size, in_batched, u, v, occ, color):
        args = [
            x if bat else jnp.broadcast_to(x, (axis_size, *x.shape))
            for x, bat in zip((u, v, occ, color), in_batched)
        ]
        return call(*args), True

    return wm


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7))
def wmedian_pallas(
    u_pad,
    v_pad,
    occ_pad,
    color_pad_cmajor,
    out_hw,
    area_hsz: int,
    sigma_i: float,
    interpret: bool = False,
):
    """Weighted median of both flow fields over (2h+1)^2 patches.

    Args:
        u_pad, v_pad, occ_pad: mirror-padded (H+2h, W+2h) float32 fields.
        color_pad_cmajor: (C, H+2h, W+2h) float32 padded guide image.
        out_hw: static (H, W) output size.
        interpret: run the kernel in the Pallas interpreter (CPU tests only).
    Returns (H, W, 2) medians.  vmap-safe (see :func:`_wmedian_dispatch`).
    """
    dispatch = _wmedian_dispatch(
        tuple(out_hw), int(area_hsz), float(sigma_i), bool(interpret)
    )
    return dispatch(u_pad, v_pad, occ_pad, color_pad_cmajor)


def wmedian_pallas_ok(H, W, hsz, C) -> bool:
    """True when the kernel applies: the patch fits the padded lane axis and
    every flat index of the planes fits int32."""
    k = 2 * hsz + 1
    return k * k <= LANES and C * (H + 2 * hsz) * (W + 2 * hsz) < 2**31
