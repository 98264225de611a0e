#!/usr/bin/env python
"""Smoke run of the flow engine on one NVIDIA GPU: the main path, end to end.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --chips 4    # four cards: the multi-device paths only

Phases on one card, in one process, at real sizes, through the entry points
a user calls, with frames from ``data/``:

1. weighted-median kernel (Pallas, Triton route) against the XLA sort path
   at 388x584 and 2160x3840 (hsz=7, C=3): pixels that differ, per-call time;
2. the XLA PCG on a 388x584 system against a float64 solve on the CPU;
3. flagship: ``estimate_flow`` classic+nl-fast on RubberWhale from uint8
   frames (the fused program), held to the reference oracle's gates, with
   compile and steady latency, the same for ``fuse=False``, and the
   difference between the two;
4. ``hs`` the same way;
5. ``estimate_flow_batched_rgb`` with B=4 against four single calls;
6. one classic+nl-fast pair at 3840x2160 (built as benchmarks/profile4k.py
   builds it): memory, finiteness, the known 2-px shift.

With ``--chips 4``: RubberWhale with ``mesh=flow_mesh(space=4)`` against one
device, and ``estimate_flow_batched`` over ``flow_mesh(batch=4)`` against
unsharded.

Exits non-zero, printing no result, when JAX finds no GPU or a phase fails.
The last line of stdout is one JSON object naming the device.
"""
import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WMEDIAN_SIZES = ((388, 584), (2160, 3840))
PCG_SIZE = (388, 584)
SIZE_4K = (2160, 3840)


def log(*a):
    print(*a, flush=True)


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def timed(fn, n):
    """Run ``fn`` n times, each ended by block_until_ready; (out, seconds)."""
    import jax

    out, ts = None, []
    for _ in range(n):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return out, ts


def ms(ts):
    return "[" + ", ".join(f"{1e3 * t:.2f}" for t in ts) + "] ms"


def memory_line(compiled):
    m = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes", "peak_memory_in_bytes")
    return ", ".join(f"{k}={getattr(m, k)}" for k in keys if hasattr(m, k))


def peak_bytes():
    import jax

    return jax.devices()[0].memory_stats().get("peak_bytes_in_use")


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------
def phase_wmedian(rng):
    """Kernel vs XLA sort path at both widths: equality, then per-call time."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from optical_flow_tpu.ops.pallas.wmedian_kernel import wmedian_pallas
    from optical_flow_tpu.ops.wmedian import wmedfilt_prepadded

    hsz, C, sigma = 7, 3, 7.0
    for H, W in WMEDIAN_SIZES:
        uv = (3 * rng.standard_normal((H, W, 2))).astype(np.float32)
        uv[: H // 2] = np.round(uv[: H // 2] * 4) / 4  # half the rows: many ties
        color = rng.uniform(0, 255, (H, W, C)).astype(np.float32)
        occ = rng.uniform(0.1, 1.0, (H, W)).astype(np.float32)
        pad = lambda x: jnp.pad(jnp.asarray(x), hsz, mode="reflect")
        u_pad, v_pad, occ_pad = pad(uv[:, :, 0]), pad(uv[:, :, 1]), pad(occ)
        color_pad = jnp.pad(jnp.asarray(color), ((hsz, hsz), (hsz, hsz), (0, 0)), mode="reflect")
        cmaj = jnp.transpose(color_pad, (2, 0, 1))
        color_d = jnp.asarray(color)

        kern = jax.jit(lambda u, v, o, c: wmedian_pallas(u, v, o, c, (H, W), hsz, sigma))
        sort = jax.jit(
            lambda u, v, o, cp, cc: wmedfilt_prepadded(u, v, o, cp, cc, H, W, hsz, sigma)
        )
        t0 = time.perf_counter()
        out_k = np.asarray(jax.block_until_ready(kern(u_pad, v_pad, occ_pad, cmaj)))
        t_ck = time.perf_counter() - t0
        t0 = time.perf_counter()
        out_s = np.asarray(jax.block_until_ready(sort(u_pad, v_pad, occ_pad, color_pad, color_d)))
        t_cs = time.perf_counter() - t0
        check(out_k.shape == (H, W, 2) and np.isfinite(out_k).all(), "kernel output")
        diff = out_k != out_s
        n_diff = int(diff.sum())
        max_diff = float(np.abs(out_k - out_s).max())
        # every output must be one of its own window's values
        k = 2 * hsz + 1
        ys, xs, cs = np.nonzero(diff)
        fields = (np.asarray(u_pad), np.asarray(v_pad))
        members = all(
            np.any(fields[c][y : y + k, x : x + k] == out_k[y, x, c])
            for y, x, c in zip(ys[:10000], xs[:10000], cs[:10000])
        )
        log(f"wmedian {H}x{W}: pixels differing {n_diff} of {2 * H * W}, "
            f"max |diff| {max_diff:.3g}, differing outputs in window: {members}; "
            f"first call (compile+run) kernel {t_ck:.1f}s sort {t_cs:.1f}s")
        check(members, "kernel output outside its window")
        check(n_diff <= 1e-4 * H * W, f"kernel differs from the sort path at {n_diff} pixels")
        n = 10 if H < 1000 else 3
        _, tk = timed(lambda: kern(u_pad, v_pad, occ_pad, cmaj), n)
        _, ts = timed(lambda: sort(u_pad, v_pad, occ_pad, color_pad, color_d), n)
        log(f"wmedian {H}x{W} per call: kernel median {1e3 * sorted(tk)[n // 2]:.3f} ms "
            f"{ms(tk)}; sort median {1e3 * sorted(ts)[n // 2]:.3f} ms {ms(ts)}")


def phase_pcg(rng):
    """XLA PCG (float32, GPU) vs a float64 solve of the same system on CPU."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from optical_flow_tpu.ops.stencil import FlowSystem, system_apply
    from optical_flow_tpu.solvers.cg import solve_flow_system

    H, W = PCG_SIZE
    f = lambda *s: rng.uniform(0.1, 1.0, s)
    w = [f(H, W) for _ in range(4)]
    for i in (0, 2):
        w[i][:, -1] = 0
    for i in (1, 3):
        w[i][-1, :] = 0
    fields = [f(H, W) + 1.0, 0.5 * f(H, W), f(H, W) + 1.0, *w, f(H, W), f(H, W)]
    rtol = 1e-6
    solve = jax.jit(lambda s: solve_flow_system(s, "pcg", rtol, 2000))
    sys32 = FlowSystem(*[jnp.asarray(a, jnp.float32) for a in fields])
    x32 = np.asarray(jax.block_until_ready(solve(sys32)), np.float64)
    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        sys64 = FlowSystem(*[jnp.asarray(a, jnp.float64) for a in fields])
        x64 = np.asarray(solve_flow_system(sys64, "pcg", 1e-12, 5000))
        r = np.asarray(system_apply(sys64, jnp.asarray(x32))) - np.stack(fields[7:], -1)
    rel = np.linalg.norm(x32 - x64) / np.linalg.norm(x64)
    rres = np.linalg.norm(r) / np.linalg.norm(np.stack(fields[7:], -1))
    log(f"pcg {H}x{W}: relative error vs float64 CPU solve {rel:.3g} (limit 1e-4), "
        f"relative residual {rres:.3g} (rtol {rtol})")
    check(rel <= 1e-4, "PCG disagrees with the float64 solve")


def _oracle_check(name, uv, tu, tv, oracle_method):
    import numpy as np

    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    from middlebury import GATES, load_ref_oracle

    from optical_flow_tpu.evaluation.metrics import flow_angular_error

    uv = np.asarray(uv)
    aae, _, aepe = flow_angular_error(tu, tv, uv[:, :, 0], uv[:, :, 1])
    ref = load_ref_oracle(oracle_method)["RubberWhale"]
    g_aae, g_aepe = GATES[oracle_method]
    ok = abs(aae - ref["aae"]) <= g_aae and abs(aepe - ref["aepe"]) <= g_aepe
    log(f"{name}: AAE {aae:.4f} deg AEPE {aepe:.5f} px; oracle {ref['aae']} / "
        f"{ref['aepe']}; gate ({g_aae} deg, {g_aepe} px): {'pass' if ok else 'FAIL'}")
    check(ok, f"{name} outside the oracle gate")
    return aae, aepe


def phase_method(method, im1, im2, tu, tv, steady_runs=5):
    """Fused uint8 path and per-level path of one method on RubberWhale."""
    import numpy as np

    from optical_flow_tpu.interface import estimate_flow

    p_fused = {"display": False}
    p_level = {"display": False, "fuse": False}
    t0 = time.perf_counter()
    _, _ = timed(lambda: estimate_flow(im1, im2, method, p_fused), 1)
    warm_f = time.perf_counter() - t0
    uv_f, ts_f = timed(lambda: estimate_flow(im1, im2, method, p_fused), steady_runs)
    log(f"{method} fused: warm-up (compile) {warm_f:.1f}s; steady {ms(ts_f)}")
    t0 = time.perf_counter()
    _, _ = timed(lambda: estimate_flow(im1, im2, method, p_level), 1)
    warm_l = time.perf_counter() - t0
    uv_l, ts_l = timed(lambda: estimate_flow(im1, im2, method, p_level), steady_runs)
    log(f"{method} fuse=False: warm-up (compile) {warm_l:.1f}s; steady {ms(ts_l)}")
    uv_f, uv_l = np.asarray(uv_f), np.asarray(uv_l)
    check(uv_f.shape == im1.shape[:2] + (2,) and np.isfinite(uv_f).all(), "flow shape/finite")
    log(f"{method}: max |fused - per-level| {np.abs(uv_f - uv_l).max():.3g} px, "
        f"mean {np.abs(uv_f - uv_l).mean():.3g} px")
    oracle_method = "hs" if method == "hs" else method
    _oracle_check(f"{method} fused", uv_f, tu, tv, oracle_method)
    _oracle_check(f"{method} fuse=False", uv_l, tu, tv, oracle_method)
    return uv_f


def flagship_memory(im1, im2):
    """memory_analysis() of the fused classic+nl-fast program for one pair."""
    import jax.numpy as jnp

    from optical_flow_tpu.config import load_of_method
    from optical_flow_tpu.interface import _ship_exact
    from optical_flow_tpu.methods.classic_nl import (
        classic_nl_flow_from_gray,
        classic_nl_flow_from_rgb,
    )

    ope = load_of_method("classic+nl-fast")
    plan = ope._make_nl_plan(tuple(im1.shape[:2]), use_color=True)
    a1, a2 = _ship_exact(im1, jnp.float32), _ship_exact(im2, jnp.float32)
    fn = classic_nl_flow_from_rgb if im1.ndim == 3 else classic_nl_flow_from_gray
    return memory_line(fn.lower(plan, a1, a2, jnp.float32).compile())


def pair_rgb(seq):
    import numpy as np

    from optical_flow_tpu.io.flo import read_flow_file

    im1, im2, tu, tv = read_flow_file(seq, 10)
    return im1.astype(np.uint8), im2.astype(np.uint8), tu, tv


def phase_batch():
    """estimate_flow_batched_rgb, B=4, against four single calls."""
    import jax
    import numpy as np

    from optical_flow_tpu.interface import estimate_flow
    from optical_flow_tpu.parallel.batch import estimate_flow_batched_rgb

    rw = pair_rgb("RubberWhale")
    pairs = [rw[:2]] + [pair_rgb(s)[:2] for s in ("Hydrangea", "Dimetrodon")]
    pairs.append(tuple(np.ascontiguousarray(a[:, ::-1]) for a in pairs[0]))  # mirrored
    b1 = np.stack([p[0] for p in pairs])
    b2 = np.stack([p[1] for p in pairs])
    params = {"display": False}
    t0 = time.perf_counter()
    uvb = np.asarray(jax.block_until_ready(
        estimate_flow_batched_rgb(b1, b2, "classic+nl-fast", params=params)))
    warm = time.perf_counter() - t0
    _, ts = timed(lambda: estimate_flow_batched_rgb(b1, b2, "classic+nl-fast", params=params), 3)
    singles = np.stack([np.asarray(estimate_flow(a, b, "classic+nl-fast", params)) for a, b in pairs])
    d = np.abs(uvb - singles)
    # A vmapped program may reduce in another order than the single-pair one;
    # the CG and median selections then differ at a few pixels.  The mean
    # bound is the one tests/test_parallel.py holds batched classic+nl to.
    log(f"batch B=4 {b1.shape[1]}x{b1.shape[2]}: warm-up {warm:.1f}s; steady {ms(ts)}; vs four "
        f"single calls max |diff| {d.max():.3g} px, mean {d.mean():.3g} px (limit mean 1e-3)")
    check(uvb.shape == singles.shape and np.isfinite(uvb).all(), "batch output")
    check(d.mean() <= 1e-3, "batched flow differs from single calls")
    _oracle_check("batch element 0 (RubberWhale)", uvb[0], rw[2], rw[3], "classic+nl-fast")


def frames_4k(shift=2):
    """Smooth seeded texture and its copy rolled right by ``shift`` pixels."""
    import numpy as np
    from scipy.ndimage import gaussian_filter

    H, W = SIZE_4K
    rng = np.random.default_rng(0)
    base = gaussian_filter(rng.uniform(0, 255, (H, W)), 1.5).astype(np.float32)
    return base, np.roll(base, shift, axis=1)


def phase_4k():
    import jax
    import numpy as np

    from optical_flow_tpu.interface import estimate_flow

    im1, im2 = frames_4k()
    params = {"display": False}
    peak0 = peak_bytes()
    t0 = time.perf_counter()
    jax.block_until_ready(estimate_flow(im1, im2, "classic+nl-fast", params))
    warm = time.perf_counter() - t0
    uv, ts = timed(lambda: estimate_flow(im1, im2, "classic+nl-fast", params), 2)
    uv = np.asarray(uv)
    log(f"4K {SIZE_4K[1]}x{SIZE_4K[0]} classic+nl-fast: warm-up (compile) {warm:.1f}s; steady {ms(ts)}")
    log(f"4K fused program memory: {flagship_memory(im1, im2)}")
    log(f"4K peak_bytes_in_use: process {peak_bytes()} (before this phase {peak0})")
    inner = uv[16:-16, 16:-16]
    mu, mv = float(np.median(inner[..., 0])), float(np.median(inner[..., 1]))
    log(f"4K flow: finite {bool(np.isfinite(uv).all())}, median u {mu:.4f} (expect 2), "
        f"median v {mv:.4f} (expect 0)")
    check(np.isfinite(uv).all(), "4K flow not finite")
    check(abs(mu - 2.0) <= 0.05 and abs(mv) <= 0.05, "4K shift not recovered")


def phase_four_chips():
    """mesh= row-sharding and batch DP over four cards, against one device."""
    import numpy as np

    from optical_flow_tpu.interface import estimate_flow
    from optical_flow_tpu.parallel.batch import estimate_flow_batched, preprocess_color_batch
    from optical_flow_tpu.parallel.mesh import flow_mesh

    im1, im2, tu, tv = pair_rgb("RubberWhale")
    level = {"display": False, "fuse": False}
    uv1 = np.asarray(estimate_flow(im1, im2, "classic+nl-fast", level))
    t0 = time.perf_counter()
    uv4 = np.asarray(estimate_flow(im1, im2, "classic+nl-fast", {"display": False},
                                   mesh=flow_mesh(space=4)))
    log(f"space=4 RubberWhale classic+nl-fast: first call {time.perf_counter() - t0:.1f}s")
    _, ts = timed(lambda: estimate_flow(im1, im2, "classic+nl-fast", {"display": False},
                                        mesh=flow_mesh(space=4)), 2)
    d = np.abs(uv4 - uv1)
    log(f"space=4 vs one device (per-level): max |diff| {d.max():.3g} px, mean "
        f"{d.mean():.3g} px (limit mean 1e-3); steady {ms(ts)}")
    _oracle_check("space=4 classic+nl-fast", uv4, tu, tv, "classic+nl-fast")
    check(d.mean() <= 1e-3, "space-sharded flow differs from one device")

    pairs = [pair_rgb(s)[:2] for s in ("RubberWhale", "Hydrangea", "Dimetrodon")]
    pairs.append(tuple(np.ascontiguousarray(a[:, ::-1]) for a in pairs[0]))
    images, color = preprocess_color_batch(np.stack([p[0] for p in pairs]),
                                           np.stack([p[1] for p in pairs]))
    ref = np.asarray(estimate_flow_batched(images, "classic+nl-fast", params=level,
                                           color_batch=color))
    t0 = time.perf_counter()
    out = np.asarray(estimate_flow_batched(images, "classic+nl-fast", mesh=flow_mesh(batch=4),
                                           params=level, color_batch=color))
    log(f"batch=4 DP: first call {time.perf_counter() - t0:.1f}s")
    d = np.abs(out - ref)
    log(f"batch=4 DP vs unsharded (per-level): max |diff| {d.max():.3g} px, mean "
        f"{d.mean():.3g} px (limit mean 1e-3)")
    check(np.isfinite(out).all() and d.mean() <= 1e-3, "batch-sharded flow differs")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = ap.parse_args()

    sys.path.insert(0, REPO)
    try:
        from optical_flow_tpu.utils.compile_cache import enable_compile_cache
    except ImportError as e:
        fail(f"the optical_flow_tpu package is not beside this script ({e})")

    import jax
    import numpy as np

    devices = jax.devices()
    if devices[0].platform != "gpu":
        fail(f"no GPU: JAX found {devices[0].platform} devices")
    if len(devices) < args.chips:
        fail(f"--chips {args.chips} needs {args.chips} GPUs, found {len(devices)}")
    cache = enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    log(f"device_kind: {devices[0].device_kind}; device count: {len(devices)}; "
        f"jax {jax.__version__}")
    log(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')!r}; compile cache: {cache}")
    log(f"nvidia-smi: {smi.stdout.strip()}")
    t_start = time.perf_counter()

    rng = np.random.default_rng(0)
    if args.chips == 4:
        phase_four_chips()
    else:
        phase_wmedian(rng)
        phase_pcg(rng)
        im1, im2, tu, tv = pair_rgb("RubberWhale")
        phase_method("classic+nl-fast", im1, im2, tu, tv)
        log(f"584x388 fused program memory: {flagship_memory(im1, im2)}")
        phase_method("hs", im1, im2, tu, tv)
        phase_batch()
        phase_4k()
    log(f"total {time.perf_counter() - t_start:.1f}s after start-up")
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind, "count": len(d)}}))


if __name__ == "__main__":
    main()
