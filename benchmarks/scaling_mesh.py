#!/usr/bin/env python
"""Scaling efficiency vs device count on the virtual 8-device CPU mesh.

A throughput-per-device-vs-device-count curve of the ACTUAL sharded
programs on the 8-virtual-device CPU mesh:

* **SP strong scaling** — the production row-sharded classic+nl level step
  (``parallel/spatial.py``) on a fixed 512x512 problem at
  space ∈ {1, 2, 4, 8}: efficiency(N) = t(1) / (N * t(N)).
* **DP weak scaling** — the vmapped whole-flow HS program with one
  192x256 pair PER DEVICE at batch = N over an (N, 1) mesh:
  efficiency(N) = t(1) / t(N) (ideal: flat).

CAVEAT (printed with the result): CPU-mesh efficiency is a
correctness-weighted LOWER bound on what a device interconnect would
deliver — XLA:CPU emulates the collectives through shared memory, and
per-device compute shares one socket, so contention shows up as lost
"efficiency".  What the curve DOES pin: the sharded programs' collective
structure scales (no serialization, no replicated work growing with N).

Run:  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python benchmarks/scaling_mesh.py
(the script sets the flag itself if unset)
"""
from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

if "--xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )

import numpy as np  # noqa: E402


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def timed_best(fn, trials: int = 4):
    """best-of-N with ALL trials recorded (single-shot walls on a shared
    CPU swing with machine load; the min is the contention-free estimate)."""
    import jax

    walls = []
    for _ in range(trials):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        walls.append(round(time.perf_counter() - t0, 4))
    return min(walls), walls


def smooth(seed, shape, scale=255.0):
    from scipy.ndimage import gaussian_filter

    r = np.random.default_rng(seed)
    x = gaussian_filter(r.uniform(0, 1, shape), 1.5, mode="reflect")
    return (scale * (x - x.min()) / max(np.ptp(x), 1e-9)).astype(np.float32)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from optical_flow_tpu.config import load_of_method
    from optical_flow_tpu.methods.classic_nl import classic_nl_level_step
    from optical_flow_tpu.methods.hs import hs_flow_program
    from optical_flow_tpu.parallel.mesh import BATCH_AXIS, SPACE_AXIS, flow_mesh
    from optical_flow_tpu.parallel.spatial import classic_nl_level_step_spatial

    devs = jax.devices()
    assert len(devs) >= 8, f"need 8 virtual devices, got {len(devs)}"
    res = {
        "devices": len(devs),
        "backend": jax.default_backend(),
        "host_cores": os.cpu_count(),
    }

    # ------------------------------------------------------------------
    # SP strong scaling: fixed 512x512 classic+nl level step
    # ------------------------------------------------------------------
    ope = load_of_method("classic+nl-fast")
    ope.display = False
    ope.max_iters = 2
    cfg = ope._nl_cfg(use_color=True, max_linear=1)

    H, W = 512, 512
    im1 = smooth(1, (H, W))
    images = np.stack([im1, np.roll(im1, 1, axis=1)], -1)
    color = np.stack([smooth(s, (H, W)) for s in (2, 3, 4)], -1)
    uv = np.zeros((H, W, 2), np.float32)
    alpha = jnp.float32(0.5)

    sp_rows = {}
    for n in (1, 2, 4, 8):
        if n == 1:
            # unsharded single-device program — the t(1) the curve divides by
            fn = lambda: classic_nl_level_step(cfg, images, color, uv, alpha)
        else:
            mesh = flow_mesh(batch=1, space=n, devices=devs[:n])
            sh = NamedSharding(mesh, P(SPACE_AXIS))
            g_images = jax.device_put(images, sh)
            g_color = jax.device_put(color, sh)
            g_uv = jax.device_put(uv, sh)
            fn = (
                lambda g_images=g_images, g_color=g_color, g_uv=g_uv, mesh=mesh:
                classic_nl_level_step_spatial(
                    cfg, g_images, g_color, g_uv, alpha, mesh, halo=6
                )
            )
        t0 = time.perf_counter()
        jax.block_until_ready(fn())  # compile
        first = time.perf_counter() - t0
        best, walls = timed_best(fn)
        sp_rows[n] = {"t_s": best, "trials_s": walls, "first_call_s": round(first, 2)}
        log(f"SP space={n}: {best:.3f}s (first {first:.1f}s) trials={walls}")
    t1 = sp_rows[1]["t_s"]
    for n, row in sp_rows.items():
        row["speedup"] = round(t1 / row["t_s"], 3)
        row["efficiency_pct"] = round(100.0 * t1 / (n * row["t_s"]), 1)
    res["sp_strong_512x512_level"] = sp_rows

    # ------------------------------------------------------------------
    # DP weak scaling: one 192x256 HS pair per device
    # ------------------------------------------------------------------
    Hh, Wh = 192, 256
    ope_hs = load_of_method("hs-brightness")
    ope_hs.display = False
    plan = ope_hs._make_plan((Hh, Wh))
    base1 = smooth(7, (Hh, Wh))

    dp_rows = {}
    for n in (1, 2, 4, 8):
        base = np.stack([smooth(10 + i, (Hh, Wh)) for i in range(n)])
        images_b = np.stack([base, np.roll(base, 1, axis=2)], axis=3)
        uv0 = np.zeros((n, Hh, Wh, 2), np.float32)
        mesh = flow_mesh(batch=n, space=1, devices=devs[:n])
        sh = NamedSharding(mesh, P(BATCH_AXIS))
        g_images = jax.device_put(images_b, sh)
        g_uv0 = jax.device_put(uv0, sh)
        step = jax.jit(
            jax.vmap(lambda im, u: hs_flow_program(plan, im, u)),
            in_shardings=(sh, sh),
            out_shardings=sh,
        )
        t0 = time.perf_counter()
        jax.block_until_ready(step(g_images, g_uv0))
        first = time.perf_counter() - t0
        best, walls = timed_best(lambda: step(g_images, g_uv0))
        dp_rows[n] = {"t_s": best, "trials_s": walls, "first_call_s": round(first, 2)}
        log(f"DP batch={n} (1 pair/device): {best:.3f}s (first {first:.1f}s) trials={walls}")
    t1 = dp_rows[1]["t_s"]
    for n, row in dp_rows.items():
        row["efficiency_pct"] = round(100.0 * t1 / row["t_s"], 1)
        row["aggregate_pairs_per_s"] = round(n / row["t_s"], 2)
    res["dp_weak_192x256_hs"] = dp_rows

    # What the curve can and cannot say on THIS host: all virtual devices
    # share os.cpu_count() cores, and the single-device XLA:CPU program
    # already multi-threads across them — so past devices ~ cores/2 the
    # curve measures the socket, not the sharded programs.  Record the
    # reading explicitly so the artifact can't be quoted out of regime.
    cores = res["host_cores"]
    res["reading"] = {
        "sp_at_2_efficiency_pct": sp_rows[2]["efficiency_pct"],
        "regime_note": (
            f"{cores}-core host: space=2 is the only config whose devices do "
            "not oversubscribe the socket once single-device multithreading "
            "is accounted for; larger N measures host core count (aggregate "
            "DP throughput saturates near the socket's parallel capacity), "
            "not collective structure.  Structure itself is pinned by the "
            "HLO collective-count tests (test_parallel.py) and the "
            "2-process runtime (benchmarks/multihost.py)."
        ),
        "north_star_at_n2": "met" if sp_rows[2]["efficiency_pct"] >= 80 else "NOT met",
    }

    res["caveat"] = (
        "CPU-mesh efficiency is a correctness-weighted LOWER bound: XLA:CPU "
        "emulates collectives through shared memory and all virtual devices "
        "share one socket, so host contention reads as lost efficiency a "
        "device interconnect would not see.  What the curve pins: the sharded "
        "programs' collective structure (no serialization / replicated "
        "work growing with N)."
    )
    print(json.dumps(res))


if __name__ == "__main__":
    main()
