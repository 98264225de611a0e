#!/usr/bin/env python
"""Scaling-efficiency harness: batch-DP throughput curve on one GPU.

Measures classic+nl-fast frames/s per chip at batch sizes B = 1..8 on the
RubberWhale pair (584x388, full color-guided path — the same computation as
bench.py, vmapped: raw frames in, flows out, preprocessing inside the
timed program).  Efficiency is throughput(B) / throughput(1): batching
amortizes per-dispatch and host-link costs, so efficiency can exceed 1.

Multi-device correctness is covered on the 8-virtual-device CPU mesh
(tests/test_spatial.py, tests/test_parallel.py) and on four GPUs by
``chip_smoke.py --chips 4``.

Emits one JSON line per configuration to stdout.
"""
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    from optical_flow_tpu.evaluation.metrics import flow_angular_error
    from optical_flow_tpu.io.flo import read_flow_file
    from optical_flow_tpu.parallel.batch import estimate_flow_batched_rgb
    from optical_flow_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    log("devices:", jax.devices())
    im1, im2, tu, tv = read_flow_file("RubberWhale", 10)
    # argv[2]: 'fused' (default; one vmapped whole-flow program per batch)
    # or 'per-level' (fuse=False batched level programs)
    mode = sys.argv[2] if len(sys.argv) > 2 else "fused"
    params = {"display": False, "solver": "pcg", "fuse": mode != "per-level"}

    sizes = [int(s) for s in (sys.argv[1].split(",") if len(sys.argv) > 1 else ["1", "2", "4", "8"])]
    results = {}
    f16_rows = {}
    health = {}
    # the serving shape: raw (uint8-exact) frames in -> flows out; the
    # rgb2gray/rgb2lab preprocessing is INSIDE the timed program
    for B in sizes:
        im1_b = np.ascontiguousarray(np.broadcast_to(im1, (B, *im1.shape)))
        im2_b = np.ascontiguousarray(np.broadcast_to(im2, (B, *im2.shape)))

        t0 = time.time()
        uv = np.asarray(
            estimate_flow_batched_rgb(im1_b, im2_b, "classic+nl-fast", params=params)
        )
        warmup = time.time() - t0
        log(f"B={B}: warmup (incl. compile) {warmup:.1f}s")

        trials = []
        for i in range(3):
            t0 = time.time()
            uv = np.asarray(
                estimate_flow_batched_rgb(im1_b, im2_b, "classic+nl-fast", params=params)
            )
            dt = time.time() - t0
            trials.append(dt)
            log(f"B={B} run {i}: {dt:.2f}s  ({B / dt:.3f} frames/s)")
        best = min(trials)
        aae, _, aepe = flow_angular_error(tu, tv, uv[0, :, :, 0], uv[0, :, :, 1])
        results[B] = (B / best, float(aae), float(aepe))
        health[B] = {
            "warmup_s": round(warmup, 1),
            "trials_s": [round(t, 3) for t in trials],
            "trial0_over_best": round(trials[0] / best, 2),
        }

        if B >= 8:
            # out_dtype='float16' halves the flow download (quantizes flow
            # at ~5e-4 px — far below the 0.08 px AEPE scale); emitted as
            # its own row.
            p16 = {**params, "out_dtype": "float16"}
            uv = np.asarray(
                estimate_flow_batched_rgb(im1_b, im2_b, "classic+nl-fast", params=p16)
            )
            trials16 = []
            for i in range(3):
                t0 = time.time()
                uv = np.asarray(
                    estimate_flow_batched_rgb(im1_b, im2_b, "classic+nl-fast", params=p16)
                )
                trials16.append(time.time() - t0)
                log(f"B={B}+f16 run {i}: {trials16[-1]:.2f}s  ({B / trials16[-1]:.3f} frames/s)")
            best16 = min(trials16)
            health[f"{B}+f16"] = {
                "trials_s": [round(t, 3) for t in trials16],
                "trial0_over_best": round(trials16[0] / best16, 2),
            }
            aae, _, aepe = flow_angular_error(
                tu, tv, uv[0, :, :, 0].astype(np.float64), uv[0, :, :, 1].astype(np.float64)
            )
            f16_rows[B] = (B / best16, float(aae), float(aepe))

    base_fps = results[sizes[0]][0] * sizes[0] if sizes[0] != 1 else results[1][0]
    for B in sizes:
        fps, aae, aepe = results[B]
        print(
            json.dumps(
                {
                    "metric": f"classic+nl-fast batched ({mode}) B={B} frames/s per chip @584x388",
                    "value": round(fps, 4),
                    "unit": "frames/s",
                    "vs_baseline": round(fps / (1.0 / 270.8), 2),
                    "batch": B,
                    "batch_amortization_vs_B1": round(fps / base_fps, 3),
                    "aae_deg": round(aae, 3),
                    "aepe_px": round(aepe, 4),
                }
            ),
            flush=True,
        )
    for B, (fps, aae, aepe) in f16_rows.items():
        print(
            json.dumps(
                {
                    "metric": f"classic+nl-fast batched ({mode}) B={B}+f16-download frames/s per chip @584x388",
                    "value": round(fps, 4),
                    "unit": "frames/s",
                    "vs_baseline": round(fps / (1.0 / 270.8), 2),
                    "batch": B,
                    "out_dtype": "float16",
                    "batch_amortization_vs_B1": round(fps / base_fps, 3),
                    "aae_deg": round(aae, 3),
                    "aepe_px": round(aepe, 4),
                }
            ),
            flush=True,
        )
    # per-B trial lists and trial0/best ratios
    print(
        json.dumps(
            {
                "worker_health": health,
                "worker_suspect": any(
                    h["trial0_over_best"] > 2.0 for h in health.values()
                ),
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
