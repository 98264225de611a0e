#!/usr/bin/env python
"""Benchmark: classic+nl-fast on RubberWhale (584x388) on the GPU.

Prints exactly one JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

The baseline is the NumPy reference's wall-clock for the same computation
on this machine's CPU (measured once; see REF_SECONDS below), so
``vs_baseline`` is the per-chip speedup factor.  Accuracy (AAE / AEPE vs
Middlebury ground truth) is reported alongside to show the speed is not
bought with accuracy loss (reference: AAE 2.458, AEPE 0.080).
"""
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

import numpy as np  # noqa: E402

# Reference (jordanshivers/optical-flow-python) classic+nl-fast on
# RubberWhale, measured on this machine's CPU: see .ref_baseline_timing.txt
REF_SECONDS = 270.8  # measured on this machine, see .ref_baseline_timing.txt
REF_AAE = 2.463  # reference run on this machine (README.md:289 says 2.463)
REF_AEPE = 0.080


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax

    from optical_flow_tpu.evaluation.metrics import flow_angular_error
    from optical_flow_tpu.interface import estimate_flow
    from optical_flow_tpu.io.flo import read_flow_file
    from optical_flow_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"no GPU: JAX found {dev.platform} devices")
        sys.exit(1)

    ref_seconds = REF_SECONDS
    timing_file = os.path.join(REPO, ".ref_baseline_timing.txt")
    if os.path.exists(timing_file):
        for line in open(timing_file):
            if line.startswith("REF_SECONDS"):
                ref_seconds = float(line.split()[1])

    log("devices:", jax.devices())
    im1, im2, tu, tv = read_flow_file("RubberWhale", 10)
    # 'pcg' is the reference's own iterative solver mode (base.py:116-136,
    # rtol 1e-3 / maxiter 200); accuracy is identical to the tight-CG
    # 'backslash' mapping here (AAE 2.500 both) and ~9% faster.
    params = {"display": False, "solver": "pcg"}

    # warm-up: on the GPU the whole flow auto-fuses into ONE program (see
    # BaseOpticalFlow.fuse), so the first call pays a single compile.
    t0 = time.time()
    uv = np.asarray(estimate_flow(im1, im2, "classic+nl-fast", params))
    warm = time.time() - t0
    log(f"warmup total (incl. compile): {warm:.1f}s")

    # keep measuring until two runs agree within 20% or the budget runs out
    best = float("inf")
    times = []
    for i in range(8):
        t0 = time.time()
        uv = np.asarray(estimate_flow(im1, im2, "classic+nl-fast", params))
        dt = time.time() - t0
        times.append(dt)
        best = min(best, dt)
        log(f"run {i}: {dt:.2f}s")
        if i >= 2 and sorted(times)[1] <= 1.2 * best:
            break

    # run 0 far slower than the best run: surfaced for the reader
    worker_suspect = times[0] > 2.0 * best
    if worker_suspect:
        log(f"worker_suspect: run0 {times[0]:.2f}s > 2x best {best:.2f}s")

    # Sustained throughput: dispatch is async, so enqueueing T frames before
    # draining results overlaps the host-link cost (h2d + dispatch + d2h)
    # with device compute — the serving shape for video
    # (parallel/video.estimate_flow_stream).  Up to 3 trials, accept when
    # the best two agree within 15%, report the best.
    T = 15
    stream_trials = []
    uv = None
    for trial in range(3):
        t0 = time.time()
        outs = [estimate_flow(im1, im2, "classic+nl-fast", params) for _ in range(T)]
        flows = [np.asarray(o) for o in outs]
        fps = T / (time.time() - t0)
        stream_trials.append(fps)
        log(f"stream trial {trial}: {fps:.2f} frames/s ({T} frames)")
        uv = flows[-1]
        top2 = sorted(stream_trials, reverse=True)[:2]
        if len(top2) == 2 and top2[1] >= 0.85 * top2[0]:
            break
    stream_fps = max(stream_trials)
    log(f"streamed x{T}: {stream_fps:.2f} frames/s sustained (best of {len(stream_trials)})")

    aae, _, aepe = flow_angular_error(tu, tv, uv[:, :, 0], uv[:, :, 1])
    latency_fps = 1.0 / best
    ref_fps = 1.0 / ref_seconds

    print(
        json.dumps(
            {
                "metric": "classic+nl-fast frames/s per chip @584x388 RubberWhale (sustained stream; latency in extras)",
                "platform": dev.platform,
                "device_kind": dev.device_kind,
                "device_count": len(jax.devices()),
                "value": round(stream_fps, 4),
                "unit": "frames/s",
                "vs_baseline": round(stream_fps / ref_fps, 2),
                "seconds_per_frame_latency": round(best, 3),
                "latency_fps": round(latency_fps, 4),
                "latency_vs_baseline": round(latency_fps / ref_fps, 2),
                "aae_deg": round(float(aae), 3),
                "aepe_px": round(float(aepe), 4),
                "ref_seconds_per_frame": round(ref_seconds, 1),
                "ref_aae_deg": REF_AAE,
                "ref_aepe_px": REF_AEPE,
                "worker_health": {
                    "warmup_s": round(warm, 1),
                    "run0_s": round(times[0], 3),
                    "run0_over_best": round(times[0] / best, 2),
                    "worker_suspect": worker_suspect,
                    "stream_trials_fps": [round(f, 3) for f in stream_trials],
                },
            }
        )
    )


if __name__ == "__main__":
    main()
