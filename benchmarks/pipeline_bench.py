#!/usr/bin/env python
"""Pipeline-parallel (PP across frames) overlap measurement.

Runs a frame stream through ``estimate_flow_pipelined`` with 1..N stage
groups on the virtual CPU mesh (compute-bound there, so wall-clock
overlap is real) and compares against the sequential per-level path.  The
speedup ceiling is min(n_stages, physical cores, 1/max-stage-share);
the partition is an exact minimal-max balance, but the finest pyramid
level alone is ~40-50% of a frame, so ~2x is the structural ceiling for
this workload — the point of PP is latency-bounded streaming and
per-device working sets, with DP (parallel/batch.py) the throughput
scale-out.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python benchmarks/pipeline_bench.py [n_frames]

Emits one JSON line per configuration.
"""
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")

    from optical_flow_tpu.interface import estimate_flow
    from optical_flow_tpu.io.flo import read_flow_file
    from optical_flow_tpu.parallel.pipeline import estimate_flow_pipelined

    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    im1, im2, _, _ = read_flow_file("RubberWhale", 10)
    # crop: CPU per-level compiles are minutes at full 584x388; the overlap
    # structure is shape-independent
    im1, im2 = im1[:192, :256], im2[:192, :256]
    frames = [(im1, im2)] * n_frames
    params = {"display": False, "fuse": False}
    method = "classic+nl-fast"

    results = []

    # sequential per-level baseline (same programs, one device)
    ref = np.asarray(estimate_flow(im1, im2, method, dict(params)))  # compile
    t0 = time.time()
    for a, b in frames:
        np.asarray(estimate_flow(a, b, method, dict(params)))
    seq = time.time() - t0
    results.append({"mode": "sequential per-level", "s_per_frame": seq / n_frames})

    for n_stages in (2, 4):
        devs = jax.devices()[:n_stages]
        # warm the per-device executables
        flows = [
            np.asarray(f)
            for f in estimate_flow_pipelined(
                frames[:1], method, dict(params), devices=devs
            )
        ]
        assert float(np.abs(flows[0] - ref).max()) < 1e-4
        t0 = time.time()
        out = list(
            estimate_flow_pipelined(frames, method, dict(params), devices=devs)
        )
        np.asarray(out[-1])
        dt = time.time() - t0
        results.append(
            {
                "mode": f"pipelined {n_stages} stages",
                "s_per_frame": dt / n_frames,
                "speedup_vs_sequential": seq / dt,
            }
        )

    for r in results:
        r["s_per_frame"] = round(r["s_per_frame"], 3)
        if "speedup_vs_sequential" in r:
            r["speedup_vs_sequential"] = round(r["speedup_vs_sequential"], 2)
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
