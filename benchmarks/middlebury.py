#!/usr/bin/env python
"""Full Middlebury 'other' benchmark: all 8 GT sequences.

Reproduces the reference's stripped ``middlebury_benchmark.ipynb``: runs a
method over every sequence with ground truth and reports AAE / AEPE plus
per-frame wall time.

Usage:
    python benchmarks/middlebury.py [method] [--json out.json]
"""
import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

SEQUENCES = [
    "RubberWhale",
    "Hydrangea",
    "Grove2",
    "Grove3",
    "Urban2",
    "Urban3",
    "Dimetrodon",
    "Venus",
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("method", nargs="?", default="classic+nl-fast")
    ap.add_argument("--json", default=None)
    ap.add_argument("--sequences", nargs="*", default=SEQUENCES)
    args = ap.parse_args()

    from optical_flow_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from optical_flow_tpu.evaluation.metrics import flow_angular_error
    from optical_flow_tpu.interface import estimate_flow
    from optical_flow_tpu.io.flo import read_flow_file

    results = {}
    params = {"display": False}
    print(f"{'sequence':<14} {'AAE':>7} {'AEPE':>7} {'sec':>7} {'warmup':>8}")
    for seq in args.sequences:
        im1, im2, tu, tv = read_flow_file(seq, 10)
        if tu is None:
            continue
        # first call pays the (shape-keyed) compile; report it separately
        # from the steady-state per-frame time so neither number is polluted.
        t0 = time.time()
        uv = np.asarray(estimate_flow(im1, im2, args.method, params))
        warmup = time.time() - t0
        # steady: up to 3 trials, accept when the best two agree within
        # 20%, report best
        trials = []
        for _ in range(3):
            t0 = time.time()
            uv = np.asarray(estimate_flow(im1, im2, args.method, params))
            trials.append(time.time() - t0)
            top2 = sorted(trials)[:2]
            if len(top2) == 2 and top2[1] <= 1.2 * top2[0]:
                break
        dt = min(trials)
        aae, _, aepe = flow_angular_error(tu, tv, uv[:, :, 0], uv[:, :, 1])
        results[seq] = {
            "aae": round(float(aae), 3),
            "aepe": round(float(aepe), 4),
            "sec": round(dt, 2),
            "sec_trials": [round(t, 2) for t in trials],
            "warmup_sec": round(warmup, 2),
        }
        print(f"{seq:<14} {aae:7.3f} {aepe:7.4f} {dt:7.2f} {warmup:8.2f}")

    avg_aae = float(np.mean([r["aae"] for r in results.values()]))
    avg_aepe = float(np.mean([r["aepe"] for r in results.values()]))
    print(f"{'MEAN':<14} {avg_aae:7.3f} {avg_aepe:7.4f}")
    results["_mean"] = {"aae": round(avg_aae, 3), "aepe": round(avg_aepe, 4)}
    results["_method"] = args.method
    # Canonical-run provenance.  NOTE the solver: this harness runs the
    # preset DEFAULT ('backslash' -> tight-CG rtol 1e-7, matching the
    # reference's default spsolve choice); the executed
    # middlebury_benchmark.ipynb pins solver='pcg' (rtol 1e-3, what
    # bench.py times) — that one-knob difference is the whole Urban3
    # 3.063-vs-2.936 spread between artifacts (r4 reconciliation; both
    # inside the oracle gates).  THIS file is the canonical accuracy table.
    results["_provenance"] = {
        "params": "preset defaults + display=False (solver='backslash' tight-CG)",
        "notebook_delta": "middlebury_benchmark.ipynb uses solver='pcg'",
        "deterministic": "re-runs reproduce AAE/AEPE to the rounded digits",
    }
    gate_fail = check_ref_oracle_gates(results, args.method)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
    if gate_fail:
        sys.exit(1)


# Per-sequence accuracy-parity gates vs the measured reference oracle
# (produced by benchmarks/ref_oracle.py running the NumPy reference itself on
# every GT sequence; flagship artifact results_ref_oracle.json, other
# families results_ref_oracle_methods.json).  Gates absorb solver drift
# (reference 'backslash' spsolve vs this repo's matrix-free CG) — the
# reference's own NumPy-vs-MATLAB delta is 0.06 deg AAE on RubberWhale —
# and sit just above each method's largest measured repo delta:
#   classic+nl-fast: Urban3 +0.090 deg / +0.0066 px
#   classic++:       Grove3 -0.046 deg / Urban3 -0.0122 px (repo better)
#   classic+nl:      same order as classic++
#   hs:              Urban2 +0.033 deg / +0.034 px — quadratic HS on 22-px
#                    motion is fixed-point-sensitive (8x tighter CG moves
#                    AEPE by 1e-4; see docs/PARITY.md), hence the looser
#                    AEPE gate for (hs, Urban2) ONLY: the other 7 hs
#                    sequences measure <= 0.0015 px and get the flagship's
#                    0.01 px gate (a real 0.03 px hs regression on
#                    RubberWhale must FAIL, not hide under Urban2's excuse).
GATES = {
    "classic+nl-fast": (0.2, 0.01),
    "classic+nl": (0.2, 0.02),
    "classic++": (0.2, 0.02),
    "ba": (0.2, 0.02),
    "hs": (0.2, 0.01),
}
# (method, sequence) overrides — tight everywhere, documented exceptions only
SEQ_GATES = {
    ("hs", "Urban2"): (0.2, 0.05),
}


def load_ref_oracle(method):
    """Per-sequence AAE/AEPE of the NumPy reference for ``method`` (None if
    the oracle has no entry for it)."""
    flagship = os.path.join(REPO, "benchmarks", "results_ref_oracle.json")
    methods = os.path.join(REPO, "benchmarks", "results_ref_oracle_methods.json")
    if method == "classic+nl-fast":
        with open(flagship) as f:
            return json.load(f)
    with open(methods) as f:
        return json.load(f).get(method)


def check_ref_oracle_gates(results, method):
    """True when any sequence of ``results`` is outside its gate."""
    oracle = load_ref_oracle(method)
    if oracle is None or method not in GATES:
        return False
    fail = False
    print(f"\nvs reference oracle (gates for {method}: base {GATES[method]},"
          f" per-sequence overrides {[k for k in SEQ_GATES if k[0] == method]})")
    print(f"{'sequence':<14} {'dAAE':>8} {'dAEPE':>8}")
    for seq, r in results.items():
        if seq.startswith("_") or seq not in oracle:
            continue
        aae_gate, aepe_gate = SEQ_GATES.get((method, seq), GATES[method])
        d_aae = r["aae"] - oracle[seq]["aae"]
        d_aepe = r["aepe"] - oracle[seq]["aepe"]
        bad = abs(d_aae) > aae_gate or abs(d_aepe) > aepe_gate
        fail |= bad
        print(f"{seq:<14} {d_aae:+8.3f} {d_aepe:+8.4f}{'  GATE FAIL' if bad else ''}")
    return fail


if __name__ == "__main__":
    main()
