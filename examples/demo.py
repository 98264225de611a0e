#!/usr/bin/env python
"""Demo: estimate optical flow on a Middlebury pair and visualize it.

The equivalent of the reference's ``optical_flow_demo.ipynb``:

    python examples/demo.py [sequence] [method] [--out out.png]

Produces the estimated flow, evaluates against ground truth when
available, and saves the Middlebury color-coded visualization.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("sequence", nargs="?", default="RubberWhale")
    ap.add_argument("method", nargs="?", default="classic+nl-fast")
    ap.add_argument("--out", default="flow_demo.png")
    ap.add_argument("--flo", default=None, help="optional .flo output path")
    args = ap.parse_args()

    from optical_flow_tpu import estimate_flow, flow_angular_error, write_flo
    from optical_flow_tpu.io.flo import read_flow_file
    from optical_flow_tpu.viz.plot_flow import plot_flow
    import matplotlib.pyplot as plt

    im1, im2, tu, tv = read_flow_file(args.sequence, 10)
    print(f"{args.sequence}: {im1.shape[1]}x{im1.shape[0]}, method={args.method}")

    t0 = time.time()
    uv = np.asarray(estimate_flow(im1, im2, args.method, {"display": False}))
    print(f"estimated in {time.time() - t0:.2f}s (includes compile on first run)")

    if tu is not None:
        aae, stdae, aepe = flow_angular_error(tu, tv, uv[:, :, 0], uv[:, :, 1])
        print(f"AAE {aae:.3f}  STD {stdae:.3f}  AEPE {aepe:.4f}")

    fig, axes = plt.subplots(1, 2, figsize=(14, 5))
    axes[0].imshow(im1.astype(np.uint8) if im1.max() > 1 else im1)
    axes[0].set_title("frame 10")
    axes[0].axis("off")
    plot_flow(uv, style="color", ax=axes[1])
    fig.tight_layout()
    fig.savefig(args.out, dpi=120)
    print(f"saved {args.out}")

    if args.flo:
        write_flo(uv, args.flo)
        print(f"saved {args.flo}")


if __name__ == "__main__":
    main()
