#!/usr/bin/env python
"""Author notebooks/middlebury_benchmark.ipynb (run nbclient to execute).

The reference listed a middlebury_benchmark.ipynb that was stripped from its
snapshot (.MISSING_LARGE_BLOBS); this reconstructs the equivalent artifact on
top of this framework: the full 8-sequence Middlebury 'other' benchmark
with accuracy, per-frame wall time, and color-coded flow visualizations.
"""
import nbformat as nbf

nb = nbf.v4.new_notebook()
nb.metadata["kernelspec"] = {
    "display_name": "Python 3",
    "language": "python",
    "name": "python3",
}

md = nbf.v4.new_markdown_cell
code = nbf.v4.new_code_cell

nb.cells = [
    md(
        "# Middlebury benchmark — `optical_flow_tpu`\n"
        "\n"
        "The full Middlebury *other* benchmark (all 8 sequences with public\n"
        "ground truth) for this framework: accuracy (AAE / STD /\n"
        "AEPE), per-frame wall time on the device it runs on, and\n"
        "color-coded flow fields next to ground truth.\n"
        "\n"
        "The reference implementation listed a `middlebury_benchmark.ipynb`\n"
        "that is stripped from its snapshot (`.MISSING_LARGE_BLOBS`); its\n"
        "README reports RubberWhale only (AAE 2.463°, `README.md:289`).\n"
        "This notebook is the complete table."
    ),
    code(
        "import sys, time\n"
        "sys.path.insert(0, '..')\n"
        "\n"
        "import numpy as np\n"
        "import jax\n"
        "\n"
        "from optical_flow_tpu import estimate_flow, flow_to_color\n"
        "from optical_flow_tpu.evaluation.metrics import flow_angular_error\n"
        "from optical_flow_tpu.io.loader import middlebury_loader\n"
        "\n"
        "print(jax.devices())"
    ),
    md(
        "## Run all 8 ground-truth sequences\n"
        "\n"
        "`middlebury_loader` decodes frames on background threads through the\n"
        "native C PNG decoder while the device computes.  `classic+nl-fast`\n"
        "runs as ONE fused device program per frame pair (preprocessing\n"
        "folded in, frames shipped uint8).  The first pair of each distinct\n"
        "frame shape pays the monolith compile; the timed second run shows\n"
        "the steady-state per-frame cost."
    ),
    code(
        "SEQUENCES = ['RubberWhale', 'Hydrangea', 'Grove2', 'Grove3',\n"
        "             'Urban2', 'Urban3', 'Dimetrodon', 'Venus']\n"
        "METHOD = 'classic+nl-fast'\n"
        "PARAMS = {'display': False, 'solver': 'pcg'}\n"
        "\n"
        "results, flows, images, gts = {}, {}, {}, {}\n"
        "for seq, (im1, im2, tu, tv) in zip(SEQUENCES, middlebury_loader(SEQUENCES)):\n"
        "    uv = np.asarray(estimate_flow(im1, im2, METHOD, PARAMS))  # compile + warm\n"
        "    t0 = time.time()\n"
        "    uv = np.asarray(estimate_flow(im1, im2, METHOD, PARAMS))\n"
        "    dt = time.time() - t0\n"
        "    aae, stdae, aepe = flow_angular_error(tu, tv, uv[:, :, 0], uv[:, :, 1])\n"
        "    results[seq] = (aae, stdae, aepe, dt)\n"
        "    flows[seq], images[seq], gts[seq] = uv, im1, np.stack([tu, tv], -1)\n"
        "    print(f'{seq:12s}  AAE {aae:6.3f}  STD {stdae:6.3f}  AEPE {aepe:6.4f}  {dt:5.2f} s/frame')"
    ),
    code(
        "mean_aae = np.mean([r[0] for r in results.values()])\n"
        "mean_aepe = np.mean([r[2] for r in results.values()])\n"
        "mean_t = np.mean([r[3] for r in results.values()])\n"
        "print(f'mean over 8 sequences:  AAE {mean_aae:.3f}   AEPE {mean_aepe:.4f}   {mean_t:.2f} s/frame')\n"
        "print('reference (NumPy, RubberWhale only): AAE 2.463')"
    ),
    md(
        "## Flow fields vs ground truth\n"
        "\n"
        "Middlebury color coding (`flow_to_color`), estimated flow on the\n"
        "left, ground truth on the right (unknown GT pixels are black)."
    ),
    code(
        "import matplotlib.pyplot as plt\n"
        "\n"
        "fig, axes = plt.subplots(len(SEQUENCES), 3, figsize=(10.5, 3.1 * len(SEQUENCES)))\n"
        "for row, seq in enumerate(SEQUENCES):\n"
        "    aae, _, aepe, _ = results[seq]\n"
        "    ax = axes[row]\n"
        "    ax[0].imshow(np.asarray(images[seq]).astype(np.uint8))\n"
        "    ax[0].set_ylabel(seq, fontsize=10)\n"
        "    ax[1].imshow(flow_to_color(flows[seq]))\n"
        "    ax[1].set_title(f'estimated  (AAE {aae:.2f}°, AEPE {aepe:.3f})', fontsize=9)\n"
        "    ax[2].imshow(flow_to_color(gts[seq]))\n"
        "    ax[2].set_title('ground truth', fontsize=9)\n"
        "    for a in ax:\n"
        "        a.set_xticks([]); a.set_yticks([])\n"
        "plt.tight_layout()\n"
        "plt.show()"
    ),
    md(
        "The scripted harness for the same table is `benchmarks/middlebury.py`.\n"
        "Grove3/Urban3\n"
        "carry the largest errors for every implementation of this pipeline —\n"
        "large motions with occlusions at foliage/building boundaries."
    ),
]

nbf.write(nb, "middlebury_benchmark.ipynb")
print("wrote middlebury_benchmark.ipynb")
