#!/usr/bin/env python
"""Author notebooks/optical_flow_demo_additional.ipynb (execute via nbconvert).

The reference listed an optical_flow_demo_additional.ipynb stripped from its
snapshot (.MISSING_LARGE_BLOBS); this reconstructs the equivalent artifact:
the capability tour beyond the main demo — the method-family accuracy/speed
ladder, parameter overrides, all plot styles, sustained streaming, and the
failure guard (capabilities the reference does not have are marked as such).
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
        "# Additional demos — `optical_flow_tpu`\n"
        "\n"
        "Beyond the main demo notebook: the method-family ladder of Sun,\n"
        "Roth & Black, parameter overrides, every plot style,\n"
        "sustained video streaming, and failure recovery.  (The reference\n"
        "listed an `optical_flow_demo_additional.ipynb` stripped from its\n"
        "snapshot; this is this framework's equivalent.)"
    ),
    code(
        "import sys, time\n"
        "sys.path.insert(0, '..')\n"
        "\n"
        "import numpy as np\n"
        "import jax\n"
        "import matplotlib.pyplot as plt\n"
        "\n"
        "from optical_flow_tpu import estimate_flow, flow_to_color, plot_flow\n"
        "from optical_flow_tpu.evaluation.metrics import flow_angular_error\n"
        "from optical_flow_tpu.io import read_flow_file\n"
        "\n"
        "im1, im2, tu, tv = read_flow_file('RubberWhale', 10)\n"
        "print(jax.devices())"
    ),
    md(
        "## The method ladder\n"
        "\n"
        "Four rungs of the *Secrets* pipeline, each adding machinery: HS\n"
        "(quadratic), Classic-C (Charbonnier IRLS + GNC), Classic++\n"
        "(generalized Charbonnier + bicubic warp), Classic+NL-Fast (the\n"
        "non-local color-guided weighted median).  Each runs as ONE fused\n"
        "device program; the first call per method pays its compile."
    ),
    code(
        "LADDER = ['hs', 'classic-c', 'classic++', 'classic+nl-fast']\n"
        "flows, rows = {}, []\n"
        "for m in LADDER:\n"
        "    uv = np.asarray(estimate_flow(im1, im2, m, {'display': False}))  # compile+warm\n"
        "    t0 = time.time()\n"
        "    uv = np.asarray(estimate_flow(im1, im2, m, {'display': False}))\n"
        "    dt = time.time() - t0\n"
        "    aae, _, aepe = flow_angular_error(tu, tv, uv[:, :, 0], uv[:, :, 1])\n"
        "    flows[m] = uv\n"
        "    rows.append((m, aae, aepe, dt))\n"
        "    print(f'{m:17s} AAE {aae:6.3f}  AEPE {aepe:6.4f}  {dt:5.2f} s/frame')"
    ),
    code(
        "fig, axes = plt.subplots(1, len(LADDER), figsize=(4 * len(LADDER), 3.2))\n"
        "for ax, (m, aae, aepe, _) in zip(axes, rows):\n"
        "    ax.imshow(flow_to_color(flows[m]))\n"
        "    ax.set_title(f'{m}\\nAAE {aae:.2f}°  AEPE {aepe:.3f}', fontsize=9)\n"
        "    ax.set_xticks([]); ax.set_yticks([])\n"
        "plt.tight_layout(); plt.show()"
    ),
    md(
        "## Parameter overrides\n"
        "\n"
        "Overrides take a dict or a MATLAB-style `[key, value, ...]` list\n"
        "(with the `lambda` alias), exactly as the reference's\n"
        "`parse_input_parameter`.  Here: Horn–Schunck with a stiffer\n"
        "regularizer."
    ),
    code(
        "uv_soft = np.asarray(estimate_flow(im1, im2, 'hs', {'display': False}))\n"
        "uv_stiff = np.asarray(estimate_flow(im1, im2, 'hs', ['lambda', 200, 'lambda_q', 200, 'display', False]))\n"
        "fig, axes = plt.subplots(1, 2, figsize=(8, 3.2))\n"
        "for ax, (uv, t) in zip(axes, [(uv_soft, 'lambda = 40 (preset)'), (uv_stiff, 'lambda = 200')]):\n"
        "    ax.imshow(flow_to_color(uv)); ax.set_title(t, fontsize=10)\n"
        "    ax.set_xticks([]); ax.set_yticks([])\n"
        "plt.tight_layout(); plt.show()"
    ),
    md("## All four plot styles"),
    code(
        "uv = flows['classic+nl-fast']\n"
        "fig, axes = plt.subplots(1, 4, figsize=(16, 3.4))\n"
        "for ax, style in zip(axes, ['color', 'quiver', 'magnitude', 'hsv']):\n"
        "    plot_flow(uv, style=style, ax=ax)\n"
        "plt.tight_layout(); plt.show()"
    ),
    md(
        "## Sustained streaming\n"
        "\n"
        "`estimate_flow_stream` dispatches frame pairs without draining\n"
        "results in between, hiding the host↔device link behind device\n"
        "compute (the program is already compiled from the ladder cell)."
    ),
    code(
        "from optical_flow_tpu import estimate_flow_stream\n"
        "\n"
        "T = 8\n"
        "pairs = [(im1, im2)] * T\n"
        "t0 = time.time()\n"
        "outs = list(estimate_flow_stream(pairs, 'classic+nl-fast', {'display': False}))\n"
        "dt = (time.time() - t0) / T\n"
        "print(f'{1/dt:.2f} frames/s sustained ({dt*1e3:.0f} ms/frame)  vs single-frame latency above')"
    ),
    md(
        "## Failure detection + recovery\n"
        "\n"
        "The `classic-c-a` preset (coupled Alt-BA) legitimately diverges on\n"
        "real low-texture frames — the reference's own implementation\n"
        "reaches max|uv| ≈ 1e48 on this crop.  `guard_flow` detects a\n"
        "non-finite or out-of-range level result *inside the jitted program*\n"
        "and rolls back to the level's initialization, so the coarse-to-fine\n"
        "recursion continues from the last healthy estimate.  (The reference\n"
        "has no recovery path — it returns the garbage.)"
    ),
    code(
        "crop1, crop2 = im1[:160, :192], im2[:160, :192]\n"
        "uv_raw = np.asarray(estimate_flow(crop1, crop2, 'classic-c-a', {'display': False}))\n"
        "uv_guarded = np.asarray(estimate_flow(crop1, crop2, 'classic-c-a', {'display': False, 'guard_flow': 1e9}))\n"
        "print(f'unguarded: max|uv| = {np.abs(uv_raw).max():.3e}   (reference diverges identically)')\n"
        "print(f'guarded:   max|uv| = {np.abs(uv_guarded).max():.3e}   finite = {np.isfinite(uv_guarded).all()}')"
    ),
]

nbf.write(nb, "optical_flow_demo_additional.ipynb")
print("wrote optical_flow_demo_additional.ipynb")
