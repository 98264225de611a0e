"""Multi-host (2-process) dryrun of the DP and SP paths across processes.

BASELINE.md's multi-host clause (≥80% scaling efficiency at N≥2 hosts) had
zero executed evidence through round 2: real multi-host hardware is
unavailable here, and the DP claim rested on the (sound) structural
zero-communication argument.  This script executes the actual multi-host
runtime path on one machine: **two OS processes** × 4 virtual CPU devices
each, `jax.distributed.initialize` against a localhost coordinator, XLA
cross-process collectives carrying

* **DP** — a batch-8 vmapped whole-flow HS program jit'd over a global
  (batch=8, space=1) mesh spanning both processes; each process computes
  only its 4 pairs (no collectives in the program — the structural claim,
  now executed end-to-end through the multi-process runtime), and
* **SP** — the sharded Classic+NL level step over a global
  (batch=1, space=8) mesh: the halo ``ppermute`` between global devices 3
  and 4 crosses the process boundary, as do all CG
  ``psum`` dot products.

Both paths are compared against locally-computed unsharded references and
the max abs diffs are printed as the last line (one JSON object).

Run:  python benchmarks/multihost.py                    # spawns 2 workers
      python benchmarks/multihost.py --worker I N PORT  # internal
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_OUT = os.path.join(tempfile.gettempdir(), "oftpu_multihost_worker0.json")


def worker(pid: int, nproc: int, port: int) -> None:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}", num_processes=nproc, process_id=pid
    )
    import numpy as np
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    sys.path.insert(0, REPO)
    from optical_flow_tpu.config import load_of_method
    from optical_flow_tpu.parallel.mesh import BATCH_AXIS, SPACE_AXIS, flow_mesh

    devs = jax.devices()
    res = {
        "processes": nproc,
        "local_devices_per_process": jax.local_device_count(),
        "global_devices": len(devs),
    }

    def make_global(sharding, arr):
        return jax.make_array_from_callback(arr.shape, sharding, lambda idx: arr[idx])

    def timed_best(fn, trials: int = 3):
        """best-of-N wall times, ALL trials recorded.

        Single-shot walls on this fabric swing >2x with machine load (a
        concurrent test suite measurably inverted a gear-vs-classic
        ordering once, and r4's committed dp/sp steadies were 18-35x
        contention-corrupted) — the MIN is the contention-free estimate,
        and the full list is kept so a reviewer can see the variance the
        min was taken over.
        """
        walls = []
        for _ in range(trials):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            walls.append(round(time.perf_counter() - t0, 4))
        return min(walls), walls

    # ------------------------------------------------------------------
    # DP: batch-8 whole-flow HS, batch axis spanning both processes
    # ------------------------------------------------------------------
    from optical_flow_tpu.methods.hs import hs_flow_program

    ope = load_of_method("hs-brightness")
    ope.display = False
    H, W = 48, 64
    plan = ope._make_plan((H, W))
    rng = np.random.default_rng(0)
    B = len(devs)
    # SMOOTH frames, deliberately: on raw uniform noise the HS tight-CG
    # solves truncate at maxiter without converging, and a truncated Krylov
    # iterate is chaotically sensitive to float reduction order — ANY two
    # lowerings (vmapped vs single, sharded vs unsharded, pre/post r4
    # channel-split) then disagree by 0.2-0.5 px at some pixel (measured
    # r4; the pre-r4 solver showed the same 0.35 on CPU).  On smooth
    # frames the solves converge, making the result path-independent to
    # ~2e-5 — which is what this check is for: multi-process sharding
    # correctness, not truncated-CG chaos.
    from scipy.ndimage import gaussian_filter

    base = np.stack(
        [gaussian_filter(rng.uniform(0, 255, (H, W)), 2.0) for _ in range(B)]
    ).astype(np.float32)
    images = np.stack([base, np.roll(base, 1, axis=2)], axis=3)
    uv0 = np.zeros((B, H, W, 2), np.float32)

    mesh_dp = flow_mesh(batch=B, space=1, devices=devs)
    sh_dp = NamedSharding(mesh_dp, P(BATCH_AXIS))
    g_images = make_global(sh_dp, images)
    g_uv0 = make_global(sh_dp, uv0)

    step = jax.jit(
        jax.vmap(lambda im, uv: hs_flow_program(plan, im, uv)),
        in_shardings=(sh_dp, sh_dp),
        out_shardings=sh_dp,
    )
    t0 = time.perf_counter()
    out = jax.block_until_ready(step(g_images, g_uv0))
    res["dp_first_call_s"] = round(time.perf_counter() - t0, 3)
    res["dp_steady_s"], res["dp_steady_trials_s"] = timed_best(
        lambda: step(g_images, g_uv0)
    )
    out = jax.block_until_ready(step(g_images, g_uv0))
    out_g = np.asarray(multihost_utils.process_allgather(out, tiled=True))

    ref_fn = jax.jit(lambda im, uv: hs_flow_program(plan, im, uv))
    ref = np.stack([np.asarray(ref_fn(images[i], uv0[i])) for i in range(B)])
    res["dp_max_abs_diff_vs_unsharded"] = float(np.abs(out_g - ref).max())
    res["dp_mean_u_interior"] = float(out_g[:, 8:-8, 8:-8, 0].mean())

    # ------------------------------------------------------------------
    # SP: sharded Classic+NL level step, rows spanning both processes
    # ------------------------------------------------------------------
    from scipy.ndimage import gaussian_filter

    from optical_flow_tpu.methods.classic_nl import classic_nl_level_step
    from optical_flow_tpu.parallel.spatial import classic_nl_level_step_spatial

    ope2 = load_of_method("classic+nl-fast")
    ope2.display = False
    ope2.max_iters = 2
    cfg = ope2._nl_cfg(use_color=True, max_linear=1)

    H2, W2 = 64, 48

    def smooth(seed, shape, scale=255.0):
        r = np.random.default_rng(seed)
        x = gaussian_filter(r.uniform(0, 1, shape), 1.5, mode="reflect")
        return (scale * (x - x.min()) / max(np.ptp(x), 1e-9)).astype(np.float32)

    im1 = smooth(1, (H2, W2))
    im2 = np.roll(im1, 1, axis=1)
    images2 = np.stack([im1, im2], -1)
    color2 = np.stack([smooth(s, (H2, W2)) for s in (2, 3, 4)], -1)
    uv2 = np.zeros((H2, W2, 2), np.float32)

    mesh_sp = flow_mesh(batch=1, space=len(devs), devices=devs)
    sh_sp = NamedSharding(mesh_sp, P(SPACE_AXIS))
    g_images2 = make_global(sh_sp, images2)
    g_color2 = make_global(sh_sp, color2)
    g_uv2 = make_global(sh_sp, uv2)

    def level_sharded():
        return classic_nl_level_step_spatial(
            cfg, g_images2, g_color2, g_uv2, jnp.float32(0.5), mesh_sp, halo=6
        )

    t0 = time.perf_counter()
    out2 = jax.block_until_ready(level_sharded())
    res["sp_first_call_s"] = round(time.perf_counter() - t0, 3)
    res["sp_steady_s"], res["sp_steady_trials_s"] = timed_best(level_sharded)
    out2 = jax.block_until_ready(level_sharded())
    out2_g = np.asarray(multihost_utils.process_allgather(out2, tiled=True))
    ref2 = np.asarray(
        classic_nl_level_step(cfg, images2, color2, uv2, jnp.float32(0.5))
    )
    res["sp_max_abs_diff_vs_unsharded"] = float(np.abs(out2_g - ref2).max())

    # ------------------------------------------------------------------
    # Gear A/B on the PRODUCTION sharded level step (not just the bare
    # solver): the level program wraps the CG in warping + wmedian +
    # occlusion, so this measures what the collective saving is worth
    # where it actually runs.  CG_ALGO is trace-time state and part of the
    # spatial jit cache key, so flipping it compiles a distinct program.
    # ------------------------------------------------------------------
    from optical_flow_tpu.solvers import cg as cg_mod

    prior_algo = cg_mod.CG_ALGO
    if prior_algo != "classic":
        # the SP rows above are only a valid classic baseline when the env
        # knob was classic — re-measure under an explicit pin otherwise
        cg_mod.CG_ALGO = "classic"
        jax.block_until_ready(level_sharded())  # compile classic program
        res["sp_steady_s"], res["sp_steady_trials_s"] = timed_best(level_sharded)
    res["level_classic_s"] = res["sp_steady_s"]
    res["level_classic_trials_s"] = res["sp_steady_trials_s"]
    cg_mod.CG_ALGO = "gear"
    try:
        out2g = jax.block_until_ready(level_sharded())  # compile
        res["level_gear_s"], res["level_gear_trials_s"] = timed_best(level_sharded)
        out2g_g = np.asarray(multihost_utils.process_allgather(out2g, tiled=True))
    finally:
        cg_mod.CG_ALGO = prior_algo
    res["level_gear_vs_classic_max_diff"] = float(np.abs(out2g_g - out2_g).max())
    res["level_gear_speedup"] = round(
        res["level_classic_s"] / max(res["level_gear_s"], 1e-9), 2
    )

    # ------------------------------------------------------------------
    # Distributed CG: classic (3 psum rounds/iter) vs gear (1 stacked psum)
    # — over this 2-process mesh every collective crosses the process
    # boundary, so the per-iteration collective count is measured WALL,
    # not just the HLO all-reduce count test_parallel.py pins.
    # ------------------------------------------------------------------
    from optical_flow_tpu.ops.derivatives import partial_deriv
    from optical_flow_tpu.ops.stencil import build_irls_system
    from optical_flow_tpu.parallel.dist import solve_flow_system_sharded
    from optical_flow_tpu.robust.robust_function import Robust

    cg_im = np.stack([smooth(7, (H2, W2)), smooth(8, (H2, W2))], 2)
    cg_uv = 0.2 * np.stack([smooth(9, (H2, W2), 1.0), smooth(10, (H2, W2), 1.0)], -1)
    It, Ix, Iy = partial_deriv(cg_im, cg_uv, "cubic")
    rho = Robust("charbonnier", (0.1,))
    cg_sys = build_irls_system(
        cg_uv, np.zeros_like(cg_uv), np.asarray(It), np.asarray(Ix),
        np.asarray(Iy), (rho, rho), (rho, rho), rho, 2.5,
    )
    cg_sys = type(cg_sys)(*[make_global(sh_sp, np.asarray(f)) for f in cg_sys])
    cg_out = {}
    # cheby gets a deeper maxiter: the minimax polynomial needs ~1.7x the
    # iterations but pays 1 psum per 16-iter
    # block vs classic's 3/iter and gear's 1/iter — the fabric-latency
    # trade this A/B exists to measure
    for algo in ("classic", "gear", "cheby"):
        fn = jax.jit(
            lambda s, a=algo: solve_flow_system_sharded(
                s, mesh_sp, rtol=1e-6, maxiter=400 if a != "cheby" else 1200, algo=a
            )
        )
        x = jax.block_until_ready(fn(cg_sys))  # compile
        res[f"cg_{algo}_steady_s"], res[f"cg_{algo}_trials_s"] = timed_best(
            lambda: fn(cg_sys)
        )
        x = jax.block_until_ready(fn(cg_sys))
        cg_out[algo] = np.asarray(multihost_utils.process_allgather(x, tiled=True))
    res["cg_gear_vs_classic_max_diff"] = float(
        np.abs(cg_out["gear"] - cg_out["classic"]).max()
    )
    res["cg_gear_speedup"] = round(
        res["cg_classic_steady_s"] / max(res["cg_gear_steady_s"], 1e-9), 2
    )
    # cheby converges to the same rtol but along a different polynomial —
    # the solutions agree to solver tolerance, not recurrence rounding
    res["cg_cheby_vs_classic_max_diff"] = float(
        np.abs(cg_out["cheby"] - cg_out["classic"]).max()
    )
    res["cg_cheby_speedup"] = round(
        res["cg_classic_steady_s"] / max(res["cg_cheby_steady_s"], 1e-9), 2
    )

    res["ok"] = (
        res["dp_max_abs_diff_vs_unsharded"] < 1e-4
        and res["sp_max_abs_diff_vs_unsharded"] < 1e-4
        and res["cg_gear_vs_classic_max_diff"] < 1e-4
        and res["cg_cheby_vs_classic_max_diff"] < 1e-2  # solver-tolerance scale
        and res["level_gear_vs_classic_max_diff"] < 1e-4
    )
    if pid == 0:
        with open(WORKER_OUT, "w") as f:
            json.dump(res, f, indent=1)
    multihost_utils.sync_global_devices("done")


def launch() -> int:
    with socket.socket() as s:  # pick a free coordinator port
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    if os.path.exists(WORKER_OUT):
        os.remove(WORKER_OUT)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)  # the worker forces cpu itself
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", str(i), "2", str(port)],
            env=env,
        )
        for i in range(2)
    ]
    rcs = [p.wait(timeout=1200) for p in procs]
    result = {"launcher_rcs": rcs}
    if all(rc == 0 for rc in rcs) and os.path.exists(WORKER_OUT):
        with open(WORKER_OUT) as f:
            result.update(json.load(f))
    else:
        result["ok"] = False
        result["error"] = "worker process failed; see stderr above"
    print(json.dumps(result))
    return 0 if result.get("ok") else 1


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
    else:
        sys.exit(launch())
