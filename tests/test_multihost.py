"""Multi-host (2-process) runtime path — executes benchmarks/multihost.py.

Two OS processes x 4 virtual CPU devices, jax.distributed against a
localhost coordinator: the DP batch mesh and the sharded-SP level step
(halo ppermute + CG psum crossing the process boundary over Gloo) must
reproduce the unsharded programs.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_multihost_two_process_dryrun(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmarks", "multihost.py")],
        env=env,
        capture_output=True,
        text=True,
        timeout=1500,
        cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["ok"] is True
    assert res["global_devices"] == 8 and res["processes"] == 2
    # The r3 exact-0.0 DP equality was a lowering coincidence, not a
    # guarantee: the vmapped+sharded and per-element programs reassociate
    # float reductions, and convergent CG makes the result path-independent
    # only to ~solver precision (multihost.py now uses SMOOTH frames so the
    # solves actually converge — on noise they truncate at maxiter and the
    # paths diverge by ~0.4 px; see the comment there).  Measured 2.5e-5.
    assert res["dp_max_abs_diff_vs_unsharded"] < 1e-4
    assert res["sp_max_abs_diff_vs_unsharded"] < 1e-4
    assert abs(res["dp_mean_u_interior"] - 1.0) < 0.05
