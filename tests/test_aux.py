"""Auxiliary subsystems: checkpoint/resume, profiling, batched pipeline glue."""
import os

import jax.numpy as jnp
import numpy as np

from optical_flow_tpu.config import load_of_method
from optical_flow_tpu.utils.checkpoint import FlowCheckpointer
from optical_flow_tpu.utils.profiling import StageTimer


def test_checkpointer_roundtrip(tmp_path, rng):
    ckpt = FlowCheckpointer(str(tmp_path))
    uv = rng.standard_normal((12, 14, 2)).astype(np.float32)
    ckpt.save(1, 3, uv)
    stage, level, back = ckpt.latest()
    assert (stage, level) == (1, 3)
    np.testing.assert_array_equal(back, uv)


def test_checkpoint_during_compute_flow(tmp_path, rng):
    im = rng.uniform(0, 255, (40, 44))
    im2 = np.roll(im, 1, axis=1)
    ope = load_of_method("hs-brightness")
    ope.median_filter_size = None  # no post-loop filtering after the last checkpoint
    ope.checkpoint = FlowCheckpointer(str(tmp_path))
    ope.images = jnp.stack([jnp.asarray(im), jnp.asarray(im2)], 2)
    uv = np.asarray(ope.compute_flow())
    stage, level, saved = ope.checkpoint.latest()
    assert level == 0  # finest level was checkpointed last
    np.testing.assert_allclose(saved, uv, atol=1e-5)


def test_warmup_precompiles_level_programs(rng):
    """warmup_classic_nl pre-compiles every program of a per-level run: a
    subsequent compute_flow (fuse=False path on CPU) reuses the jit caches
    and produces the normal result."""
    from optical_flow_tpu.utils.warmup import warmup_classic_nl

    H, W = 32, 36
    ope = load_of_method("classic+nl-fast")
    ope.display = False
    ope.color_images = None  # grayscale run: plain-median fallback
    warmup_classic_nl(ope, (H, W), color=False, max_workers=4)

    im = rng.uniform(0, 255, (H, W))
    ope.images = jnp.stack([jnp.asarray(im), jnp.asarray(np.roll(im, 1, axis=1))], 2)
    uv = np.asarray(ope.compute_flow())
    assert uv.shape == (H, W, 2)
    assert np.isfinite(uv).all()


def test_stage_timer():
    t = StageTimer()
    with t.stage("a"):
        sum(range(1000))
    with t.stage("a"):
        pass
    with t.stage("b"):
        pass
    totals = t.totals()
    assert set(totals) == {"a", "b"}
    assert "a" in t.report()


def test_compile_cache_dir_from_env(monkeypatch, tmp_path):
    """A set JAX_COMPILATION_CACHE_DIR is used as is, and left to JAX."""
    import jax

    from optical_flow_tpu.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert compile_cache.compile_cache_dir() == str(tmp_path)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_dir_default_in_checkout(monkeypatch):
    """Unset, the cache goes to the fixed <checkout>/.jax_cache, which
    .gitignore lists."""
    import jax

    from optical_flow_tpu.utils import compile_cache

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert compile_cache.compile_cache_dir() == want
    assert compile_cache.enable_compile_cache() == want
    assert calls == [("jax_compilation_cache_dir", want)]
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_ref_oracle_artifact_consistency():
    """The measured reference-oracle artifact (benchmarks/ref_oracle.py)
    must stay parseable and keep reproducing the independently-measured r2
    RubberWhale baseline (.ref_baseline_timing.txt: 2.46298/0.08025) — the
    sanity anchor that validates the whole 8-sequence oracle harness."""
    import json
    import os

    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "benchmarks",
        "results_ref_oracle.json",
    )
    with open(path) as f:
        oracle = json.load(f)
    rw = oracle["RubberWhale"]
    assert abs(rw["aae"] - 2.46298) < 1e-4
    assert abs(rw["aepe"] - 0.08025) < 1e-5
    seqs = {
        "RubberWhale", "Hydrangea", "Grove2", "Grove3",
        "Urban2", "Urban3", "Dimetrodon", "Venus",
    }
    assert seqs <= set(oracle)
    assert oracle["_provenance"]["method"] == "classic+nl-fast"


def test_ref_oracle_methods_artifact_consistency():
    """Per-method oracle artifact (hs / classic++ measured on all 8 GT
    sequences by running the reference) stays parseable and complete."""
    import json
    import os

    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "benchmarks",
        "results_ref_oracle_methods.json",
    )
    with open(path) as f:
        oracle = json.load(f)
    seqs = {
        "RubberWhale", "Hydrangea", "Grove2", "Grove3",
        "Urban2", "Urban3", "Dimetrodon", "Venus",
    }
    for method in ("hs", "classic++"):
        assert seqs <= set(oracle[method])
        assert oracle[method]["_mean"]["aae"] > 0


def _middlebury_module():
    import importlib.util

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "mb", os.path.join(repo, "benchmarks", "middlebury.py")
    )
    mb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mb)
    return mb


def test_oracle_gates_pass_within_tolerance():
    """Results inside GATES of the measured reference oracle pass."""
    mb = _middlebury_module()
    # per-sequence override table stays minimal: one documented exception
    assert set(mb.SEQ_GATES) == {("hs", "Urban2")}
    oracle = mb.load_ref_oracle("classic+nl-fast")
    aae_gate, aepe_gate = mb.GATES["classic+nl-fast"]
    results = {
        seq: {"aae": r["aae"] + 0.5 * aae_gate, "aepe": r["aepe"] - 0.5 * aepe_gate}
        for seq, r in oracle.items() if not seq.startswith("_")
    }
    assert not mb.check_ref_oracle_gates(results, "classic+nl-fast")


def test_oracle_gates_fail_outside_tolerance():
    """One sequence past its AEPE gate fails the whole table."""
    mb = _middlebury_module()
    oracle = mb.load_ref_oracle("hs")
    results = {
        seq: {"aae": r["aae"], "aepe": r["aepe"]}
        for seq, r in oracle.items() if not seq.startswith("_")
    }
    assert not mb.check_ref_oracle_gates(results, "hs")
    results["RubberWhale"]["aepe"] += 2 * mb.GATES["hs"][1]
    assert mb.check_ref_oracle_gates(results, "hs")
