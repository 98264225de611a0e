"""Implementation choices made from platform, dtype and mesh alone."""
import jax
import jax.numpy as jnp
import pytest

from optical_flow_tpu.config import load_of_method
from optical_flow_tpu.ops import wmedian


@pytest.mark.parametrize(
    "backend,mesh,fuse,expected",
    [
        ("gpu", None, None, True),
        ("cpu", None, None, False),
        ("gpu", "mesh", None, False),
        ("cpu", None, True, True),
        ("gpu", None, False, False),
    ],
)
def test_fuse_enabled_per_platform_and_mesh(monkeypatch, backend, mesh, fuse, expected):
    """fuse=None fuses on the GPU only, and never under a spatial mesh;
    True/False force the choice everywhere."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    ope = load_of_method("classic+nl-fast")
    ope.fuse = fuse
    ope.spatial_mesh = mesh
    assert ope._fuse_enabled() is expected


@pytest.mark.parametrize(
    "backend,dtype,hsz,expected",
    [
        ("gpu", jnp.float32, 7, "pallas"),
        ("gpu", jnp.float64, 7, "sort"),
        ("cpu", jnp.float32, 7, "sort"),
        ("gpu", jnp.float32, 8, "sort"),  # 289 patch values > the kernel's lanes
    ],
)
def test_wmedian_impl_for(monkeypatch, backend, dtype, hsz, expected):
    """The weighted-median kernel runs on the GPU for float32; the XLA sort
    path everywhere else (the kernel never runs interpreted outside tests)."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert wmedian._impl_for(388, 584, hsz, 3, dtype) == expected
