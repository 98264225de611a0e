"""Test configuration: CPU backend with a virtual 8-device mesh, f64 on.

Tests run on the CPU by default; the virtual device count exercises the
multi-device sharding paths without real hardware.  float64 is enabled so
numerical parity tests against scipy / the NumPy reference can assert at
machine precision.  Tests marked ``gpu`` need the card: they skip here and
run with ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`` on a GPU host.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import sys  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE_PATH = "/root/reference"
DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def have_reference() -> bool:
    return os.path.isdir(os.path.join(REFERENCE_PATH, "optical_flow"))


@pytest.fixture(scope="session")
def reference_pkg():
    """The NumPy reference package as a parity oracle (skipped if absent)."""
    if not have_reference():
        pytest.skip("reference implementation not available")
    if REFERENCE_PATH not in sys.path:
        sys.path.insert(0, REFERENCE_PATH)
    import optical_flow as ref

    return ref


@pytest.fixture(scope="session")
def data_dir():
    if not os.path.isdir(DATA_DIR):
        pytest.skip("Middlebury data not available")
    return DATA_DIR


@pytest.fixture(scope="session")
def rubberwhale(data_dir):
    """Real 584x388 RubberWhale pair + ground truth."""
    from optical_flow_tpu.io.flo import read_flow_file

    im1, im2, tu, tv = read_flow_file("RubberWhale", 10, data_dir)
    return im1, im2, tu, tv


@pytest.fixture()
def gpu_device():
    """The first GPU device; skips where JAX finds none."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("no GPU visible to JAX")
    return devices[0]


@pytest.fixture()
def synthetic_pair():
    """Seeded 64x64 random image shifted 1px right — known-answer fixture."""
    rng = np.random.default_rng(42)
    im1 = rng.uniform(0, 255, (64, 64))
    im2 = np.roll(im1, 1, axis=1)
    return im1, im2


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_programs_per_module():
    """Clear JAX executable caches at every module boundary.

    This jaxlib's XLA:CPU aborts the process ("Fatal Python error: Aborted")
    on a large compile once hundreds of executables from earlier modules are
    live — the whole-flow monoliths (test_fused, test_methods) are the usual
    trigger.  Modules rarely share compiled programs, so per-module clearing
    costs little and keeps the full suite inside one stable process.
    """
    yield
    jax.clear_caches()
