"""Checks that need a CUDA GPU: the weighted-median kernel as compiled for
the card.  They skip where JAX finds no GPU; on a GPU host run
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from optical_flow_tpu.ops.pallas.wmedian_kernel import wmedian_pallas
from optical_flow_tpu.ops.wmedian import wmedfilt_prepadded


@pytest.mark.gpu
@pytest.mark.parametrize("H,W,C", [(64, 96, 3), (37, 130, 1)])
def test_wmedian_kernel_compiled_matches_sort_path(gpu_device, rng, H, W, C):
    """The Triton-compiled kernel selects the same samples as the sort path."""
    hsz, sigma = 7, 7.0
    uv = (3 * rng.standard_normal((H, W, 2))).astype(np.float32)
    color = rng.uniform(0, 255, (H, W, C)).astype(np.float32)
    occ = rng.uniform(0.1, 1.0, (H, W)).astype(np.float32)
    with jax.default_device(gpu_device):
        pad = lambda x: jnp.pad(jnp.asarray(x), hsz, mode="reflect")
        color_pad = jnp.pad(jnp.asarray(color), ((hsz, hsz), (hsz, hsz), (0, 0)), mode="reflect")
        args = (pad(uv[:, :, 0]), pad(uv[:, :, 1]), pad(occ))
        out = np.asarray(wmedian_pallas(*args, jnp.transpose(color_pad, (2, 0, 1)), (H, W), hsz, sigma))
        ref = np.asarray(
            wmedfilt_prepadded(*args, color_pad, jnp.asarray(color), H, W, hsz, sigma)
        )
    np.testing.assert_array_equal(out, ref)
