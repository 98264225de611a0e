"""Base class for optical flow estimation methods.

API mirrors the reference ``methods/base.py`` (mutable attribute config +
``parse_input_parameter``), but execution is reorganized for an accelerator:

* the coarse-to-fine schedule (pyramid shapes, GNC stages, alpha values) is
  computed host-side as static data;
* each pyramid-level solve is a single jitted program whose static
  configuration is a frozen dataclass — ``jax.jit`` caches one executable
  per (config, shape);
* there is no sparse-matrix layer at all: linear systems live as
  :class:`~optical_flow_tpu.ops.stencil.FlowSystem` coefficient fields and
  are solved matrix-free (``solvers/``).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from optical_flow_tpu.ops.filters import median_filter2d
from optical_flow_tpu.ops.pyramid import auto_pyramid_levels, build_pyramid
from optical_flow_tpu.ops.derivatives import DEFAULT_DERIV_FILTER
from optical_flow_tpu.ops.penalties import Robust


@jax.jit
def jit_scale255(im):
    """scale_image(im, 0, 255) as one device program."""
    from optical_flow_tpu.utils.compat import scale_image

    return scale_image(im, 0, 255)


@partial(jax.jit, static_argnums=(1,))
def jit_median_pair(uv, size):
    """Median-filter both flow channels in one dispatch."""
    return jnp.stack(
        [
            median_filter2d(uv[:, :, 0], size, "reflect"),
            median_filter2d(uv[:, :, 1], size, "reflect"),
        ],
        axis=-1,
    )


class BaseOpticalFlow:
    """Shared mutable configuration (reference ``base.py:21-63``)."""

    # whether estimate_flow(mesh=) can route this method's levels through
    # the sharded programs in parallel/spatial.py; subclasses that can
    # shard set True.  A mesh= request on an unsupported method RAISES —
    # it must never silently compute unsharded.
    spatial_mesh_supported = False

    def __init__(self):
        self.images = None
        self.lambda_ = 1.0
        self.lambda_q = 1.0
        self.solver = "backslash"
        self.pcg_rtol = 1e-3
        self.pcg_maxiter = 200
        self.backslash_rtol = 1e-7
        self.backslash_maxiter = 1000
        self.sor_max_iters = 10000
        self.sor_omega = 1.9
        self.sor_tol = 1e-2
        self.interpolation_method = "cubic"
        self.deriv_filter = np.array(DEFAULT_DERIV_FILTER)
        self.blend = 0.5
        self.texture = False
        self.fc = False
        self.median_filter_size = None
        self.limit_update = True
        self.display = False
        self.color_images = None
        self.auto_level = True
        self.alp = 0.95

        # numeric precision of the compute path (tests may use float64 on CPU)
        self.dtype = jnp.float32

        # spatial (row) sharding: a jax.sharding.Mesh with a 'space' axis
        # routes every feasible pyramid-level solve through the shard_map
        # program in parallel/spatial.py; spatial_halo bounds the per-level
        # warp displacement handled exactly at shard boundaries.  'auto'
        # (default) sizes it per level from the measured incoming-flow bound
        # plus the per-iteration ±1 update clip (_resolve_spatial_halo), so
        # shard-boundary warp reads are exact for any real motion magnitude;
        # an int fixes it (and silently clamps larger displacements).
        self.spatial_mesh = None
        self.spatial_halo = "auto"

        # optional callable(stage, level, uv) invoked after every pyramid
        # level — see utils/checkpoint.FlowCheckpointer.  Forces the
        # per-level execution path (incompatible with whole-flow fusion).
        self.checkpoint = None

        # dtype of the RETURNED flow (e.g. 'float16'); the cast runs on
        # device, so the result crosses the host link at half the bytes
        # (the f32 flow is ~66 MB/frame at 4K).
        # None = the compute dtype (float32), the parity default.
        self.out_dtype = None

        # failure detection + recovery (utils/guard.py): when set to a
        # max-|flow| threshold (1e9 = the reference metrics' unknown-flow
        # sentinel), any pyramid level whose result goes non-finite or
        # exceeds it rolls back to the level's initialization and the
        # coarse-to-fine recursion continues from the last healthy
        # estimate.  None = off (reference parity reproduces divergences).
        self.guard_flow = None

        # Fuse the whole coarse-to-fine flow into ONE jitted program
        # (hs_flow_program / ba_flow_program / ...), frames in as uint8 and
        # preprocessing included.  None = 'auto': fuse on the GPU, where the
        # monolith removes the per-level dispatch chain; the CPU keeps
        # per-level programs (whole-flow compiles are slow there).
        # True/False force the choice.
        self.fuse = None

        # Pyramid settings
        self.pyramid_levels = 4
        self.pyramid_spacing = 2.0

        # GNC settings
        self.gnc_iters = 1
        self.gnc_pyramid_levels = 2
        self.gnc_pyramid_spacing = 1.25
        self.alpha = 1.0

        # Iteration settings
        self.max_iters = 10
        self.max_linear = 1

        # Spatial filters and robust functions.  The spatial filters are the
        # forward differences [[1,-1]] and [[1],[-1]] — in this framework
        # they are hard-wired into the stencil operator
        # (ops/stencil.py: forward_diff_h / forward_diff_v).
        method = "quadratic"
        self.rho_spatial_u = [Robust(method, (1.0,)), Robust(method, (1.0,))]
        self.rho_spatial_v = [Robust(method, (1.0,)), Robust(method, (1.0,))]
        self.rho_data = Robust(method, (1.0,))

    # ------------------------------------------------------------------
    # parameter handling (reference base.py:65-84)
    # ------------------------------------------------------------------
    def parse_input_parameter(self, params):
        """Set parameters from a dict or MATLAB-style [k, v, k, v, ...] list."""
        if isinstance(params, dict):
            items = params.items()
        elif isinstance(params, (list, tuple)):
            items = zip(params[0::2], params[1::2])
        else:
            return
        for key, val in items:
            attr = "lambda_" if key == "lambda" else key
            if hasattr(self, attr):
                setattr(self, attr, val)

    # ------------------------------------------------------------------
    # host-side schedule helpers
    # ------------------------------------------------------------------
    def _auto_pyramid_levels(self, images):
        return auto_pyramid_levels(images.shape[:2], self.pyramid_spacing)

    def _build_pyramid(self, images, levels, spacing):
        return build_pyramid(images, levels, spacing)

    def _solver_cfg(self):
        return (
            str(self.solver),
            float(self.pcg_rtol),
            int(self.pcg_maxiter),
            float(self.backslash_rtol),
            int(self.backslash_maxiter),
            float(self.sor_omega),
            int(self.sor_max_iters),
            float(self.sor_tol),
        )

    def _fuse_enabled(self) -> bool:
        """Resolve the ``fuse`` tri-state (see ``__init__``): None = 'auto'
        fuses on the GPU unless a spatial mesh routes levels through
        shard_map."""
        if self.fuse is None:
            return (
                jax.default_backend() == "gpu"
                and getattr(self, "spatial_mesh", None) is None
            )
        return bool(self.fuse)

    def _as_dtype(self, x):
        return jnp.asarray(x, dtype=self.dtype)

    def _resolve_spatial_halo(self, uv, max_growth: int) -> int:
        """Per-level warp-halo radius for the sharded path.

        ``'auto'`` measures the level's incoming flow bound (one scalar
        host fetch — the spatial path is per-level dispatched anyway) and
        adds ``max_growth`` (the warping-iteration count: the ±1 update
        clip bounds per-iteration growth, so |uv| during the level never
        exceeds ceil(max|uv_in|) + iters).  Bucketed to multiples of 8 to
        bound recompiles across levels/sequences.
        """
        h = self.spatial_halo
        if h != "auto":
            return int(h)
        if not bool(getattr(self, "limit_update", True)):
            # without the ±1 update clip the per-iteration growth is
            # unbounded, so no halo computed from |uv_in| can be exact —
            # fail loudly rather than silently clamp at shard edges
            raise ValueError(
                "spatial_halo='auto' requires limit_update=True (the ±1 "
                "per-iteration update clip is what bounds flow growth "
                "within a level); set an explicit integer spatial_halo "
                "or re-enable limit_update."
            )
        # reduce on device and fetch ONE scalar, not the whole field
        m = float(jnp.max(jnp.abs(uv)))
        if not np.isfinite(m):
            m = 0.0
        req = int(np.ceil(m)) + int(max_growth)
        return max(8, -(-req // 8) * 8)

    # ------------------------------------------------------------------
    def compute_flow_from_rgb(self, im1, im2):
        """Whole flow from raw (H, W, 3) frames as ONE device program.

        Methods with a fused whole-flow program override this to fold the
        reference's host-side preprocessing (``interface.py:46-64``) into
        the monolith: the frame pair crosses the host link once (as uint8
        when exact) and a single dispatch covers rgb2gray/rgb2lab, pyramid
        builds, and every level solve.  Returns None when the fused path
        does not apply (then :func:`estimate_flow` falls back to the
        per-level path).
        """
        return None

    def compute_flow_from_gray(self, im1, im2):
        """Whole flow from a raw (H, W) grayscale pair as ONE device program.

        Grayscale analog of :meth:`compute_flow_from_rgb`: the pair ships
        uint8 when exact (8x fewer host-link bytes than the preprocessed
        float32 stack) and the stack/rescale preprocessing runs inside the
        monolith.  Returns None when the fused path does not apply.
        """
        return None

    def compute_flow(self, init=None, gt=None):
        raise NotImplementedError

    def compute_flow_base(self, uv):
        raise NotImplementedError
