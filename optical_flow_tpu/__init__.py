"""optical_flow_tpu — a dense optical flow engine on an accelerator.

A from-scratch JAX / XLA / Pallas implementation of the Sun-Roth-Black
("Secrets of Optical Flow Estimation and Their Principles", CVPR 2010)
optical flow pipeline, with the full capability surface of the NumPy
reference (jordanshivers/optical-flow-python) redesigned for an accelerator:

* All hot kernels (warping, derivatives, ROF, median / weighted-median
  filtering, linear solves) are matrix-free, statically-shaped XLA or
  Pallas programs — the reference's ``scipy.sparse`` machinery
  (``sparse_ops.py`` + ``spsolve``) is replaced by a coupled 5-point
  stencil operator solved with Jacobi-preconditioned CG.
* Coarse-to-fine / GNC orchestration happens host-side over a static
  per-shape schedule; each pyramid-level solve is a single ``jit``
  program.
* Scale-out is via ``jax.sharding.Mesh`` + ``shard_map``: the image grid
  is tiled across devices with halo exchange, and CG inner products
  reduce with ``psum`` (see ``optical_flow_tpu.parallel``).

Public API mirrors the reference package (``optical_flow/__init__.py:10-25``).
"""

from optical_flow_tpu.interface import estimate_flow
from optical_flow_tpu.io.flo import read_flo, write_flo, read_flow_file
from optical_flow_tpu.viz.flow_color import flow_to_color, make_colorwheel, compute_color
from optical_flow_tpu.viz.plot_flow import plot_flow
from optical_flow_tpu.evaluation.metrics import flow_angular_error
from optical_flow_tpu.config import load_of_method
from optical_flow_tpu.parallel.pipeline import estimate_flow_pipelined
from optical_flow_tpu.parallel.video import estimate_flow_stream, estimate_flow_video

__all__ = [
    "estimate_flow_pipelined",
    "estimate_flow",
    "read_flo",
    "write_flo",
    "read_flow_file",
    "flow_to_color",
    "make_colorwheel",
    "compute_color",
    "plot_flow",
    "flow_angular_error",
    "load_of_method",
    "estimate_flow_stream",
    "estimate_flow_video",
]

__version__ = "0.1.0"
