"""Device mesh construction for multi-chip flow estimation.

The reference is strictly single-process (SURVEY §2); this framework
scales along two axes:

* ``batch`` — data parallelism over frame pairs (embarrassingly parallel),
* ``space`` — image-domain tiling: the pixel grid is the "sequence", shards
  exchange halo strips (``ppermute``), and CG inner products
  reduce with ``psum`` — the context-parallel analog for a pixel grid.

Collectives are XLA's own (NCCL on GPUs); multi-host runs go through
``jax.distributed.initialize``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BATCH_AXIS = "batch"
SPACE_AXIS = "space"


def flow_mesh(
    batch: int = 1,
    space: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a (batch, space) mesh over the available devices.

    ``space`` defaults to ``n_devices // batch``.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if space is None:
        if n % batch != 0:
            raise ValueError(f"{n} devices not divisible by batch={batch}")
        space = n // batch
    if batch * space != n:
        raise ValueError(f"batch*space = {batch * space} != {n} devices")
    dev_array = np.asarray(devices).reshape(batch, space)
    return Mesh(dev_array, (BATCH_AXIS, SPACE_AXIS))


def space_sharding(mesh: Mesh) -> NamedSharding:
    """Rows of an (H, W[, C]) field sharded over the space axis."""
    return NamedSharding(mesh, P(SPACE_AXIS))


def batch_space_sharding(mesh: Mesh) -> NamedSharding:
    """(B, H, W[, C]) batch over 'batch', rows over 'space'."""
    return NamedSharding(mesh, P(BATCH_AXIS, SPACE_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
