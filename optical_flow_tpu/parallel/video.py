"""Video-sequence flow estimation: consecutive-pair batching + streaming.

Two production serving shapes the reference (single pair per process)
cannot express:

* **batched** — a (T, H, W) sequence becomes T-1 consecutive pairs
  processed data-parallel (one vmapped program over the batch, batch axis
  shardable over the mesh);
* **streamed** — pairs are dispatched back-to-back WITHOUT fetching
  results in between.  JAX dispatch is asynchronous, so the host link's
  per-frame cost (h2d transfer, dispatch, result d2h) hides behind device
  compute.  Peak in-flight memory is bounded by
  ``max_in_flight``.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from optical_flow_tpu.parallel.batch import estimate_flow_batched


def estimate_flow_video(frames, method: str = "classic+nl-fast", mesh=None, params=None):
    """Flow for every consecutive pair of a (T, H, W) grayscale sequence.

    Returns (T-1, H, W, 2).
    """
    frames = jnp.asarray(frames)
    if frames.ndim != 3:
        raise ValueError(f"expected (T, H, W) grayscale frames, got {frames.shape}")
    pairs = jnp.stack([frames[:-1], frames[1:]], axis=-1)  # (T-1, H, W, 2)
    return estimate_flow_batched(pairs, method, mesh=mesh, params=params)


def estimate_flow_stream(
    frame_pairs,
    method: str = "classic+nl-fast",
    params=None,
    max_in_flight: int = 8,
):
    """Pipelined flow over an iterable of (im1, im2) frame pairs.

    Dispatches up to ``max_in_flight`` whole-flow programs before draining
    the oldest result, so host↔device transfers and dispatch latency overlap
    device compute.  Yields (H, W, 2) numpy flows in input order.

    Accepts any iterable (a generator reading frames from disk overlaps
    decode with device compute too — pair with ``io.loader`` for prefetch).
    """
    from optical_flow_tpu.interface import estimate_flow

    in_flight = []
    for im1, im2 in frame_pairs:
        in_flight.append(estimate_flow(im1, im2, method, params))
        if len(in_flight) >= max_in_flight:
            yield np.asarray(in_flight.pop(0))
    while in_flight:
        yield np.asarray(in_flight.pop(0))
