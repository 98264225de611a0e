"""Tracing / profiling utilities.

The reference's only observability is wall-clock prints per GNC stage
(``ba.py:95,132-133``).  Here:

* :func:`trace` — context manager around ``jax.profiler`` emitting a
  TensorBoard-compatible device trace (per-kernel timing).
* :class:`StageTimer` — lightweight host-side stage timing with device
  synchronization, for quick breakdowns without a trace viewer.
* :func:`annotate` — named trace annotation for host-side phases.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device trace viewable in TensorBoard / Perfetto."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named annotation context for host-side phases inside a trace."""
    return jax.profiler.TraceAnnotation(name)


class StageTimer:
    """Host-side stage timer that synchronizes the device per stage.

    Example:
        timer = StageTimer()
        with timer.stage("pyramid"):
            pyr = build_pyramid(...)
        print(timer.report())
    """

    def __init__(self):
        self.records: List[Tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                jax.block_until_ready(sync)
            self.records.append((name, time.perf_counter() - t0))

    def totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, dt in self.records:
            out[name] = out.get(name, 0.0) + dt
        return out

    def report(self) -> str:
        totals = self.totals()
        width = max((len(n) for n in totals), default=4)
        lines = [f"{n:<{width}}  {dt * 1000:9.2f} ms" for n, dt in totals.items()]
        return "\n".join(lines)
