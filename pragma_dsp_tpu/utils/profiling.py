"""Tracing / profiling helpers (SURVEY.md §5).

The reference's closest analogue is BenchContext's warmup+iter timing
(bench/reallife/helpers.ts:185-265); on the card the real tool is the
JAX profiler: capture a trace, open it in Perfetto/TensorBoard, read
per-kernel device time. These wrappers package the
`jax.profiler` + `block_until_ready` discipline.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, Optional

import jax

__all__ = ["trace", "timed", "annotate"]


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/pragma_dsp_tpu_trace",
          create_perfetto_link: bool = False):
    """Capture a profiler trace of the enclosed block::

        with profiling.trace("/tmp/trace"):
            out = pipeline(x)
            jax.block_until_ready(out)

    Open ``log_dir`` with TensorBoard's profile plugin or Perfetto.
    """
    jax.profiler.start_trace(log_dir,
                             create_perfetto_link=create_perfetto_link)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region that shows up in profiler traces
    (jax.profiler.TraceAnnotation passthrough)."""
    return jax.profiler.TraceAnnotation(name)


def timed(fn: Callable[..., Any], *args, warmup: int = 2, iters: int = 10,
          **kwargs) -> Dict[str, float]:
    """Wall-clock a function with block_until_ready discipline."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    jax.block_until_ready(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    return {"min_s": min(times), "avg_s": sum(times) / len(times),
            "max_s": max(times), "iters": iters}
