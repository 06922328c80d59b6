"""Scan-driven streaming: jitted+donated step compilation and a
lax.scan driver for chunked pipelines.

The reference's expert rung is out-buffer reuse — callers pass an
``out`` ComplexArray that ``Radix2Fft.transform`` fills in place, so the
hot loop allocates nothing (reference src/core/fft.ts:89-106,
README.md:41-51 "zero-allocation hot loop"). Under XLA the analogue is
**buffer donation**: marking the streaming carry as donated lets the
compiler write the new carry into the old carry's buffer, so a chunked
receive loop runs with zero per-chunk HBM growth.

Two entry points:

* :func:`jit_stream_step` — compile a ``step(state, chunk) ->
  (state, out)`` function with the state donated. Use for Python-driven
  chunk loops (live streaming).
* :func:`scan_stream` — drive a step over a pre-batched [n_chunks, ...]
  array with ``lax.scan``; the carry is threaded in place by XLA. Use
  for offline/bulk processing of a chunked recording.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp

__all__ = ["jit_stream_step", "scan_stream"]


def jit_stream_step(step: Callable, donate: bool = True, **static_kwargs):
    """Compile ``step(state, chunk, **static_kwargs)`` with the state
    buffer donated (in-place carry update — the analogue of the
    reference's out-buffer reuse).

    Returns a jitted ``(state, chunk) -> (new_state, out)``. Donation is
    a no-op on backends that don't support it (CPU warns; harmless).
    """
    bound = functools.partial(step, **static_kwargs) if static_kwargs else step
    kw = {"donate_argnums": (0,)} if donate else {}
    return jax.jit(bound, **kw)


def scan_stream(step: Callable, state: Any, chunks: Any,
                **static_kwargs) -> Tuple[Any, Any]:
    """Run ``step`` over the leading axis of ``chunks`` with lax.scan.

    ``chunks`` is an array (or pytree of arrays) shaped [n_chunks, ...];
    returns (final_state, outputs stacked on a leading n_chunks axis).
    The whole loop is one XLA program: the carry never round-trips to
    the host and XLA reuses its buffers across iterations.
    """
    bound = functools.partial(step, **static_kwargs) if static_kwargs else step

    @jax.jit
    def run(state, chunks):
        return jax.lax.scan(bound, state, chunks)

    return run(state, chunks)
