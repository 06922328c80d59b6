#!/usr/bin/env python3
"""A/B of the FFT routes behind ``ops.dispatch`` on the card.

Times ``xla`` (jnp.fft, cuFFT on the GPU) and ``stockham`` on batched
complex transforms at each of ``SIZES``, with a batch that fills ``MIB``
MiB of split input planes (several times the 50 MB L2). Each row gives:

* ``ms``: the median of ``REPS`` timings of ``CALLS`` back-to-back
  calls ended by ``block_until_ready``, divided by ``CALLS`` (host
  dispatch overlaps with the device);
* ``io_bytes``: the planes the transform must read and write
  (16 B per complex point), the least any route can move;
* ``xla_bytes``: what XLA's cost model says the compiled program
  accesses (custom calls such as cuFFT may be counted as their operands
  only);
* ``copy_share``: io_bytes / ms as a share of the rate a large
  elementwise copy reaches in the same run.

Also checks each route against np.fft.fft in float64 on a few rows.
Prints one JSON line per row and, last, a JSON summary with the winner
at each size. ``python bench/fft_routes.py`` takes no arguments and
fails without a GPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

ROUTES = ("xla", "stockham")
SIZES = (256, 1024, 4096, 1 << 20)
MIB = 256       # split input planes per batch
CALLS = 10      # back-to-back calls per timing
REPS = 5        # timings per median


def timed_ms(fn, args, calls: int, reps: int) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = None
        for _ in range(calls):
            out = fn(*args)
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) * 1e3 / calls)
    return float(np.median(times))


def main() -> int:
    import jax
    import jax.numpy as jnp

    from pragma_dsp_tpu.core import ComplexArray
    from pragma_dsp_tpu.ops import fft
    from pragma_dsp_tpu.utils.compile_cache import enable_compile_cache
    from pragma_dsp_tpu.utils.fixtures import snr_db

    if jax.default_backend() != "gpu":
        print(f"fft_routes: needs a GPU, JAX found {jax.default_backend()!r}",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    dev = jax.devices()[0]
    from chip_smoke import card_line

    print(f"card: {card_line()} | jax {jax.__version__}", flush=True)

    # Practical ceiling: a large elementwise pass, read + write.
    big = jnp.ones((MIB * (1 << 20) // 4,), jnp.float32)
    scale = jax.jit(lambda a: a * 1.0001)
    copy_ms = timed_ms(scale, (big,), CALLS, REPS)
    copy_rate = 2 * big.nbytes / (copy_ms * 1e-3)
    print(json.dumps({"copy_bytes": 2 * big.nbytes, "ms": copy_ms,
                      "bytes_per_s": copy_rate}), flush=True)
    del big

    rows, winners = [], {}
    key = jax.random.PRNGKey(0)
    for n in SIZES:
        batch = max(1, MIB * (1 << 20) // (8 * n))
        planes = jax.random.normal(key, (2, batch, n), jnp.float32)
        xr, xi = planes[0], planes[1]
        z = (np.asarray(xr[:4], np.float64)
             + 1j * np.asarray(xi[:4], np.float64))
        ref = np.fft.fft(z, axis=-1)
        io_bytes = 16 * batch * n
        best = None
        for route in ROUTES:
            fn = jax.jit(lambda a, b, r=route: fft(ComplexArray(a, b),
                                                   impl=r))
            t0 = time.perf_counter()
            compiled = fn.lower(xr, xi).compile()
            compile_s = time.perf_counter() - t0
            cost = compiled.cost_analysis() or {}
            if isinstance(cost, list):
                cost = cost[0] if cost else {}
            ms = timed_ms(compiled, (xr, xi), CALLS, REPS)
            out = compiled(xr, xi)
            got = (np.asarray(out.real[:4], np.float64)
                   + 1j * np.asarray(out.imag[:4], np.float64))
            row = {"n": n, "batch": batch, "route": route, "ms": ms,
                   "compile_s": compile_s, "io_bytes": io_bytes,
                   "xla_bytes": cost.get("bytes accessed"),
                   "copy_share": io_bytes / (ms * 1e-3) / copy_rate,
                   "snr_db": snr_db(ref, got)}
            rows.append(row)
            print(json.dumps(row), flush=True)
            if best is None or ms < best[1]:
                best = (route, ms)
            del out, compiled
        winners[n] = best[0]
        del planes, xr, xi

    print(json.dumps({"device": {"platform": dev.platform,
                                 "kind": dev.device_kind},
                      "copy_bytes_per_s": copy_rate,
                      "winner": winners}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
