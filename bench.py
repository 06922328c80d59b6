#!/usr/bin/env python3
"""Headline benchmark: config 1, ``pd.spectrum`` on one GPU.

Times the public beginner-rung entry point, ``pd.spectrum(x,
sample_rate=48000., window="hann")``, over a [65536, 1024] float32
batch (256 MiB in, more than 4x the H100's 50 MB L2): 20 runs of
one jitted call, each ended by ``block_until_ready``. Gates the
result as ``chip_smoke.py`` does (peak bin 32 on every row, >= 105 dB
against the float64 oracle on 64 rows).

Prints the card's name and power limit first, then one JSON line:

  {"metric": ..., "value": N, "unit": "Msamples/s", "hbm_share": N, ...}

``hbm_share`` is the bytes the call must move (4 B/sample in, the
one-sided amplitude and phase out) over the median time, as a share of
the card's published HBM rate (utils/benchharness.py). Exits non-zero
without a GPU or when a gate fails.
"""

from __future__ import annotations

import json
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main() -> int:
    import jax

    if jax.default_backend() != "gpu":
        log(f"bench: needs a GPU, JAX found {jax.default_backend()!r}")
        return 2

    import chip_smoke as cs
    import pragma_dsp_tpu as pd
    from pragma_dsp_tpu.ops import fft_route
    from pragma_dsp_tpu.utils.benchharness import checksum, device_specs
    from pragma_dsp_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    specs = device_specs(dev.device_kind)
    print(f"card: {cs.card_line()} | jax {jax.__version__}", flush=True)

    rows, n, reps = 65536, 1024, 20
    rng_key = jax.random.PRNGKey(1337)
    checks = cs.phase_spectrum(rows=rows, n=n)
    for c in checks:
        log(c.line())

    x = jax.random.normal(rng_key, (rows, n), jax.numpy.float32)
    step = jax.jit(lambda v: pd.spectrum(v, sample_rate=48000.0,
                                         window="hann"))
    out = jax.block_until_ready(step(x))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(step(x))
        times.append(time.perf_counter() - t0)
    times.sort()
    med = times[len(times) // 2]
    log(f"spectrum checksum: {checksum(out.amplitude)}")

    bins = n // 2 + 1
    bytes_per_call = rows * (4 * n + 2 * 4 * bins)
    result = {
        "metric": "pd.spectrum 1024-pt Hann, [65536, 1024] f32 (1 card)",
        "value": rows * n / med / 1e6,
        "unit": "Msamples/s",
        "hbm_share": bytes_per_call / med / specs["hbm_bytes_per_s"],
        "timing_ms": {"min": times[0] * 1e3, "median": med * 1e3,
                      "max": times[-1] * 1e3, "reps": reps},
        "fft_route": fft_route(),
        "ok": all(c.ok for c in checks),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    print(json.dumps(result))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
