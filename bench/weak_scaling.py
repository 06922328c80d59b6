#!/usr/bin/env python3
"""Weak-scaling bench: per-device throughput of the sharded pipelines at
D = 1, 2, 4, 8 devices. With ``--cpu`` it runs on an 8-device virtual
CPU mesh (a collective-logic smoke test, no timing meaning); on a
machine with several GPUs it measures the same code over NVLink."""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from helpers import parse_args, verified


def main():
    args = parse_args(lambda p: p.add_argument(
        "--devices", default="1,2,4,8"))
    if args.cpu:
        # Ensure the 8-device virtual CPU mesh exists (setdefault would
        # no-op when XLA_FLAGS is already set in the environment).
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pragma_dsp_tpu.core.complex import ComplexArray
    from pragma_dsp_tpu.parallel import (
        data_mesh, dist_fft, dist_fft_shape, sharded_pfb_channelize,
        sharded_spectrogram)

    avail = len(jax.devices())
    dev_counts = [int(d) for d in args.devices.split(",") if int(d) <= avail]
    rng = np.random.default_rng(0)

    def timed(fn, k=5):
        out = fn()
        jax.block_until_ready(out)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(k):
                out = fn()
            jax.block_until_ready(out)
            best = min(best, (time.perf_counter() - t0) / k)
        return best

    on_gpu = jax.default_backend() == "gpu"
    if not on_gpu:
        # CPU-mesh "efficiency" numbers carry no interconnect meaning.
        # Say so in the report instead of implying them.
        print("NOTE: running on the virtual CPU mesh — numbers below are a "
              "collective-logic SMOKE TEST only;\nper-device efficiency on "
              "shared host cores says NOTHING about weak scaling on GPUs.")

    def eff(thr, base, d):
        # Per-device "eff %" on the CPU mesh would read like a device
        # number in captured reports — tag the rows themselves.
        if not on_gpu:
            return "eff n/a (CPU mesh)"
        return f"eff {100*thr/(base*d):.0f}%"
    print("== weak scaling: sharded spectrogram (per-device load fixed) ==")
    per_dev = (1 << 17) if on_gpu else (1 << 14)
    n_fft, hop = (1024, 256) if on_gpu else (256, 64)
    base = None
    for d in dev_counts:
        mesh = data_mesh(d)
        x = rng.standard_normal(d * per_dev).astype(np.float32)
        xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("x")))
        t = timed(lambda: sharded_spectrogram(
            xs, n_fft, hop, "hann", 48e3, mesh=mesh).amplitude)
        thr = d * per_dev / t / 1e6
        if base is None:
            base = thr / d
        print(f"D={d}: {thr:9.1f} MS/s total  ({thr/d:8.1f} /dev, "
              f"{eff(thr, base, d)})")

    print("== weak scaling: 256-ch sharded PFB channelizer ==")
    c = 256
    per_dev = c * (256 if on_gpu else 16)
    base = None
    for d in dev_counts:
        if c % d != 0:
            continue
        mesh = data_mesh(d)
        z = rng.standard_normal(d * per_dev).astype(np.float32)
        zi = rng.standard_normal(d * per_dev).astype(np.float32)
        sh = NamedSharding(mesh, P("x"))
        iq = ComplexArray(jax.device_put(jnp.asarray(z), sh),
                          jax.device_put(jnp.asarray(zi), sh))
        t = timed(lambda: sharded_pfb_channelize(
            iq, c, mesh=mesh, channels_sharded_out=True).real)
        thr = d * per_dev / t / 1e6
        if base is None:
            base = thr / d
        print(f"D={d}: {thr:9.1f} MS/s total  ({thr/d:8.1f} /dev, "
              f"{eff(thr, base, d)})")

    print("== 2-D (host, chip) mesh: config-5 PFB, channels over host ==")
    if avail >= 8:
        from pragma_dsp_tpu.parallel import make_mesh

        mesh2 = make_mesh((2, 4), ("host", "chip"))
        per_dev = c * (256 if on_gpu else 16)
        z = rng.standard_normal(8 * per_dev).astype(np.float32)
        zi = rng.standard_normal(8 * per_dev).astype(np.float32)
        sh = NamedSharding(mesh2, P(("host", "chip")))
        iq = ComplexArray(jax.device_put(jnp.asarray(z), sh),
                          jax.device_put(jnp.asarray(zi), sh))
        t = timed(lambda: sharded_pfb_channelize(
            iq, c, mesh=mesh2, axis=("host", "chip"),
            channels_sharded_out=True).real)
        print(f"(2,4) mesh: {8 * per_dev / t / 1e6:9.1f} MS/s total "
              "(halos on 'chip', corner turn over the joint axis)")

    print("== weak scaling: time-sharded WBFM chain (config 4) ==")
    from pragma_dsp_tpu.parallel import sharded_wbfm_demod

    per_dev = (1 << 19) if on_gpu else 16800
    per_dev = per_dev // 50 * 50
    halo = 8200 if per_dev >= 8200 else 400
    base = None
    for d in dev_counts:
        mesh = data_mesh(d)
        z = rng.standard_normal(d * per_dev).astype(np.float32)
        zi = rng.standard_normal(d * per_dev).astype(np.float32)
        sh = NamedSharding(mesh, P("x"))
        iq = ComplexArray(jax.device_put(jnp.asarray(z), sh),
                          jax.device_put(jnp.asarray(zi), sh))
        t = timed(lambda: sharded_wbfm_demod(iq, mesh, halo=halo))
        thr = d * per_dev / t / 1e6
        if base is None:
            base = thr / d
        print(f"D={d}: {thr:9.1f} MS/s total  ({thr/d:8.1f} /dev, "
              f"{eff(thr, base, d)})")

    print("== weak scaling: time-sharded resampler 147/160 (config 3) ==")
    from pragma_dsp_tpu.parallel import sharded_resample_poly

    per_dev = (1 << 19) if on_gpu else 16000
    per_dev = per_dev // 160 * 160      # block*up % down == 0
    base = None
    for d in dev_counts:
        mesh = data_mesh(d)
        z = rng.standard_normal(d * per_dev).astype(np.float32)
        xs = jax.device_put(jnp.asarray(z), NamedSharding(mesh, P("x")))
        t = timed(lambda: sharded_resample_poly(
            xs, 147, 160, num_taps=8 * 147 + 1, mesh=mesh))
        thr = d * per_dev / t / 1e6
        if base is None:
            base = thr / d
        print(f"D={d}: {thr:9.1f} MS/s total  ({thr/d:8.1f} /dev, "
              f"{eff(thr, base, d)})")

    print("== weak scaling: no-turn channel power (config 5 consumer) ==")
    from pragma_dsp_tpu.parallel import sharded_channel_power

    n_fft_pw = 16
    mloc = (256 if on_gpu else 32)
    mloc = mloc // n_fft_pw * n_fft_pw
    base = None
    for d in dev_counts:
        mesh = data_mesh(d)
        m = d * mloc
        z = rng.standard_normal((m, c)).astype(np.float32)
        zi = rng.standard_normal((m, c)).astype(np.float32)
        sh = NamedSharding(mesh, P("x", None))
        fr = ComplexArray(jax.device_put(jnp.asarray(z), sh),
                          jax.device_put(jnp.asarray(zi), sh))
        t = timed(lambda: sharded_channel_power(fr, c, mesh=mesh,
                                                n_fft=n_fft_pw))
        thr = m * c / t / 1e6
        if base is None:
            base = thr / d
        print(f"D={d}: {thr:9.1f} MS/s total  ({thr/d:8.1f} /dev, "
              f"{eff(thr, base, d)})")

    print("== strong scaling: distributed FFT ==")
    n = (1 << 20) if on_gpu else (1 << 16)
    for d in dev_counts:
        try:
            n2, n1 = dist_fft_shape(n, d)
        except ValueError:
            continue
        mesh = data_mesh(d)
        z = rng.standard_normal((n2, n1)).astype(np.float32)
        sh = NamedSharding(mesh, P(None, "x"))
        zc = ComplexArray(jax.device_put(jnp.asarray(z), sh),
                          jax.device_put(jnp.zeros((n2, n1), jnp.float32), sh))
        t = timed(lambda: dist_fft(zc, mesh).real, k=3)
        print(f"D={d}: {t*1e3:8.2f} ms  ({n/t/1e6:7.1f} MS/s)")


if __name__ == "__main__":
    main()
