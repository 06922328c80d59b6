#!/usr/bin/env python3
"""Streaming/service benches: spectrum_fx vs spectrum overhead, cache-hit
latency, stream mapping, batched STFT throughput
(reference bench/reallife/effect.ts)."""

from __future__ import annotations

import numpy as np

from helpers import finish, get_context, parse_args, sine, verified


def main():
    args = parse_args()
    import jax.numpy as jnp

    from pragma_dsp_tpu import spectrum
    from pragma_dsp_tpu.stream import (
        FourierService, spectrum_fx, spectrum_stream, stft, spectrogram)

    bc = get_context(args)
    n, sr = 1024, 48000.0
    x = jnp.asarray(sine(32 * sr / n, 0.8, 0.0, sr, n).astype(np.float32))
    svc = FourierService()

    a = spectrum(x, sample_rate=sr)
    b = spectrum_fx(x, service=svc, sample_rate=sr)
    verified("spectrum_fx parity",
             np.array_equal(np.asarray(a.amplitude), np.asarray(b.amplitude)))
    verified("fft cache identity", svc.fft(n) is svc.fft(n))
    verified("window cache identity",
             svc.window("hann", n) is svc.window("hann", n))

    bc.time("spectrum (plain)", lambda: spectrum(x, sample_rate=sr),
            samples_per_call=n)
    bc.time("spectrum_fx (cached svc)",
            lambda: spectrum_fx(x, service=svc, sample_rate=sr),
            samples_per_call=n)
    frames = [np.asarray(x)] * 10
    bc.time("spectrum_stream 10 frames",
            lambda: list(spectrum_stream(frames, service=svc, sample_rate=sr)),
            samples_per_call=10 * n)

    audio = jnp.asarray(
        sine(2000.0, 0.5, 0.0, sr, 10 * 48000).astype(np.float32))
    bc.time("stft 10s 4096/75%", lambda: stft(audio, 4096, 1024),
            samples_per_call=audio.shape[0])
    bc.time("spectrogram 10s 4096/75%",
            lambda: spectrogram(audio, 4096, 1024, "hann", sr),
            samples_per_call=audio.shape[0])

    # donated chunk loop: the carry is updated in place, so live HBM must
    # not grow per chunk (the reference's zero-allocation hot-loop
    # contract, src/core/fft.ts:89-106 — donation is the analogue).
    import jax
    from pragma_dsp_tpu.stream import jit_stream_step, stft_stream_init, stft_step
    from pragma_dsp_tpu.utils.benchharness import memory_snapshot

    n_fft, hop, chunk_len = 1024, 256, 16384
    state = stft_stream_init(n_fft, hop)
    step = jit_stream_step(stft_step, n_fft=n_fft, hop=hop)
    chunk = jnp.asarray(
        sine(2000.0, 0.5, 0.0, sr, chunk_len).astype(np.float32))
    state, out = step(state, chunk)             # compile + warm
    jax.block_until_ready(out)
    m0 = memory_snapshot()
    for _ in range(50):
        state, out = step(state, chunk)
    jax.block_until_ready(out)
    m1 = memory_snapshot()
    growth = m1["hbm_in_use_bytes"] - m0["hbm_in_use_bytes"]
    if m1["hbm_in_use_bytes"]:
        verified("donated stft chunk loop: no per-chunk HBM growth",
                 growth <= 1 << 20, f"Δ {growth/1e6:+.2f} MB over 50 chunks")
    def run_50():
        # donation invalidates the old carry, so the evolving state must
        # be threaded across bench iterations (not restarted from a
        # donated-away value).
        nonlocal_state = run_50.state
        o = None
        for _ in range(50):
            nonlocal_state, o = step(nonlocal_state, chunk)
        run_50.state = nonlocal_state
        return o
    run_50.state = state
    bc.time("donated stft_step x50 (16k chunk)", run_50,
            samples_per_call=50 * chunk_len)
    print(bc.report())


if __name__ == "__main__":
    main()
    finish()
