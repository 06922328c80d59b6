#!/usr/bin/env python3
"""Run the library's main paths once on the GPU and check every result.

    python chip_smoke.py              # one card: the six pipeline phases
    python chip_smoke.py --cards 4    # four cards: the sharded layer only

Each phase drives public entry points at the size its deployment uses
(BASELINE.json configs 1-5 and the 1M-point FFT) and compares the result
with an independent float64 NumPy/SciPy oracle, or, on four cards, with
the same operation on one card. Data is made from ``--seed``, on the
device where it is large.

Every check prints one line: the phase, the entry point, the shapes,
the FFT route that ``ops.dispatch`` chose, the compile time (s), one
steady run (ms, after a warm-up, ended by ``block_until_ready``), the
measured value against its gate, and the device's peak bytes in use so
far in the process. The first line names the card (``nvidia-smi``
name and power limit) and the JAX version. The last line of standard
output is one JSON object::

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

It is printed only when every check passed. Without a GPU, or when any
check fails, the script exits non-zero.

Precision: all phases compute in float32. The FFTs run on cuFFT in f32,
and every f32 matmul on these paths (banded upfirdn, blocked
de-emphasis IIR) is pinned to ``Precision.HIGHEST``, so none runs in
TF32. Gates (dB of signal over error energy): 105 for the FFT
pipelines (spectrum, spectrogram, PFB, 1M FFT and every four-card
comparison), 100 for the filter chains (resampler, WBFM), as
BASELINE.json sets them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import pragma_dsp_tpu as pd
from pragma_dsp_tpu import models, ops, parallel, stream
from pragma_dsp_tpu.core import ComplexArray
from pragma_dsp_tpu.utils.compile_cache import enable_compile_cache
from pragma_dsp_tpu.utils.fixtures import fixtures_dir, load_json, snr_db

FS_AUDIO = 48000.0
FFT_GATE_DB = 105.0
FILTER_GATE_DB = 100.0


@dataclass
class Check:
    """One measured value against its gate (higher is better)."""

    phase: str
    entry: str
    shapes: str
    metric: str
    value: float
    gate: float
    compile_s: Optional[float] = None
    run_ms: Optional[float] = None

    @property
    def ok(self) -> bool:
        return bool(self.value >= self.gate)     # NaN fails

    def line(self) -> str:
        parts = [f"phase={self.phase}", f"entry={self.entry}",
                 f"shapes={self.shapes}", f"route={ops.fft_route()}"]
        if self.compile_s is not None:
            parts.append(f"compile_s={self.compile_s}")
        if self.run_ms is not None:
            parts.append(f"run_ms={self.run_ms}")
        parts += [f"{self.metric}={self.value}", f"gate>={self.gate}",
                  f"peak_bytes={peak_bytes()}",
                  "PASS" if self.ok else "FAIL"]
        return " ".join(parts)


def peak_bytes() -> Optional[int]:
    """Largest ``peak_bytes_in_use`` over the devices (None on a
    backend without memory stats)."""
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in jax.devices()]
    peaks = [p for p in peaks if p is not None]
    return max(peaks) if peaks else None


def compile_and_time(fn: Callable, *args, runs: int = 1):
    """jit ``fn``, compile it for ``args``, warm up once, then time
    ``runs`` steady calls. Returns (output, compile_s, median run_ms)."""
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return out, compile_s, float(np.median(times))


def f64(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float64)


def c128(xc: ComplexArray) -> np.ndarray:
    return f64(xc.real) + 1j * f64(xc.imag)


def shape_str(*arrays) -> str:
    return ",".join(f"[{'x'.join(map(str, a.shape))}]{a.dtype}"
                    for a in arrays)


# ── float64 oracles ──────────────────────────────────────────────────


def hann(n: int) -> np.ndarray:
    """Symmetric Hann, the library's window convention."""
    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / (n - 1))


def one_sided_amplitude(frames: np.ndarray, n: int) -> np.ndarray:
    """|rfft(frame * hann)| with the spectrum() one-sided scaling."""
    amp = np.abs(np.fft.rfft(frames * hann(n), axis=-1))
    scale = np.full(n // 2 + 1, 2.0 / n)
    scale[0] = scale[-1] = 1.0 / n
    return amp * scale


def frames_of(x: np.ndarray, n: int, hop: int) -> np.ndarray:
    count = 1 + (x.shape[-1] - n) // hop
    idx = np.arange(count)[:, None] * hop + np.arange(n)[None, :]
    return x[idx]


def pfb_window(seg: np.ndarray, taps: np.ndarray, channels: int
               ) -> np.ndarray:
    """Channels of ``rows`` frames from ``seg``, the stream samples of
    those frames preceded by the T-1 frames of branch history (zeros
    before the stream start): y[m] = FFT_p(sum_t h[tC+p] x[(m-t)C+p])."""
    c = channels
    t = -(-taps.shape[0] // c)
    hp = np.zeros(t * c)
    hp[:taps.shape[0]] = taps
    hp = hp.reshape(t, c)
    rows = seg.shape[0] // c - (t - 1)
    xb = seg.reshape(t - 1 + rows, c)
    v = sum(hp[k] * xb[t - 1 - k: t - 1 - k + rows] for k in range(t))
    return np.fft.fft(v, axis=-1)


def stream_segment(xr, xi, lo: int, hi: int) -> np.ndarray:
    """Samples [lo, hi) of a device stream as complex128, zero before 0."""
    pad = max(0, -lo)
    z = f64(xr[max(lo, 0):hi]) + 1j * f64(xi[max(lo, 0):hi])
    return np.concatenate([np.zeros(pad, complex), z])


def wbfm_oracle(z: np.ndarray, rx) -> np.ndarray:
    """The receiver chain in float64 SciPy: channel filter + decimate,
    discriminator, de-emphasis, audio resampler (same taps)."""
    from scipy.signal import lfilter, upfirdn as sp_upfirdn

    c = rx.config
    chan = sp_upfirdn(rx._chan_taps, z, 1, rx._decim1)
    prev = np.concatenate([[1.0 + 0.0j], chan[:-1]])
    dphi = np.angle(chan * np.conj(prev))
    xif = dphi * (c.if_rate / (2 * np.pi)) / c.deviation
    alpha = float(np.exp(-1.0 / (c.if_rate * c.deemphasis_tau)))
    yif = lfilter([1.0 - alpha], [1.0, -alpha], xif)
    return sp_upfirdn(rx._audio_taps, yif, rx._up, rx._down)


def audio_signal(length: int, seed: int) -> np.ndarray:
    """Sine + linear chirp + noise at 48 kHz, rounded to float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(length) / FS_AUDIO
    sig = (0.7 * np.sin(2 * np.pi * 997.0 * t)
           + 0.2 * np.sin(2 * np.pi * (4000.0 + 300.0 * t) * t)
           + 0.01 * rng.standard_normal(length))
    return sig.astype(np.float32)


def device_normal(seed: int, shape, sharding=None) -> jax.Array:
    """float32 N(0, 1) made on the device (laid out by ``sharding``)."""
    make = jax.jit(lambda k: jax.random.normal(k, shape, jnp.float32),
                   out_shardings=sharding)
    return jax.block_until_ready(make(jax.random.PRNGKey(seed)))


# ── one-card phases ──────────────────────────────────────────────────


def phase_spectrum(rows: int = 65536, n: int = 1024, seed: int = 0
                   ) -> List[Check]:
    """Config 1: pd.spectrum over [rows, n] frames of a bin-32 sine
    (1500 Hz at 48 kHz, random phase per row) plus noise."""
    def make(k):
        k1, k2 = jax.random.split(k)
        t = jnp.arange(n, dtype=jnp.float32) / FS_AUDIO
        ph = jax.random.uniform(k1, (rows, 1), jnp.float32) * 2 * np.pi
        return (0.8 * jnp.sin(2 * np.pi * 1500.0 * t + ph)
                + 0.01 * jax.random.normal(k2, (rows, n), jnp.float32))

    x = jax.block_until_ready(jax.jit(make)(jax.random.PRNGKey(seed)))
    r, comp, run = compile_and_time(
        lambda v: pd.spectrum(v, sample_rate=FS_AUDIO, window="hann"), x)
    shapes = shape_str(x)
    on_bin = float(jnp.mean((r.peak.index == 32).astype(jnp.float32)))
    sub = min(rows, 64)
    ref = one_sided_amplitude(f64(x[:sub]), n)
    return [Check("spectrum", "pd.spectrum", shapes, "snr_db",
                  snr_db(ref, r.amplitude[:sub]), FFT_GATE_DB, comp, run),
            Check("spectrum", "pd.spectrum", shapes, "rows_peak_bin32",
                  on_bin, 1.0)]


def phase_spectrogram(length: int = 480000, n_fft: int = 4096,
                      hop: int = 1024, seed: int = 0) -> List[Check]:
    """Config 2: 10 s of 48 kHz audio, 4096-point frames, 75% overlap."""
    sig = audio_signal(length, seed)
    x = jnp.asarray(sig)
    ref = one_sided_amplitude(frames_of(f64(sig), n_fft, hop), n_fft)
    amp, comp, run = compile_and_time(
        lambda v: stream.spectrogram_amplitude(v, n_fft, hop, "hann"), x)
    full, comp2, run2 = compile_and_time(
        lambda v: stream.spectrogram(v, n_fft, hop, "hann", FS_AUDIO), x)
    shapes = shape_str(x)
    return [Check("spectrogram", "stream.spectrogram_amplitude", shapes,
                  "snr_db", snr_db(ref, amp), FFT_GATE_DB, comp, run),
            Check("spectrogram", "stream.spectrogram", shapes, "snr_db",
                  snr_db(ref, full.amplitude), FFT_GATE_DB, comp2, run2)]


def phase_resample(length: int = 480000, seed: int = 0) -> List[Check]:
    """Config 3: 48 kHz -> 44.1 kHz (147/160), 127 taps: the committed
    SciPy fixture cases through ops.upfirdn, and 10 s of audio through
    ops.resample_poly against scipy.signal.upfirdn with the same taps."""
    from scipy.signal import upfirdn as sp_upfirdn

    cases = load_json(os.path.join(fixtures_dir(), "dsp", "resampler.json"))
    fixture_snr = min(
        snr_db(c["output"], ops.upfirdn(jnp.asarray(c["input"], jnp.float32),
                                        np.asarray(c["taps"]), c["up"],
                                        c["down"]))
        for c in cases["cases"])
    sig = audio_signal(length, seed)
    x = jnp.asarray(sig)
    y, comp, run = compile_and_time(lambda v: ops.resample_poly(v, 147, 160),
                                    x)
    ref = sp_upfirdn(ops.resampler_taps(147, 160, 127), f64(sig), 147, 160)
    return [Check("resample", "ops.upfirdn", "fixture cases", "snr_db",
                  fixture_snr, FILTER_GATE_DB),
            Check("resample", "ops.resample_poly", shape_str(x), "snr_db",
                  snr_db(ref, y), FILTER_GATE_DB, comp, run)]


def phase_wbfm(length: int = 2_400_000, chunks: int = 8, seed: int = 0
               ) -> List[Check]:
    """Config 4: 1 s of 2.4 Msps broadcast-FM IQ through
    models.wbfm_demod, then through the receiver's streaming step in
    ``chunks`` chunks; the streamed audio must equal the batch prefix."""
    del seed                        # the message is deterministic
    fs_iq = 2.4e6
    t = np.arange(length) / fs_iq
    msg = (0.7 * np.sin(2 * np.pi * 1000.0 * t)
           + 0.2 * np.sin(2 * np.pi * 4000.0 * t))
    z = np.exp(1j * (0.5 + 2 * np.pi * 75e3 * np.cumsum(msg) / fs_iq))
    iq = ComplexArray(jnp.asarray(z.real, jnp.float32),
                      jnp.asarray(z.imag, jnp.float32))
    audio, comp, run = compile_and_time(models.wbfm_demod, iq)
    rx = models.FmReceiver()
    ref = wbfm_oracle(c128(iq), rx)
    m = min(ref.shape[0], audio.shape[-1])

    step = stream.jit_stream_step(rx.stream_step)
    size = length // chunks
    parts = [ComplexArray(iq.real[i * size:(i + 1) * size],
                          iq.imag[i * size:(i + 1) * size])
             for i in range(chunks)]
    state = rx.stream_init(dtype=jnp.float32)
    t0 = time.perf_counter()
    compiled = step.lower(state, parts[0]).compile()
    step_compile_s = time.perf_counter() - t0
    outs, step_ms = [], []
    for part in parts:
        t0 = time.perf_counter()
        state, out = jax.block_until_ready(compiled(state, part))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(f64(out))
    streamed = np.concatenate(outs)
    step_run_ms = float(np.median(step_ms[1:] or step_ms))  # warm steps
    shapes = shape_str(iq.real, iq.imag)
    return [Check("wbfm", "models.wbfm_demod", shapes, "snr_db",
                  snr_db(ref[:m], audio[:m]), FILTER_GATE_DB, comp, run),
            Check("wbfm", f"FmReceiver.stream_step x{chunks}",
                  shape_str(parts[0].real), "snr_db_vs_batch",
                  snr_db(f64(audio[:streamed.shape[0]]), streamed),
                  FILTER_GATE_DB, step_compile_s, step_run_ms)]


def phase_pfb(length: int = 1 << 24, channels: int = 256,
              taps_per_branch: int = 8, seed: int = 0) -> List[Check]:
    """Config 5: 256-channel PFB, 8 taps per branch, on 2^24 complex
    samples through the flat and the frames entry; checked on the first
    and the last rows of frames against the float64 oracle."""
    planes = device_normal(seed, (2, length))
    xr, xi = planes[0], planes[1]
    c = channels
    taps = ops.pfb_taps(c, taps_per_branch)
    m = length // c
    rows = min(m, 2048)
    t = taps_per_branch

    def oracle(m0):
        seg = stream_segment(xr, xi, (m0 - t + 1) * c, (m0 + rows) * c)
        return pfb_window(seg, taps, c)

    refs = [(m0, oracle(m0)) for m0 in sorted({0, m - rows})]
    flat, comp, run = compile_and_time(
        lambda a, b: ops.pfb_channelize(ComplexArray(a, b), c), xr, xi)
    frames, comp2, run2 = compile_and_time(
        lambda a, b: ops.pfb_channelize_frames(
            ComplexArray(a.reshape(m, c), b.reshape(m, c)), c), xr, xi)

    def worst(y):
        return min(snr_db(ref, c128(ComplexArray(y.real[m0:m0 + rows],
                                                 y.imag[m0:m0 + rows])))
                   for m0, ref in refs)

    shapes = shape_str(xr, xi)
    return [Check("pfb", "ops.pfb_channelize", shapes, "snr_db",
                  worst(flat), FFT_GATE_DB, comp, run),
            Check("pfb", "ops.pfb_channelize_frames", shapes, "snr_db",
                  worst(frames), FFT_GATE_DB, comp2, run2)]


def phase_fft1m(batch: int = 16, n: int = 1 << 20, seed: int = 0
                ) -> List[Check]:
    """The 1M-point FFT: ops.fft over [batch, n] complex planes against
    np.fft.fft, and ops.ifft(ops.fft(x)) against x."""
    planes = device_normal(seed, (2, batch, n))
    xr, xi = planes[0], planes[1]
    spec, comp, run = compile_and_time(
        lambda a, b: ops.fft(ComplexArray(a, b)), xr, xi)
    back, comp2, run2 = compile_and_time(
        lambda a, b: ops.ifft(ops.fft(ComplexArray(a, b))), xr, xi)
    z = c128(ComplexArray(xr, xi))
    shapes = shape_str(xr, xi)
    return [Check("fft1m", "ops.fft", shapes, "snr_db",
                  snr_db(np.fft.fft(z, axis=-1), c128(spec)), FFT_GATE_DB,
                  comp, run),
            Check("fft1m", "ops.ifft(ops.fft)", shapes, "snr_db",
                  snr_db(z, c128(back)), FFT_GATE_DB, comp2, run2)]


ONE_CARD_PHASES = (phase_spectrum, phase_spectrogram, phase_resample,
                   phase_wbfm, phase_pfb, phase_fft1m)


# ── four-card phases ─────────────────────────────────────────────────


def spread_check(phase: str, entry: str, arr, d: int) -> Check:
    """How many distinct devices hold a shard of ``arr``."""
    devs = {s.device for s in arr.addressable_shards}
    return Check(phase, entry, shape_str(arr), "devices_holding_shards",
                 float(len(devs)), float(d))


def phase_sharded_pfb(mesh, per_card: int = 1 << 24, channels: int = 256,
                      taps_per_branch: int = 8, n_fft: int = 128,
                      seed: int = 0) -> List[Check]:
    """Config 5 sharded: sharded_pfb_channelize (channels sharded out
    by the all_to_all corner turn) against the float64 oracle at every
    shard boundary, and sharded_channel_power against the same Welch
    power computed on one card."""
    d = mesh.devices.size
    length = d * per_card
    c = channels
    m = length // c
    planes = device_normal(seed, (2, length),
                           NamedSharding(mesh, P(None, "x")))
    xr, xi = planes[0], planes[1]
    t = taps_per_branch
    taps = ops.pfb_taps(c, t)
    y, comp, run = compile_and_time(
        lambda a, b: parallel.sharded_pfb_channelize(
            ComplexArray(a, b), c, mesh=mesh), xr, xi)
    rows = min(m // d, 512)
    snrs = []
    for k in range(d):
        m0 = max(0, k * (m // d) - rows // 2)
        seg = stream_segment(xr, xi, (m0 - t + 1) * c, (m0 + rows) * c)
        got = ComplexArray(y.real[m0:m0 + rows], y.imag[m0:m0 + rows])
        snrs.append(snr_db(pfb_window(seg, taps, c), c128(got)))
    checks = [Check("sharded_pfb", "parallel.sharded_pfb_channelize",
                    shape_str(xr, xi), "snr_db", min(snrs), FFT_GATE_DB,
                    comp, run),
              spread_check("sharded_pfb", "parallel.sharded_pfb_channelize",
                           y.real, d)]

    frame_sh = NamedSharding(mesh, P("x", None))
    fr = jax.device_put(xr.reshape(m, c), frame_sh)
    fi = jax.device_put(xi.reshape(m, c), frame_sh)
    power, comp, run = compile_and_time(
        lambda a, b: parallel.sharded_channel_power(
            ComplexArray(a, b), c, mesh=mesh, n_fft=n_fft), fr, fi)

    def one_card(a, b):
        ych = ops.pfb_channelize_frames(ComplexArray(a, b), c)
        w = jnp.asarray(hann(n_fft), jnp.float32)[:, None]
        zc = jax.lax.complex(ych.real, ych.imag).reshape(m // n_fft, n_fft, c)
        seg = jnp.fft.fft(zc * w, axis=1)
        return jnp.mean(jnp.abs(seg) ** 2, axis=0) / (n_fft * jnp.sum(w ** 2))

    dev0 = jax.devices()[0]
    ref = jax.jit(one_card)(jax.device_put(fr, dev0), jax.device_put(fi, dev0))
    checks.append(Check("sharded_pfb", "parallel.sharded_channel_power",
                        shape_str(fr, fi), "snr_db_vs_one_card",
                        snr_db(ref, power), FFT_GATE_DB, comp, run))
    return checks


def phase_dist_fft(mesh, n2: int = 8192, n1: int = 8192,
                   chunk_counts=(1, 2, 4, 8), seed: int = 0) -> List[Check]:
    """dist_fft / dist_ifft of one N = n2*n1 signal against ops.fft of
    the whole signal on one card, at every corner-turn chunk count."""
    d = mesh.devices.size
    planes = device_normal(seed, (2, n2, n1),
                           NamedSharding(mesh, P(None, None, "x")))
    xr, xi = planes[0], planes[1]
    dev0 = jax.devices()[0]

    def natural_to_permuted(a, b):
        spec = ops.fft(ComplexArray(a.reshape(-1), b.reshape(-1)))
        return spec.real.reshape(n1, n2).T, spec.imag.reshape(n1, n2).T

    ref = jax.jit(natural_to_permuted)(jax.device_put(xr, dev0),
                                       jax.device_put(xi, dev0))
    ref_c = c128(ComplexArray(*ref))
    x_c = c128(ComplexArray(xr, xi))
    shapes = shape_str(xr, xi)
    checks = []
    for ch in chunk_counts:
        if (n2 // d) % ch or (n1 // d) % ch:
            continue
        fwd, comp, run = compile_and_time(
            lambda a, b: parallel.dist_fft(ComplexArray(a, b), mesh,
                                           chunks=ch), xr, xi, runs=5)
        back, comp2, run2 = compile_and_time(
            lambda a, b: parallel.dist_ifft(ComplexArray(a, b), mesh,
                                            chunks=ch), fwd.real, fwd.imag,
            runs=5)
        checks += [Check("dist_fft", f"parallel.dist_fft chunks={ch}",
                         shapes, "snr_db_vs_one_card",
                         snr_db(ref_c, c128(fwd)), FFT_GATE_DB, comp, run),
                   Check("dist_fft", f"parallel.dist_ifft chunks={ch}",
                         shapes, "snr_db_roundtrip",
                         snr_db(x_c, c128(back)), FFT_GATE_DB, comp2, run2)]
    checks.append(spread_check("dist_fft", "parallel.dist_fft", fwd.real, d))
    return checks


def phase_sharded_fir(mesh, length: int = 1 << 26, num_taps: int = 127,
                      seed: int = 0) -> List[Check]:
    """sharded_fir_filter (ppermute halos) against np.convolve in
    float64 on windows across every shard boundary."""
    d = mesh.devices.size
    x = device_normal(seed, (length,), NamedSharding(mesh, P("x")))
    taps = ops.design_lowpass(num_taps, 0.2)
    y, comp, run = compile_and_time(
        lambda v: parallel.sharded_fir_filter(v, taps, mesh), x)
    win = min(length // d, 4096)
    snrs = []
    for k in range(d):
        a = max(0, k * (length // d) - win // 2)
        lo = a - (num_taps - 1)
        seg = f64(x[max(lo, 0):a + win])
        seg = np.concatenate([np.zeros(max(0, -lo)), seg])
        ref = np.convolve(seg, taps, mode="valid")
        snrs.append(snr_db(ref, y[a:a + win]))
    return [Check("sharded_fir", "parallel.sharded_fir_filter", shape_str(x),
                  "snr_db", min(snrs), FFT_GATE_DB, comp, run),
            spread_check("sharded_fir", "parallel.sharded_fir_filter", y, d)]


def phase_sharded_spectrogram(mesh, frames_per_card: int = 469,
                              n_fft: int = 4096, hop: int = 1024,
                              seed: int = 0) -> List[Check]:
    """Config-2 shapes over d times the audio (each card a whole number
    of hops: 469 * 1024 samples, 10.005 s), against the float64 oracle."""
    d = mesh.devices.size
    sig = audio_signal(d * frames_per_card * hop, seed)
    x = jax.device_put(jnp.asarray(sig), NamedSharding(mesh, P("x")))
    r, comp, run = compile_and_time(
        lambda v: parallel.sharded_spectrogram(
            v, n_fft, hop, "hann", FS_AUDIO, mesh=mesh), x)
    ref = one_sided_amplitude(frames_of(f64(sig), n_fft, hop), n_fft)
    return [Check("sharded_spectrogram", "parallel.sharded_spectrogram",
                  shape_str(x), "snr_db", snr_db(ref, r.amplitude),
                  FFT_GATE_DB, comp, run),
            spread_check("sharded_spectrogram",
                         "parallel.sharded_spectrogram", r.amplitude, d)]


FOUR_CARD_PHASES = (phase_sharded_pfb, phase_dist_fft, phase_sharded_fir,
                    phase_sharded_spectrogram)


# ── driver ───────────────────────────────────────────────────────────


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return "; ".join(s.strip() for s in out.strip().splitlines())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4 runs the sharded phases on a 4-card mesh only")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 2
    if len(jax.devices()) < args.cards:
        print(f"chip_smoke: --cards {args.cards} needs {args.cards} "
              f"devices, JAX found {len(jax.devices())}", file=sys.stderr)
        return 2
    enable_compile_cache()
    print(f"card: {card_line()} | jax {jax.__version__}", flush=True)

    if args.cards == 1:
        phases = [lambda f=f: f(seed=args.seed) for f in ONE_CARD_PHASES]
        names = [f.__name__ for f in ONE_CARD_PHASES]
    else:
        mesh = parallel.data_mesh(args.cards)
        print(f"mesh: {dict(mesh.shape)} over devices "
              f"{[dv.id for dv in mesh.devices.flat]}", flush=True)
        phases = [lambda f=f: f(mesh, seed=args.seed)
                  for f in FOUR_CARD_PHASES]
        names = [f.__name__ for f in FOUR_CARD_PHASES]

    failed = []
    for name, run in zip(names, phases):
        t0 = time.perf_counter()
        try:
            checks = run()
        except Exception:
            traceback.print_exc()
            print(f"phase={name} ERROR", flush=True)
            failed.append(name)
            continue
        for c in checks:
            print(c.line(), flush=True)
            if not c.ok:
                failed.append(f"{c.phase}:{c.entry}:{c.metric}")
        print(f"phase={name} wall_s={time.perf_counter() - t0}", flush=True)

    if failed:
        print(f"chip_smoke: FAILED {failed}", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
