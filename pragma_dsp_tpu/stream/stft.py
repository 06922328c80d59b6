"""Batched STFT / spectrogram + jit-friendly chunked streaming state.

This is the batched replacement for the reference's per-frame
``spectrumStream`` (src/effect/index.ts:190-194): instead of mapping an
effectful function over a stream of frames, the signal is framed into a
[frames, n_fft] batch and the whole spectrogram is one fused jitted
computation (BASELINE.json config 2: 4096-pt FFT, 75% overlap).

Streaming chunked input is supported with an explicit carry pytree
(``StftState``) threaded through ``stft_step`` — the lax.scan-compatible
formulation of overlap between chunk boundaries (SURVEY.md §5
"checkpoint/resume": streaming state as explicit pytree).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.complex import Array, ComplexArray, ensure_float
from ..ops.dispatch import fft as _fft
from ..public.spectrum import (
    SpectrumResult,
    find_peak,
    scale_amplitude_one_sided,
    scale_amplitude_two_sided,
)
from ..xform.fourier import (bin_frequencies, create_window,
                             magnitude, phase, window_values)

__all__ = ["frame_signal", "stft", "istft", "spectrogram", "StftState",
           "stft_stream_init", "stft_step", "welch_psd"]


def frame_signal(x: Array, frame_size: int, hop: int) -> Array:
    """Slice [..., L] into overlapping [..., F, frame_size] frames.

    F = 1 + (L - frame_size) // hop; trailing samples that don't fill a
    frame are dropped (streaming carries them instead, see stft_step).
    """
    x = jnp.asarray(x)
    length = x.shape[-1]
    if length < frame_size:
        raise ValueError(f"signal length {length} < frame_size {frame_size}")
    n_frames = 1 + (length - frame_size) // hop
    # Reshape to hop-sized rows and concatenate T row-shifted views —
    # frame i is rows i..i+T-1 truncated to frame_size (T slices instead
    # of a [F, frame_size] index gather).
    t_rows = -(-frame_size // hop)
    total = (n_frames + t_rows) * hop
    pad = [(0, 0)] * (x.ndim - 1) + [(0, total - length)]
    rows = jnp.pad(x, pad).reshape(x.shape[:-1] + (n_frames + t_rows, hop))
    frames = jnp.concatenate(
        [rows[..., t: t + n_frames, :] for t in range(t_rows)],
        axis=-1)[..., :frame_size]
    return frames


def stft(x: Array, n_fft: int, hop: Optional[int] = None,
         window: str = "hann") -> ComplexArray:
    """Short-time Fourier transform: [..., L] -> complex [..., F, n_fft].

    Forward-unnormalised per frame (numpy convention), window applied
    before the FFT. hop defaults to n_fft//4 (75% overlap, config 2).
    """
    hop = hop if hop is not None else n_fft // 4
    # int input would poison the window/FFT dtypes downstream
    frames = frame_signal(ensure_float(x), n_fft, hop)
    win = create_window(window, n_fft, dtype=frames.dtype)
    return _fft(frames * win)


def istft(spec: ComplexArray, hop: int, window: str = "hann",
          length: Optional[int] = None) -> Array:
    """Overlap-add inverse STFT with window-square normalisation (WOLA).

    Reconstructs a real signal from [..., F, n_fft] produced by
    :func:`stft` with the same hop and window.
    """
    from ..ops.dispatch import ifft as _ifft

    n_fft = spec.real.shape[-1]
    n_frames = spec.real.shape[-2]
    frames = _ifft(spec).real
    win = create_window(window, n_fft, dtype=frames.dtype)
    frames = frames * win
    out_len = (n_frames - 1) * hop + n_fft

    # Overlap-add without a scatter: split each frame into hop-sized
    # chunks; chunk t of frame f lands at row f+t of the output row
    # grid, so the whole OLA is T row-shifted pads + adds. The
    # window-energy normaliser is static -> computed in numpy.
    batch_shape = frames.shape[:-2]
    t_rows = -(-n_fft // hop)
    padded_cols = t_rows * hop
    fpad = [(0, 0)] * (frames.ndim - 1) + [(0, padded_cols - n_fft)]
    chunks = jnp.pad(frames, fpad).reshape(
        batch_shape + (n_frames, t_rows, hop))
    total_rows = n_frames + t_rows - 1
    acc = jnp.zeros(batch_shape + (total_rows, hop), dtype=frames.dtype)
    for t in range(t_rows):
        acc = acc.at[..., t: t + n_frames, :].add(chunks[..., :, t, :])
    sig = acc.reshape(batch_shape + (total_rows * hop,))[..., :out_len]
    wnp = np.zeros(out_len)
    wsq_np = window_values(window, n_fft).astype(np.float64) ** 2
    for f in range(n_frames):
        wnp[f * hop: f * hop + n_fft] += wsq_np
    wsq = jnp.asarray(np.maximum(wnp, np.finfo(np.float32).tiny),
                      dtype=frames.dtype)
    sig = sig / wsq
    if length is not None:
        sig = sig[..., :length]
    return sig


def _scale(mags: Array, n_fft: int, sides: str) -> Array:
    if sides == "one":
        return scale_amplitude_one_sided(mags, n_fft)
    return scale_amplitude_two_sided(mags, n_fft)


def spectrogram_amplitude(x: Array, n_fft: int, hop: Optional[int] = None,
                          window: str = "hann", sides: str = "one") -> Array:
    """Amplitude-only spectrogram: framing -> window -> FFT -> |X| ->
    scaling, skipping the phase and peak bookkeeping of
    :func:`spectrogram` (waterfalls, detectors). Scaling matches
    spectrum() exactly. Returns [..., F, bins]."""
    hop = hop if hop is not None else n_fft // 4
    return _scale(magnitude(stft(x, n_fft, hop, window)), n_fft, sides)


def spectrogram(x: Array, n_fft: int, hop: Optional[int] = None,
                window: str = "hann", sample_rate: float = 1.0,
                sides: str = "one") -> SpectrumResult:
    """Spectrum-per-frame with the exact beginner-rung scaling and peak
    rules applied to every frame (batched spectrum over the frame axis).
    For magnitude-only workloads prefer :func:`spectrogram_amplitude`."""
    hop = hop if hop is not None else n_fft // 4
    spec = stft(x, n_fft, hop, window)
    amplitude = _scale(magnitude(spec), n_fft, sides)
    phase_bins = phase(spec)
    if sides == "one":
        phase_bins = phase_bins[..., : n_fft // 2 + 1]
    freqs = bin_frequencies(n_fft, sample_rate, sides, dtype=amplitude.dtype)
    peak = find_peak(amplitude, freqs)
    peak_phase = jnp.take_along_axis(phase_bins, peak.index[..., None],
                                     axis=-1)[..., 0]
    peak = peak._replace(phase=peak_phase)
    return SpectrumResult(frequencies=freqs, amplitude=amplitude,
                          phase=phase_bins, peak=peak)


class StftState(NamedTuple):
    """Carry between streaming chunks: the last n_fft - hop input samples."""

    tail: Array


def welch_psd(x, n_fft: int, hop: Optional[int] = None,
              window: str = "hann", fs: float = 1.0) -> Array:
    """Two-sided Welch power spectral density over the last axis.

    Segments of ``n_fft`` samples at stride ``hop`` (default: no
    overlap), windowed (sym=True formulas, the framework convention),
    FFT'd, magnitude-squared, and averaged:

        P[k] = mean_seg |FFT_k(w * x_seg)|^2 / (fs * sum(w^2))

    — scipy.signal.welch(fs=fs, noverlap=n_fft-hop, detrend=False,
    return_onesided=False, scaling='density') with the same window
    values. Real or complex (split-plane / jnp.complex*) input; the
    two-sided convention keeps one formula for both (SDR IQ is the
    common case). The per-channel sharded variant is
    ``parallel.sharded_channel_power``.
    """
    hop = hop if hop is not None else n_fft
    from ..core.complex import as_complex_array

    xc = as_complex_array(x)
    fr = frame_signal(xc.real, n_fft, hop)
    fi = frame_signal(xc.imag, n_fft, hop)
    w = create_window(window, n_fft, dtype=fr.dtype)
    spec = _fft(ComplexArray(fr * w, fi * w))
    p = spec.real * spec.real + spec.imag * spec.imag
    scale = float(fs) * float(np.sum(
        np.asarray(window_values(window, n_fft), np.float64) ** 2))
    return jnp.mean(p, axis=-2) / scale


def stft_stream_init(n_fft: int, hop: int, batch_shape: Tuple[int, ...] = (),
                     dtype=jnp.float32) -> StftState:
    """Zero state. First emitted frames treat the signal as zero-padded
    history, matching a cold stream start."""
    return StftState(tail=jnp.zeros(batch_shape + (n_fft - hop,), dtype=dtype))


def stft_step(state: StftState, chunk: Array, n_fft: int, hop: int,
              window: str = "hann") -> Tuple[StftState, ComplexArray]:
    """Process one chunk; returns (new_state, complex frames).

    ``chunk`` length must be a static multiple of ``hop`` so the carry
    keeps a fixed shape (jit/scan compatible). Equivalent to running
    :func:`stft` over the concatenated stream: frames never straddle a
    chunk boundary unseen — the carry supplies the n_fft - hop overlap.
    """
    chunk = jnp.asarray(chunk)
    if chunk.shape[-1] % hop != 0:
        raise ValueError(
            f"chunk length {chunk.shape[-1]} must be a multiple of hop {hop}")
    buf = jnp.concatenate([state.tail, chunk], axis=-1)
    spec = stft(buf, n_fft, hop, window)
    new_tail = buf[..., buf.shape[-1] - (n_fft - hop):]
    return StftState(tail=new_tail), spec
