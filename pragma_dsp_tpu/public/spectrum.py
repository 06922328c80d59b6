"""Beginner rung: one-call ``spectrum()`` — batched, jit-friendly.

Parity with reference src/public/spectrum.ts:15-142, including its exact
amplitude-scaling and peak-detection semantics:

* one-sided scaling: DC and Nyquist divided by N, every other bin times 2/N
  (spectrum.ts:45-61); two-sided: all bins divided by N (spectrum.ts:63-72).
* one-sided phase is a plain slice of bins [0 .. N/2] (spectrum.ts:129-131).
* peak rule (spectrum.ts:74-105): if ANY non-DC amplitude bin is > 0, the
  peak is the first-argmax over bins[1:]; otherwise the global first-argmax
  (which then includes DC). ``peak.phase`` is backfilled from the phase
  array at the peak index (spectrum.ts:134).

Unlike the reference, input may carry arbitrary leading batch dims; the
result's per-bin arrays and peak fields then carry those batch dims too.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from ..core.complex import Array, next_power_of_two
from ..ops.dispatch import fft as _fft
from ..xform.fourier import (
    apply_window,
    bin_frequencies,
    create_window,
    magnitude,
    phase as phase_fn,
)

__all__ = [
    "SpectrumPeak",
    "SpectrumResult",
    "spectrum",
    "build_frame",
    "scale_amplitude_one_sided",
    "scale_amplitude_two_sided",
    "find_peak",
]


class SpectrumPeak(NamedTuple):
    index: Array
    frequency: Array
    amplitude: Array
    phase: Array


class SpectrumResult(NamedTuple):
    frequencies: Array
    amplitude: Array
    phase: Array
    peak: SpectrumPeak


def build_frame(samples: Array, size: int) -> Array:
    """Zero-pad or truncate the last axis to ``size`` (spectrum.ts:36-43)."""
    samples = jnp.asarray(samples)
    n = samples.shape[-1]
    if n == size:
        return samples
    if n > size:
        return samples[..., :size]
    pad = [(0, 0)] * (samples.ndim - 1) + [(0, size - n)]
    return jnp.pad(samples, pad)


def scale_amplitude_one_sided(magnitudes: Array, size: int) -> Array:
    """DC and Nyquist /N, others *2/N, over bins [0..N/2] (spectrum.ts:45-61)."""
    bin_count = size // 2 + 1
    mags = magnitudes[..., :bin_count]
    k = np.arange(bin_count)
    nyquist = size // 2 if size % 2 == 0 else -1
    factor = np.where((k == 0) | (k == nyquist), 1.0 / size, 2.0 / size)
    return mags * jnp.asarray(factor, dtype=mags.dtype)


def scale_amplitude_two_sided(magnitudes: Array, size: int) -> Array:
    """All N bins divided by N (spectrum.ts:63-72)."""
    return magnitudes * jnp.asarray(1.0 / size, dtype=magnitudes.dtype)


def find_peak(amplitude: Array, frequencies: Array) -> SpectrumPeak:
    """Vectorised replica of the reference's findPeak loop (spectrum.ts:74-105).

    The loop keeps a running argmax over non-DC bins (first index wins on
    ties via strict >) and a flag for "any non-DC bin > 0"; the global
    argmax (DC included) is only used when every non-DC bin is <= 0.
    """
    non_dc = amplitude[..., 1:]
    has_non_dc = jnp.any(non_dc > 0, axis=-1)
    non_dc_index = 1 + jnp.argmax(non_dc, axis=-1)
    global_index = jnp.argmax(amplitude, axis=-1)
    index = jnp.where(has_non_dc, non_dc_index, global_index)
    peak_amp = jnp.take_along_axis(amplitude, index[..., None], axis=-1)[..., 0]
    freq = jnp.asarray(frequencies, dtype=amplitude.dtype)[index]
    return SpectrumPeak(index=index, frequency=freq, amplitude=peak_amp,
                        phase=jnp.zeros_like(peak_amp))


def spectrum(
    samples,
    *,
    sample_rate: float = 1.0,
    fft_size: Optional[int] = None,
    window: str = "rect",
    sides: str = "one",
) -> SpectrumResult:
    """One-call spectrum pipeline (reference spectrum.ts:107-142).

    Defaults match the reference: sample_rate=1, sides="one", window="rect",
    fft_size=next_power_of_two(len). Accepts [n] or [batch..., n] input.
    """
    samples = jnp.asarray(samples)
    if jnp.issubdtype(samples.dtype, jnp.complexfloating):
        # The beginner rung takes REAL samples (reference
        # spectrum.ts:107: samples is a real Float32Array/number[]); a
        # complex array would silently lose its imaginary part in the
        # real cast below. Complex spectra go through ops.fft /
        # xform.fourier directly.
        raise TypeError(
            f"spectrum() takes real samples, got {samples.dtype}; for "
            "complex input use ops.fft + xform.fourier.magnitude/phase")
    if samples.dtype not in (jnp.float32, jnp.float64):
        # bf16 (and int) input upcasts to f32: the bf16 mantissa is
        # preserved exactly and computing the pipeline IN bf16 would only
        # lose precision (pinned by
        # tests/test_spectrum.py::test_bf16_input_rides_f32_pipeline).
        samples = samples.astype(jnp.float32)
    target_size = fft_size if fft_size is not None else next_power_of_two(samples.shape[-1])

    win = create_window(window, target_size, dtype=samples.dtype)
    frame = build_frame(samples, target_size)
    windowed = apply_window(frame, win)
    spec = _fft(windowed)
    mags = magnitude(spec)
    angs = phase_fn(spec)

    if sides == "one":
        amplitude = scale_amplitude_one_sided(mags, target_size)
        phase_bins = angs[..., : target_size // 2 + 1]
    else:
        amplitude = scale_amplitude_two_sided(mags, target_size)
        phase_bins = angs
    frequencies = bin_frequencies(target_size, sample_rate, sides, dtype=samples.dtype)
    peak = find_peak(amplitude, frequencies)
    peak_phase = jnp.take_along_axis(phase_bins, peak.index[..., None], axis=-1)[..., 0]
    peak = peak._replace(phase=peak_phase)
    return SpectrumResult(frequencies=frequencies, amplitude=amplitude,
                          phase=phase_bins, peak=peak)
