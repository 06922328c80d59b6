"""Power-rung Fourier surface: windows, projections, shifts, frequency axes.

Parity with reference src/xform/fourier.ts:11-165. Window values are
computed in float64 with numpy at trace time (sizes are static) and cast to
the compute dtype — this matches the reference/scipy ``sym=True`` formulas
bit-for-bit in f64 and gives correctly-rounded f32 constants.
"""

from __future__ import annotations

from typing import Literal, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.complex import Array, ComplexArray, as_complex_array, is_power_of_two
from ..core.fft import Radix2Fft

WindowType = Literal["rect", "hann", "hamming", "blackman"]
FftSides = Literal["one", "two"]

__all__ = [
    "WindowType",
    "FftSides",
    "create_window",
    "apply_window",
    "FFT",
    "magnitude",
    "phase",
    "fft_shift",
    "fft_shift_complex",
    "bin_frequencies",
]


def window_values(window_type: str, size: int) -> np.ndarray:
    """Symmetric (``sym=True``) window as a float64 numpy array.

    Formulas match reference src/xform/fourier.ts:14-52 and scipy's
    symmetric windows (denominator N-1); size 1 returns [1].
    """
    if size <= 0:
        raise ValueError(f"Window size must be positive, got {size}")
    if size == 1:
        return np.ones(1, dtype=np.float64)
    i = np.arange(size, dtype=np.float64)
    f = 2.0 * np.pi * i / (size - 1)
    if window_type == "rect":
        return np.ones(size, dtype=np.float64)
    if window_type == "hann":
        return 0.5 * (1.0 - np.cos(f))
    if window_type == "hamming":
        return 0.54 - 0.46 * np.cos(f)
    if window_type == "blackman":
        return 0.42 - 0.5 * np.cos(f) + 0.08 * np.cos(2.0 * f)
    raise ValueError(f"Unsupported window type: {window_type}")


def create_window(window_type: str, size: int, dtype=jnp.float32) -> Array:
    """Window function on device (reference createWindow, fourier.ts:14-52)."""
    return jnp.asarray(window_values(window_type, size), dtype=dtype)


def apply_window(x: Array, window: Array) -> Array:
    """Element-wise window multiply over the last axis (fourier.ts:54-67)."""
    x = jnp.asarray(x)
    window = jnp.asarray(window, dtype=x.dtype)
    if x.shape[-1] != window.shape[-1]:
        raise ValueError("Window length must match input length.")
    return x * window


class FFT:
    """Power-rung FFT facade (reference fourier.ts:69-96): re-validates
    power-of-two size and offers a complex-array factory."""

    def __init__(self, size: int):
        if not is_power_of_two(size):
            raise ValueError(f"FFT size must be power of two, got {size}")
        self.size = size
        self._kernel = Radix2Fft(size)

    def forward(self, x) -> ComplexArray:
        return self._kernel.forward(x)

    def forward_complex(self, x) -> ComplexArray:
        return self._kernel.forward_complex(x)

    def inverse(self, x) -> ComplexArray:
        return self._kernel.inverse(x)

    def create_complex_array(self, fill: float = 0.0, dtype=jnp.float32) -> ComplexArray:
        from ..core.complex import create_complex_array

        return create_complex_array(self.size, fill, dtype=dtype)


def magnitude(x: ComplexArray) -> Array:
    """Per-bin |X| with hypot semantics (reference fourier.ts:98-109)."""
    xc = as_complex_array(x)
    return jnp.hypot(xc.real, xc.imag)


def phase(x: ComplexArray) -> Array:
    """Per-bin arg(X) via atan2 (reference fourier.ts:111-120)."""
    xc = as_complex_array(x)
    return jnp.arctan2(xc.imag, xc.real)


def fft_shift(x: Array, axis: int = -1) -> Array:
    """Circular rotation by floor(N/2) (reference fourier.ts:122-133).

    The reference writes result[i] = input[(i + N//2) % N], i.e. a LEFT
    roll by N//2 — equivalent to numpy.fft.fftshift for even N and to
    ifftshift-style indexing for odd N; we reproduce the reference exactly.
    """
    x = jnp.asarray(x)
    n = x.shape[axis]
    return jnp.roll(x, -(n // 2), axis=axis)


def fft_shift_complex(x: ComplexArray, axis: int = -1) -> ComplexArray:
    """fft_shift applied to both planes (reference fourier.ts:135-145)."""
    xc = as_complex_array(x)
    return ComplexArray(fft_shift(xc.real, axis), fft_shift(xc.imag, axis))


def coherent_gain(window_type: str, size: int) -> float:
    """Window coherent gain sum(w)/N (reference windows_dsp reference data,
    scripts/gen_reallife_refs.py ENBW/CG block)."""
    w = window_values(window_type, size)
    return float(np.sum(w) / size)


def enbw(window_type: str, size: int) -> float:
    """Equivalent noise bandwidth N*sum(w^2)/sum(w)^2 in bins."""
    w = window_values(window_type, size)
    return float(size * np.sum(w * w) / np.sum(w) ** 2)


def bin_frequencies(size: int, sample_rate: float, sides: str = "one",
                    dtype=jnp.float32) -> Array:
    """Bin index -> Hz axis (reference fourier.ts:147-165): one-sided has
    floor(N/2)+1 bins, two-sided N bins, spacing sample_rate/N."""
    if size <= 0:
        raise ValueError(f"FFT size must be positive, got {size}")
    if sample_rate <= 0:
        raise ValueError(f"Sample rate must be positive, got {sample_rate}")
    bin_count = size // 2 + 1 if sides == "one" else size
    freqs = np.arange(bin_count, dtype=np.float64) * (float(sample_rate) / size)
    return jnp.asarray(freqs, dtype=dtype)
