"""Batched radix-2 FFT in pure jnp — the framework's reference compute path.

Design (see SURVEY.md §7):

* **Stockham autosort formulation.** The reference uses iterative
  decimation-in-time with an explicit bit-reversed scatter
  (reference src/core/fft.ts:110-140). A bit-reversed gather/scatter is
  hostile to tiled accelerator memory, so we use the self-sorting Stockham
  recursion instead: each level is a reshape (free), one vectorised
  butterfly (VPU element-wise ops) and a concatenate — no gathers, no
  scatters, no bit-reversal table. The recursion unrolls at trace time
  (sizes are static under jit), giving XLA a flat chain of log2(N) fused
  element-wise stages.

* **Split real/imag planes** (no complex dtype), the framework's
  ``ComplexArray`` layout.

* **Trace-time f64 twiddles.** Twiddle factors are computed with numpy in
  float64 at trace time and embedded as constants cast to the compute
  dtype — the analogue of the reference's precomputed per-stage tables
  (src/core/fft.ts:40-61) with better rounding than computing cos/sin in
  f32 on device.

Convention (locked to numpy / the reference fixtures,
reference scripts/gen_fixtures.py:348-353):
  forward:  X[k] = sum_n x[n] * exp(-2j*pi*k*n/N)   (unnormalised)
  inverse:  x[n] = (1/N) * sum_k X[k] * exp(+2j*pi*k*n/N)
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .complex import (
    Array,
    ComplexArray,
    as_complex_array,
    create_complex_array,
    is_power_of_two,
)

__all__ = [
    "fft",
    "ifft",
    "fft_axis0",
    "Radix2Fft",
]


def _check_pow2(n: int) -> None:
    if not is_power_of_two(n):
        raise ValueError(f"FFT size must be power of two, got {n}")


def _twiddles(n: int, sign: float, dtype) -> Tuple[np.ndarray, np.ndarray]:
    """Trace-time twiddle constants for the combine step of size ``n``.

    Returns (cos, sin) of shape (n//2, 1) with angle sign*2*pi*k/n,
    computed in float64 then cast (cf. reference buildTwiddles,
    src/core/fft.ts:45-61 which uses angle -2*pi*k/m).
    """
    k = np.arange(n // 2, dtype=np.float64)
    ang = sign * 2.0 * np.pi * k / n
    c = np.cos(ang).astype(dtype)[:, None]
    s = np.sin(ang).astype(dtype)[:, None]
    return c, s


def _fft_axis0(re: Array, im: Array, sign: float) -> Tuple[Array, Array]:
    """Stockham radix-2 FFT over axis 0 of a (n, batch) pair.

    ``sign`` is -1 for forward, +1 for inverse (no normalisation here).
    Unrolled at trace time; every level is reshape + elementwise + concat.
    """
    n = re.shape[0]
    if n == 1:
        return re, im
    half = n // 2
    b = re.shape[1]
    # Even/odd decimation folded into the batch axis:
    # (n, b) -> (half, 2, b) -> recurse on (half, 2*b).
    re2 = re.reshape(half, 2 * b)
    im2 = im.reshape(half, 2 * b)
    yre, yim = _fft_axis0(re2, im2, sign)
    yre = yre.reshape(half, 2, b)
    yim = yim.reshape(half, 2, b)
    e_re, o_re = yre[:, 0, :], yre[:, 1, :]
    e_im, o_im = yim[:, 0, :], yim[:, 1, :]
    c, s = _twiddles(n, sign, re.dtype)
    t_re = c * o_re - s * o_im
    t_im = c * o_im + s * o_re
    out_re = jnp.concatenate([e_re + t_re, e_re - t_re], axis=0)
    out_im = jnp.concatenate([e_im + t_im, e_im - t_im], axis=0)
    return out_re, out_im


def fft_axis0(re: Array, im: Array, inverse: bool = False) -> Tuple[Array, Array]:
    """FFT over axis 0 of (n, batch)-shaped split planes. Expert entry point."""
    n = re.shape[0]
    _check_pow2(n)
    sign = 1.0 if inverse else -1.0
    out_re, out_im = _fft_axis0(re, im, sign)
    if inverse:
        scale = jnp.asarray(1.0 / n, dtype=re.dtype)
        out_re = out_re * scale
        out_im = out_im * scale
    return out_re, out_im


def _transform(x: ComplexArray, inverse: bool, axis: int = -1) -> ComplexArray:
    re, im = x.real, x.imag
    if re.shape != im.shape:
        raise ValueError(f"real/imag shape mismatch: {re.shape} vs {im.shape}")
    ax = axis % re.ndim
    # Move transform axis to the front, flatten batch to one trailing axis.
    re_m = jnp.moveaxis(re, ax, 0)
    im_m = jnp.moveaxis(im, ax, 0)
    n = re_m.shape[0]
    batch_shape = re_m.shape[1:]
    b = int(np.prod(batch_shape)) if batch_shape else 1
    re_f = re_m.reshape(n, b)
    im_f = im_m.reshape(n, b)
    out_re, out_im = fft_axis0(re_f, im_f, inverse=inverse)
    out_re = jnp.moveaxis(out_re.reshape((n,) + batch_shape), 0, ax)
    out_im = jnp.moveaxis(out_im.reshape((n,) + batch_shape), 0, ax)
    return ComplexArray(out_re, out_im)


def fft(x, axis: int = -1) -> ComplexArray:
    """Forward FFT (unnormalised) over ``axis`` of real or complex input.

    Accepts a real array (imag treated as zero, like the reference's
    ``Radix2Fft.forward``, src/core/fft.ts:77-79), a ``ComplexArray``, or a
    numpy complex ndarray. Batched over all other axes.
    """
    xc = as_complex_array(x)
    return _transform(xc, inverse=False, axis=axis)


def ifft(x, axis: int = -1) -> ComplexArray:
    """Inverse FFT with 1/N normalisation (reference src/core/fft.ts:142-148)."""
    xc = as_complex_array(x)
    return _transform(xc, inverse=True, axis=axis)


class Radix2Fft:
    """Size-locked FFT plan — the expert rung.

    Parity with the reference's ``Radix2Fft`` (src/core/fft.ts:63-152):
    validates the size is a power of two at construction and the input
    length on every call. Under JAX a "plan" is the jit compilation cache;
    this class pins the size so each instance compiles exactly once per
    input batch shape and dtype.

    Every call routes through ``ops.dispatch`` (imported lazily — ops
    sits above core), so the expert rung — and everything built on it:
    ``xform.FFT``, ``FluentFFT``, ``FourierService`` — gets the
    platform's chosen path (cuFFT on the GPU) rather than always the
    portable Stockham recursion.
    """

    def __init__(self, size: int):
        _check_pow2(size)
        self.size = size
        from ..ops import dispatch as _dispatch

        def _fwd(re, im):
            out = _dispatch.fft(ComplexArray(re, im))
            return out.real, out.imag

        def _inv(re, im):
            out = _dispatch.ifft(ComplexArray(re, im))
            return out.real, out.imag

        self._fwd = jax.jit(_fwd)
        self._inv = jax.jit(_inv)

    def _check_len(self, x: ComplexArray) -> None:
        if x.real.shape[-1] != self.size:
            raise ValueError(
                f"FFT input length {x.real.shape[-1]} != size {self.size}"
            )

    def forward(self, x) -> ComplexArray:
        """Real (or complex) input forward FFT."""
        xc = as_complex_array(x)
        self._check_len(xc)
        return ComplexArray(*self._fwd(xc.real, xc.imag))

    def forward_complex(self, x) -> ComplexArray:
        xc = as_complex_array(x)
        self._check_len(xc)
        return ComplexArray(*self._fwd(xc.real, xc.imag))

    def inverse(self, x) -> ComplexArray:
        xc = as_complex_array(x)
        self._check_len(xc)
        return ComplexArray(*self._inv(xc.real, xc.imag))
