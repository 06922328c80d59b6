"""Real-input FFTs: numpy-parity rfft/irfft.

The classic two-for-one trick, exact: even/odd time samples packed into
one half-size complex transform, untangled with conjugate symmetry +
twiddles (X[k] = E[k] + W_N^k O[k]). Matches numpy.fft.rfft bins
[0..N/2].

The complex core runs through ops.dispatch (cuFFT on the GPU).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.complex import (Array, ComplexArray, as_complex_array,
                            ensure_float, is_power_of_two)
from .dispatch import fft as _fft, ifft as _ifft

__all__ = ["rfft", "irfft"]


@lru_cache(maxsize=64)
def _half_twiddles(n: int, sign: float) -> Tuple[np.ndarray, np.ndarray]:
    """W_N^k for k = 0..N/2, f64 at trace time."""
    k = np.arange(n // 2 + 1, dtype=np.float64)
    ang = sign * 2.0 * np.pi * k / n
    return np.cos(ang), np.sin(ang)


def _bin_flip(re: Array, im: Array) -> Tuple[Array, Array]:
    """Z[(M - k) % M] along the last axis (conjugate partner index)."""
    re_f = jnp.roll(jnp.flip(re, axis=-1), 1, axis=-1)
    im_f = jnp.roll(jnp.flip(im, axis=-1), 1, axis=-1)
    return re_f, im_f


def rfft(x, axis: int = -1, impl: Optional[str] = None) -> ComplexArray:
    """FFT of real input, bins [0 .. n//2] (numpy.fft.rfft parity).

    Cost: one complex FFT of size n/2 plus an elementwise untangle.
    """
    x = ensure_float(x)     # int input would cast the twiddles to int
    ax = axis % x.ndim
    x = jnp.moveaxis(x, ax, -1)
    n = x.shape[-1]
    if not is_power_of_two(n) or n < 2:
        raise ValueError(f"rfft size must be a power of two >= 2, got {n}")
    m = n // 2
    # Pack even/odd time samples as real/imag of a half-size signal.
    z = x.reshape(x.shape[:-1] + (m, 2))
    Z = _fft(ComplexArray(z[..., 0], z[..., 1]), impl=impl)
    zr, zi = Z.real, Z.imag
    fr, fi = _bin_flip(zr, zi)
    # E = (Z + conj(Zf))/2 ; O = -j (Z - conj(Zf))/2
    er = 0.5 * (zr + fr)
    ei = 0.5 * (zi - fi)
    orr = 0.5 * (zi + fi)
    oii = 0.5 * (fr - zr)
    # X[k] = E[k] + W_N^k O[k], k = 0..m (E/O periodic in m).
    er = jnp.concatenate([er, er[..., :1]], axis=-1)
    ei = jnp.concatenate([ei, ei[..., :1]], axis=-1)
    orr = jnp.concatenate([orr, orr[..., :1]], axis=-1)
    oii = jnp.concatenate([oii, oii[..., :1]], axis=-1)
    tc, ts = _half_twiddles(n, -1.0)
    tc = jnp.asarray(tc, x.dtype)
    ts = jnp.asarray(ts, x.dtype)
    out_re = er + tc * orr - ts * oii
    out_im = ei + tc * oii + ts * orr
    return ComplexArray(jnp.moveaxis(out_re, -1, ax),
                        jnp.moveaxis(out_im, -1, ax))


def irfft(X, n: Optional[int] = None, axis: int = -1,
          impl: Optional[str] = None) -> Array:
    """Inverse of :func:`rfft`: half-spectrum [.., n//2+1] -> real [.., n]
    (numpy.fft.irfft parity)."""
    Xc = as_complex_array(X)
    re = jnp.moveaxis(Xc.real, axis % Xc.real.ndim, -1)
    im = jnp.moveaxis(Xc.imag, axis % Xc.real.ndim, -1)
    bins = re.shape[-1]
    n = n if n is not None else 2 * (bins - 1)
    m = n // 2
    # numpy.irfft treats DC and Nyquist as purely real — enforce that so
    # arbitrary inputs match its semantics.
    mask = np.ones(bins)
    mask[0] = 0.0
    mask[-1] = 0.0
    im = im * jnp.asarray(mask, im.dtype)
    # Repack X -> Z of the half-size transform (inverse of the untangle):
    # E[k] = (X[k] + conj(X[m-k]))/2, O[k] = W_N^{-k}(X[k] - conj(X[m-k]))/2
    xr, xi = re[..., :m], im[..., :m]
    cr = jnp.flip(re[..., 1:], axis=-1)          # X[m-k], k=0..m-1
    ci = jnp.flip(im[..., 1:], axis=-1)
    er = 0.5 * (xr + cr)
    ei = 0.5 * (xi - ci)
    dr = 0.5 * (xr - cr)
    di = 0.5 * (xi + ci)
    tc, ts = _half_twiddles(n, 1.0)              # W_N^{+k}
    tc = jnp.asarray(tc[:m], re.dtype)
    ts = jnp.asarray(ts[:m], re.dtype)
    orr = dr * tc - di * ts
    oii = dr * ts + di * tc
    # Z = E + jO
    zr = er - oii
    zi = ei + orr
    z = _ifft(ComplexArray(zr, zi), impl=impl)
    out = jnp.stack([z.real, z.imag], axis=-1).reshape(re.shape[:-1] + (n,))
    return jnp.moveaxis(out, -1, axis % (out.ndim))
