"""AM/FM demodulation on IQ streams (BASELINE.json config 4).

All stages are batched array ops; the only recurrence (de-emphasis IIR)
uses an associative scan, keeping the whole chain jit-compilable with no
per-sample Python or lax.scan serialisation.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.complex import (Array, ComplexArray, as_complex_array,
                            ensure_float)

__all__ = ["am_demod", "fm_discriminate", "iir_one_pole", "deemphasis",
           "FmDemodState", "fm_stream_init", "fm_discriminate_step"]


def am_demod(x, remove_dc: bool = True) -> Array:
    """Envelope detector: |IQ|, optionally mean-removed along the last axis."""
    xc = as_complex_array(x)
    env = jnp.hypot(xc.real, xc.imag)
    if remove_dc:
        env = env - jnp.mean(env, axis=-1, keepdims=True)
    return env


def _phase_diff(xc: ComplexArray, prev: Optional[ComplexArray] = None) -> Array:
    """angle(x[n] * conj(x[n-1])) with x[-1] taken from ``prev`` (or 1+0j)."""
    re, im = xc.real, xc.imag
    if prev is None:
        pr = jnp.concatenate([jnp.ones_like(re[..., :1]), re[..., :-1]], axis=-1)
        pi = jnp.concatenate([jnp.zeros_like(im[..., :1]), im[..., :-1]], axis=-1)
    else:
        pr = jnp.concatenate([prev.real, re[..., :-1]], axis=-1)
        pi = jnp.concatenate([prev.imag, im[..., :-1]], axis=-1)
    # x[n] * conj(x[n-1])
    dr = re * pr + im * pi
    di = im * pr - re * pi
    return jnp.arctan2(di, dr)


def fm_discriminate(x, sample_rate: float = 1.0,
                    deviation: Optional[float] = None) -> Array:
    """Quadrature FM discriminator: inst. frequency from successive-sample
    phase differences. Output in Hz (sample_rate given, deviation None),
    or normalised to +-1 at ``deviation`` Hz."""
    xc = as_complex_array(x)
    dphi = _phase_diff(xc)
    inst_hz = dphi * (sample_rate / (2.0 * np.pi))
    if deviation is not None:
        inst_hz = inst_hz / deviation
    return inst_hz


def iir_one_pole(x: Array, alpha, y0=0.0) -> Array:
    """First-order IIR y[n] = (1-alpha) x[n] + alpha y[n-1] along the
    last axis.

    Concrete ``alpha`` takes the blocked-matmul form: 128-sample blocks
    each apply a constant lower-triangular impulse-response matrix (one
    f32 HIGHEST matmul), and only the per-block carries run through a
    (128x shorter) associative scan instead of a log-depth element scan
    over the full length. Traced ``alpha`` falls back to the element
    associative scan. 141 dB SNR vs the f64
    scipy.lfilter reference either way."""
    x = ensure_float(x)     # int x would cast alpha to int below
    try:
        a_np = float(np.asarray(alpha))
    except Exception:
        a_np = None
    if a_np is not None:
        return _iir_one_pole_blocked(x, a_np, y0)
    alpha = jnp.asarray(alpha, dtype=x.dtype)
    b = (1.0 - alpha) * x
    a = jnp.broadcast_to(alpha, x.shape)

    def combine(c1, c2):
        a1, b1 = c1
        a2, b2 = c2
        return a1 * a2, b1 * a2 + b2

    a_scan, b_scan = jax.lax.associative_scan(combine, (a, b), axis=-1)
    return b_scan + a_scan * jnp.asarray(y0, dtype=x.dtype)


def _iir_one_pole_blocked(x: Array, alpha: float, y0, block: int = 128
                          ) -> Array:
    """Blocked one-pole IIR: y_local = blocks @ L (L[j, i] =
    (1-alpha) alpha^(i-j), i >= j, trace-time f64), then the block-end
    carries c_k = alpha^B c_{k-1} + end_{k-1} (c_0 = y0) via a scan
    over n/B elements, folded back as c_k * alpha^(i+1)."""
    n = x.shape[-1]
    nb = -(-n // block)
    pad = [(0, 0)] * (x.ndim - 1) + [(0, nb * block - n)]
    blocks = jnp.pad(x, pad).reshape(x.shape[:-1] + (nb, block))
    i = np.arange(block)
    lt = np.where(i[:, None] >= i[None, :],
                  float(alpha) ** np.maximum(i[:, None] - i[None, :], 0),
                  0.0) * (1.0 - float(alpha))
    ylocal = jnp.einsum("...nb,bi->...ni", blocks,
                        jnp.asarray(lt.T, x.dtype),
                        precision=jax.lax.Precision.HIGHEST)
    ends = ylocal[..., :, -1]
    a_blk = float(alpha) ** block
    y0a = jnp.broadcast_to(jnp.asarray(y0, x.dtype),
                           ends.shape[:-1] + (1,)).reshape(
                               ends.shape[:-1] + (1,))
    b = jnp.concatenate([y0a, ends[..., :-1]], axis=-1)
    a = jnp.full(ends.shape, a_blk, x.dtype)

    def combine(c1, c2):
        a1, b1 = c1
        a2, b2 = c2
        return a1 * a2, b1 * a2 + b2

    _, carry = jax.lax.associative_scan(combine, (a, b), axis=-1)
    apow = jnp.asarray(float(alpha) ** (i + 1.0), x.dtype)
    y = ylocal + carry[..., :, None] * apow
    return y.reshape(x.shape[:-1] + (nb * block,))[..., :n]


def deemphasis(x: Array, sample_rate: float, tau: float = 75e-6) -> Array:
    """Broadcast-FM de-emphasis (75 us Americas / 50 us Europe): one-pole
    lowpass with time constant tau."""
    alpha = float(np.exp(-1.0 / (sample_rate * tau)))
    return iir_one_pole(x, alpha)


class FmDemodState(NamedTuple):
    """Streaming discriminator carry: the last IQ sample."""

    last_re: Array
    last_im: Array


def fm_stream_init(batch_shape: Tuple[int, ...] = (),
                   dtype=jnp.float32) -> FmDemodState:
    return FmDemodState(last_re=jnp.ones(batch_shape + (1,), dtype=dtype),
                        last_im=jnp.zeros(batch_shape + (1,), dtype=dtype))


def fm_discriminate_step(state: FmDemodState, chunk,
                         sample_rate: float = 1.0,
                         deviation: Optional[float] = None
                         ) -> Tuple[FmDemodState, Array]:
    """Chunked discriminator matching the batch result exactly."""
    xc = as_complex_array(chunk)
    dphi = _phase_diff(xc, ComplexArray(state.last_re, state.last_im))
    out = dphi * (sample_rate / (2.0 * np.pi))
    if deviation is not None:
        out = out / deviation
    new = FmDemodState(last_re=xc.real[..., -1:], last_im=xc.imag[..., -1:])
    return new, out
