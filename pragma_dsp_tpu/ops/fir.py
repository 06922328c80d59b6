"""FIR filtering: direct (XLA conv) and overlap-save (FFT) paths.

Semantics are scipy.signal.lfilter(taps, 1, x): causal, zero initial
state, y[n] = sum_k h[k] x[n-k]. Batched over leading axes.

The overlap-save path (block FFT -> pointwise multiply by the filter
spectrum -> inverse FFT, through ops.dispatch) is the batched
replacement for streaming per-sample convolution (SURVEY.md §2b).

Streaming: ``FirState`` carries the last K-1 input samples so chunked
filtering matches the batch result exactly (jit/scan-compatible).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.complex import (Array, ComplexArray, ensure_float,
                            is_power_of_two, next_power_of_two)
from .dispatch import fft as _fft, ifft as _ifft

__all__ = ["fir_filter", "FirState", "fir_stream_init", "fir_step",
           "overlap_save_filter"]


def _conv_causal(x: Array, taps: Array) -> Array:
    """Causal FIR via XLA conv."""
    k = taps.shape[0]
    batch_shape = x.shape[:-1]
    length = x.shape[-1]
    xb = x.reshape(-1, 1, length)
    # Correlation with flipped taps == convolution; left-pad K-1 zeros
    # so y[n] only sees x[<=n] (zero initial state).
    w = taps[::-1].reshape(1, 1, k).astype(x.dtype)
    y = jax.lax.conv_general_dilated(
        xb, w, window_strides=(1,), padding=[(k - 1, 0)],
        dimension_numbers=("NCH", "IOH", "NCH"),
        precision=jax.lax.Precision.HIGHEST)
    return y.reshape(batch_shape + (length,))


def fir_filter(x, taps, method: str = "auto") -> Array:
    """Apply a real FIR filter causally along the last axis.

    method: 'direct' (XLA conv), 'overlap_save' (FFT blocks), or 'auto'
    (overlap-save once the tap count makes FFT cheaper).
    Complex input is filtered per plane (taps are real).
    """
    taps = jnp.asarray(taps)
    if isinstance(x, ComplexArray):
        return ComplexArray(fir_filter(x.real, taps, method),
                            fir_filter(x.imag, taps, method))
    x = jnp.asarray(x)
    if jnp.iscomplexobj(x):
        return ComplexArray(fir_filter(x.real, taps, method),
                            fir_filter(x.imag, taps, method))
    x = ensure_float(x)     # int input would cast the taps to int below
    k = taps.shape[0]
    if method == "auto":
        method = "overlap_save" if k >= 64 and x.shape[-1] >= 4 * k else "direct"
    if method == "direct":
        return _conv_causal(x, taps)
    if method == "overlap_save":
        return overlap_save_filter(x, taps)
    raise ValueError(f"unknown FIR method: {method}")


def overlap_save_filter(x: Array, taps: Array,
                        block: Optional[int] = None) -> Array:
    """Causal FIR via overlap-save FFT blocks (lfilter-equivalent).

    Each length-N block consumes N - (K-1) fresh samples and carries the
    previous K-1 (the halo that `parallel/` exchanges across chips with
    ppermute when time-blocks are sharded). N defaults to the power of
    two >= 8K, a good FFT/overlap balance.
    """
    x = ensure_float(x)     # taps are cast to x.dtype below
    taps = jnp.asarray(taps, dtype=x.dtype)
    k = taps.shape[0]
    length = x.shape[-1]
    n = block if block is not None else max(256, next_power_of_two(8 * k))
    if n < 2 * (k - 1):
        # The row-shifted framing below carries the overlap in a single
        # hop-sized row, which requires hop = n - overlap >= overlap.
        raise ValueError(
            f"overlap-save block {n} must be >= 2*(len(taps)-1) = {2 * (k - 1)}")
    if not is_power_of_two(n):
        raise ValueError(
            f"overlap-save block size must be a power of two, got {n} "
            "(every FFT impl in this package is radix-2; pass block=None "
            "for the automatic choice)")
    # The first o = K-1 samples of each block are the dropped overlap.
    o = k - 1
    hop = n - o
    n_blocks = -(-length // hop)

    # Left-pad with the o-sample zero history + right-pad to whole blocks.
    pad_right = n_blocks * hop - length
    pad = [(0, 0)] * (x.ndim - 1) + [(o, pad_right)]
    xp = jnp.pad(x, pad)

    # Frames of length n starting every hop samples: consecutive frames
    # share the o-sample overlap. Built from reshape + row-shifted slices
    # instead of an index gather.
    body = xp[..., : n_blocks * hop]
    rows = body.reshape(body.shape[:-1] + (n_blocks, hop))
    nxt = jnp.concatenate(
        [rows[..., 1:, :o],
         xp[..., None, n_blocks * hop:]], axis=-2)
    frames = jnp.concatenate([rows, nxt], axis=-1)   # [..., n_blocks, n]

    h = jnp.zeros((n,), dtype=x.dtype).at[:k].set(taps)
    hspec = _fft(h)
    fspec = _fft(frames)
    prod_re = fspec.real * hspec.real - fspec.imag * hspec.imag
    prod_im = fspec.real * hspec.imag + fspec.imag * hspec.real
    y = _ifft(ComplexArray(prod_re, prod_im)).real
    # First o samples of each block are circular garbage.
    y = y[..., o:]
    y = y.reshape(y.shape[:-2] + (n_blocks * hop,))
    return y[..., :length]


class FirState(NamedTuple):
    """Streaming FIR carry: the last K-1 input samples."""

    tail: Array


def fir_stream_init(taps, batch_shape: Tuple[int, ...] = (),
                    dtype=jnp.float32) -> FirState:
    k = np.asarray(taps).shape[0]
    return FirState(tail=jnp.zeros(batch_shape + (k - 1,), dtype=dtype))


def fir_step(state: FirState, chunk: Array, taps) -> Tuple[FirState, Array]:
    """Filter one chunk; exactly matches the batch fir_filter result over
    the concatenated stream."""
    chunk = ensure_float(chunk)   # int chunk would cast the taps to int
    taps = jnp.asarray(taps, dtype=chunk.dtype)
    k = taps.shape[0]
    buf = jnp.concatenate([state.tail, chunk], axis=-1)
    y = fir_filter(buf, taps)[..., k - 1:]
    new_tail = buf[..., buf.shape[-1] - (k - 1):]
    return FirState(tail=new_tail), y
