"""Polyphase resampling: upfirdn, rational resampler, decimator,
interpolator.

Semantics are scipy.signal.upfirdn(h, x, up, down): upsample by ``up``
(zero insertion), filter with ``h`` (full convolution), downsample by
``down``. On the hot path the polyphase structure is compiled to a
single matmul: one cycle of ``up`` outputs is a dot of the
``down + ceil(K/up) - 1`` input samples around the cycle base with a
constant banded tap matrix (see ``_upfirdn_banded``) — the hardware-
native equivalent of a polyphase filterbank (BASELINE.json config 3).
Traced (runtime) taps fall back to an XLA dilated convolution with
``lhs_dilation=up`` / ``window_strides=down``.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.complex import (Array, ComplexArray, as_complex_array,
                            ensure_float)

__all__ = ["upfirdn", "resample_poly", "resample_poly_cascade",
           "decimate", "interpolate",
           "design_lowpass", "resampler_taps",
           "UpfirdnState", "upfirdn_stream_init", "upfirdn_step",
           "CascadeState", "cascade_chunk_quantum",
           "resample_cascade_stream_init", "resample_cascade_step"]


def design_lowpass(num_taps: int, cutoff: float, window: str = "hamming") -> np.ndarray:
    """Windowed-sinc lowpass FIR (normalized cutoff in (0, 1], Nyquist=1),
    matching scipy.signal.firwin(num_taps, cutoff) with the same window
    and unity DC gain. Computed in f64 at trace time."""
    m = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    h = np.sinc(cutoff * m) * cutoff
    from .. import xform  # reuse framework window formulas where they match

    if window == "hamming":
        w = np.hamming(num_taps)
    elif window == "hann":
        w = np.hanning(num_taps)
    elif window == "blackman":
        w = np.blackman(num_taps)
    elif window == "rect":
        w = np.ones(num_taps)
    else:
        raise ValueError(f"unknown window {window}")
    h = h * w
    return h / np.sum(h)


def resampler_taps(up: int, down: int, num_taps: int = 127) -> np.ndarray:
    """Anti-aliasing taps for a rational resampler: cutoff at the tighter
    of the two Nyquist rates, gain ``up`` (so a sine keeps its amplitude
    through zero-insertion)."""
    cutoff = min(1.0 / up, 1.0 / down)
    return design_lowpass(num_taps, cutoff) * up


def _upfirdn_conv(x: Array, h: Array, up: int, down: int) -> Array:
    k = h.shape[0]
    batch_shape = x.shape[:-1]
    length = x.shape[-1]
    xb = x.reshape(-1, 1, length)
    w = h[::-1].reshape(1, 1, k).astype(x.dtype)
    # Full convolution of the up-dilated signal, then stride-down:
    # pad K-1 both sides of the dilated sequence.
    y = jax.lax.conv_general_dilated(
        xb, w, window_strides=(down,), padding=[(k - 1, k - 1)],
        lhs_dilation=(up,), dimension_numbers=("NCH", "IOH", "NCH"),
        precision=jax.lax.Precision.HIGHEST)
    y = y.reshape(batch_shape + (y.shape[-1],))
    # scipy output length: ceil(((L-1)*up + K) / down)
    out_len = -(-((length - 1) * up + k) // down)
    return y[..., :out_len]


def _upfirdn_banded(x: Array, h: Array, up: int, down: int,
                    precision: Optional[str] = None) -> Array:
    """upfirdn as one matmul against a banded per-phase tap matrix.

    y[m] = Σ_q h[p + up*q] * x[b - q] with p = (m*down) mod up and
    b = floor(m*down/up); grouping outputs by polyphase cycle
    (m = s*up + r) makes each cycle of ``up`` outputs a dot of the
    ``W = down + Q - 1`` input samples around x[s*down] with a constant
    (W, up) matrix. One reshape + T row-shifted concats build the frames
    (XLA's dilated-conv lowering of the same computation is the fallback
    for traced taps; its speed on the H100 is not measured).

    ``precision`` (ops/precision.py): "bf16x3" runs the banded matmul as
    three bf16 passes on hi/lo-split operands (taps pre-split at trace
    time) with f32 accumulation, ~110 dB SNR; "highest" (the default)
    keeps the f32 HIGHEST einsum.
    """
    from .precision import _bsplit, _np_bsplit, resolve_precision

    prec = resolve_precision(precision)
    hh = np.asarray(h, dtype=np.float64)    # static taps (caller-checked)
    k = hh.shape[0]
    length = x.shape[-1]
    q_taps = -(-k // up)                     # taps per phase
    halo = q_taps - 1                        # left history per cycle
    out_len = -(-((length - 1) * up + k) // down)
    # Cycle grouping: one polyphase cycle emits ``up`` outputs, so for
    # small ``up`` a per-cycle dot is a thin matvec — pure decimation
    # (up=1) degenerates to (W, 1). Grouping C cycles per frame makes
    # each dot emit up*C ~ 128 outputs at the cost of a
    # (down*C + halo)-wide frame; identical arithmetic, just a blocked
    # matrix.
    cyc = max(1, -(-128 // up))
    upc = up * cyc
    stride = down * cyc
    w_frame = stride + halo
    n_frames = -(-out_len // upc)

    mat = np.zeros((w_frame, upc))
    for r in range(upc):
        p = (r * down) % up
        c = (r * down) // up                 # in-frame base (before halo)
        for q in range(q_taps):
            tap = p + up * q
            if tap < k:
                mat[c - q + halo, r] = hh[tap]

    # frames[s] = xp[s*stride : s*stride + w_frame], xp left-padded by
    # halo, right-padded to whole rows; built from row-shifted reshape
    # slices.
    t_rows = -(-w_frame // stride)
    total = (n_frames + t_rows) * stride
    pad = [(0, 0)] * (x.ndim - 1) + [(halo, total - halo - length)]
    xp = jnp.pad(x, pad)
    rows = xp.reshape(xp.shape[:-1] + (n_frames + t_rows, stride))
    frames = jnp.concatenate(
        [rows[..., t: t + n_frames, :] for t in range(t_rows)],
        axis=-1)[..., :w_frame]
    if prec == "bf16x3":
        mh, ml = _np_bsplit(mat)
        mhj, mlj = jnp.asarray(mh), jnp.asarray(ml)
        fh, fl = _bsplit(frames.astype(jnp.float32))
        ein = functools.partial(jnp.einsum, "...fw,wr->...fr",
                                precision=jax.lax.Precision.DEFAULT,
                                preferred_element_type=jnp.float32)
        y = (ein(fh, mhj) + (ein(fh, mlj) + ein(fl, mhj))).astype(x.dtype)
    else:
        y = jnp.einsum("...fw,wr->...fr", frames,
                       jnp.asarray(mat, dtype=x.dtype),
                       precision=jax.lax.Precision.HIGHEST)
    y = y.reshape(y.shape[:-2] + (n_frames * upc,))
    return y[..., :out_len]


def _upfirdn_real(x: Array, h, up: int, down: int,
                  precision: Optional[str] = None) -> Array:
    x = ensure_float(x)     # the banded matrix is cast to x.dtype below
    if up == 1 and down == 1:
        return _upfirdn_conv(x, jnp.asarray(h), 1, 1)
    try:
        hnp = np.asarray(h, dtype=np.float64)
    except Exception:
        # taps are a runtime value (traced under jit/scan) — the banded
        # matrix needs static taps, so use the dilated-conv lowering.
        return _upfirdn_conv(x, jnp.asarray(h), up, down)
    return _upfirdn_banded(x, hnp, up, down, precision)


def upfirdn(x, h, up: int = 1, down: int = 1,
            precision: Optional[str] = None) -> Array:
    """scipy.signal.upfirdn semantics along the last axis; batched.

    Real or complex (split-plane) input; ``h`` is real. Concrete taps
    (numpy or non-traced) take the banded-matmul path; traced taps fall
    back to the dilated-conv lowering. ``precision`` = None means
    "highest" (f32 dots); pass "bf16x3" for the split-bf16 dots.
    """
    if isinstance(x, ComplexArray):
        return ComplexArray(_upfirdn_real(x.real, h, up, down, precision),
                            _upfirdn_real(x.imag, h, up, down, precision))
    x = jnp.asarray(x)
    if jnp.iscomplexobj(x):
        return ComplexArray(_upfirdn_real(x.real, h, up, down, precision),
                            _upfirdn_real(x.imag, h, up, down, precision))
    return _upfirdn_real(x, h, up, down, precision)


def resample_poly(x, up: int, down: int, taps=None,
                  num_taps: int = 127,
                  precision: Optional[str] = None) -> Array:
    """Rational-rate resampler (e.g. 48 kHz -> 44.1 kHz is up=147,
    down=160 with the default 127-tap design — BASELINE.json config 3).

    Matches scipy.signal.upfirdn with the same taps; to compare against
    scipy.signal.resample_poly pass its filter via ``taps``.
    """
    g = math.gcd(up, down)
    up //= g
    down //= g
    if taps is None:
        taps = resampler_taps(up, down, num_taps)
    return upfirdn(x, taps, up, down, precision)


def _cascade_stages(factors, taps, taps_per_phase: int):
    """Normalise a cascade spec into [(up, down, taps)] — the ONE place
    the gcd reduction and default per-stage design live, shared by the
    batch, stream-init, and step paths so they cannot diverge."""
    if taps is not None and len(taps) != len(factors):
        raise ValueError(
            f"taps list length {len(taps)} != {len(factors)} stages")
    stages = []
    for i, (up, down) in enumerate(factors):
        g = math.gcd(up, down)
        up //= g
        down //= g
        h = taps[i] if taps is not None else resampler_taps(
            up, down, taps_per_phase * max(up, down) + 1)
        stages.append((up, down, h))
    return stages


def resample_poly_cascade(x, factors, taps=None, taps_per_phase: int = 8,
                          precision: Optional[str] = None) -> Array:
    """Multi-stage rational resampler: ``factors`` is a list of
    (up, down) stages applied in order, each an independent
    ``upfirdn`` with its own anti-aliasing design (``resampler_taps``
    with 8*max(up, down)+1 taps by default, the same taps-per-phase
    density as config 3's 1177-tap single stage).

    e.g. 48 kHz -> 44.1 kHz as (3, 4)·(7, 8)·(7, 5) = 147/160.

    Each stage pays its full dense (w_frame, up*cyc) band regardless of
    ratio, so splitting the ratio multiplies band work instead of
    reducing it (the dense-band MAC count per input sample is ~2x the
    single stage's). Shipped as a public building block (cascades are
    the standard CPU-DSP escape from awkward ratios, and multi-rate
    chains compose from it), but ``resample_poly`` remains the config-3
    path; the two are not timed against each other on the H100.

    ``taps`` (optional) is a list of per-stage tap arrays overriding
    the default designs.
    """
    y = x
    for up, down, h in _cascade_stages(factors, taps, taps_per_phase):
        y = upfirdn(y, h, up, down, precision)
    return y


class UpfirdnState(NamedTuple):
    """Streaming upfirdn carry: the last ``history`` input samples.

    A NamedTuple pytree — threads through jit / lax.scan and can be
    donated (the analogue of the reference expert rung's out-buffer
    reuse, src/core/fft.ts:89-106).
    """

    tail: Array


def _upfirdn_history(k: int, up: int, down: int) -> int:
    """Carry length: >= ceil((K-1)/up) samples, rounded up so the carry
    keeps the output decimation grid aligned (history*up % down == 0)."""
    g = math.gcd(up, down)
    step = down // g
    c = -(-(k - 1) // up)
    return -(-c // step) * step


def upfirdn_stream_init(h, up: int = 1, down: int = 1,
                        batch_shape=(), dtype=jnp.float32) -> UpfirdnState:
    """Zero streaming state (cold start = zero history, matching the
    batch upfirdn's implicit zero left-padding)."""
    k = np.asarray(h).shape[0]
    hist = _upfirdn_history(k, up, down)
    return UpfirdnState(tail=jnp.zeros(batch_shape + (hist,), dtype=dtype))


def upfirdn_step(state: UpfirdnState, chunk, h, up: int = 1, down: int = 1):
    """Chunked upfirdn: emits exactly the finalised batch samples.

    Chunk length must satisfy len*up % down == 0 (keeps the carry shape
    static under jit/scan). Concatenating the outputs of successive steps
    equals the PREFIX of ``upfirdn`` over the concatenated stream — the
    filter ring-out tail (the last ceil((K-up)/down) batch samples, which
    depend on future input) is emitted once those samples arrive.
    Complex chunks stream per plane with a shared-shape state pair.
    """
    if isinstance(chunk, ComplexArray):
        raise TypeError("upfirdn_step streams real planes; split complex "
                        "input and carry one state per plane")
    chunk = jnp.asarray(chunk)
    if jnp.iscomplexobj(chunk):
        raise TypeError("upfirdn_step streams real planes; split complex "
                        "input and carry one state per plane")
    # h passes through unconverted: jnp.asarray under an outer jit would
    # trace concrete taps and push upfirdn onto its slow conv fallback.
    k = np.shape(h)[0]
    if (chunk.shape[-1] * up) % down != 0:
        raise ValueError(
            f"chunk length {chunk.shape[-1]} must satisfy len*{up} % {down} == 0")
    hist = _upfirdn_history(k, up, down)
    buf = jnp.concatenate([state.tail, chunk], axis=-1)
    full = upfirdn(buf, h, up, down)
    start = hist * up // down
    count = chunk.shape[-1] * up // down
    out = full[..., start:start + count]
    new_tail = buf[..., buf.shape[-1] - hist:]
    return UpfirdnState(tail=new_tail), out


class CascadeState(NamedTuple):
    """Streaming carry for a multi-stage cascade: one UpfirdnState per
    stage (a pytree of pytrees — jit/scan/donation-compatible)."""

    stages: tuple


def cascade_chunk_quantum(factors) -> int:
    """Smallest chunk length every cascade stage accepts: stage i needs
    its input length len_i = q * prod(u_j/d_j, j<i) to be an integer
    with len_i * u_i % d_i == 0, i.e. q * pu_i ≡ 0 (mod d_i * pd_i)."""
    q = 1
    pu, pd = 1, 1
    for up, down in factors:
        g = math.gcd(up, down)
        up //= g
        down //= g
        need = (down * pd) // math.gcd(pu, down * pd)
        q = q * need // math.gcd(q, need)
        pu *= up
        pd *= down
    return q


def resample_cascade_stream_init(factors, taps=None,
                                 taps_per_phase: int = 8,
                                 batch_shape=(), dtype=jnp.float32
                                 ) -> CascadeState:
    """Zero streaming state for :func:`resample_poly_cascade` (same
    per-stage tap defaults)."""
    return CascadeState(stages=tuple(
        upfirdn_stream_init(h, up, down, batch_shape, dtype)
        for up, down, h in _cascade_stages(factors, taps, taps_per_phase)))


def resample_cascade_step(state: CascadeState, chunk, factors, taps=None,
                          taps_per_phase: int = 8):
    """Chunked multi-stage resampling: each stage's ``upfirdn_step``
    feeds the next, so concatenated step outputs equal the PREFIX of
    ``resample_poly_cascade`` over the concatenated stream (every stage
    carries the prefix contract through). Chunk length must be a
    multiple of :func:`cascade_chunk_quantum`."""
    q = cascade_chunk_quantum(factors)
    if jnp.shape(jnp.asarray(chunk))[-1] % q != 0:
        raise ValueError(
            f"chunk length {jnp.shape(jnp.asarray(chunk))[-1]} must be a "
            f"multiple of the cascade quantum {q}")
    y = chunk
    new_states = []
    for i, (up, down, h) in enumerate(
            _cascade_stages(factors, taps, taps_per_phase)):
        st, y = upfirdn_step(state.stages[i], y, h, up, down)
        new_states.append(st)
    return CascadeState(stages=tuple(new_states)), y


def decimate(x, factor: int, taps=None, num_taps: int = 127,
             precision: Optional[str] = None) -> Array:
    """Anti-aliased integer-rate decimation."""
    if taps is None:
        taps = design_lowpass(num_taps, 1.0 / factor)
    return upfirdn(x, taps, 1, factor, precision)


def interpolate(x, factor: int, taps=None, num_taps: int = 127,
                precision: Optional[str] = None) -> Array:
    """Zero-stuffing interpolation with anti-imaging filter (gain=factor)."""
    if taps is None:
        taps = design_lowpass(num_taps, 1.0 / factor) * factor
    return upfirdn(x, taps, factor, 1, precision)
