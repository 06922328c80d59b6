"""Polyphase filterbank channelizer (BASELINE.json config 5).

Critically-sampled C-channel PFB: the input IQ stream is split into C
polyphase branches, each branch filtered with its slice of the prototype
lowpass, and an FFT across branches separates the channels. One output
frame of C channel samples is produced per C input samples.

Convention (matched by the numpy golden in tests/test_channelizer.py):

    y[m, c] = sum_p exp(-2j*pi*p*c/C) * sum_t h[t*C + p] * x[(m-t)*C + p]

i.e. branch p takes input samples congruent to p (mod C), the branch
filters are time-aligned (causal, zero history), and the channel
separation is a forward (analysis) DFT across branches, so a tone at
+c/C of the input rate lands in channel c (a tone at k/C contributes
exp(+2j*pi*k*p/C) per branch, which the forward kernel picks out at
c = k).

All heavy work is batched: branch filtering is T weighted shifted
slices of the frame view and the cross-branch FFT uses the dispatch
path. The channel axis is what `parallel/` shards over devices with
all_to_all.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

from ..core.complex import Array, ComplexArray, as_complex_array
from .dispatch import fft as _fft
from .polyphase import design_lowpass

__all__ = ["pfb_taps", "pfb_channelize", "pfb_channelize_frames",
           "PfbState", "pfb_stream_init", "pfb_channelize_step",
           "PfbFramesState", "pfb_frames_stream_init",
           "pfb_channelize_frames_step"]


def pfb_taps(channels: int, taps_per_branch: int = 8,
             cutoff_scale: float = 1.0) -> np.ndarray:
    """Prototype lowpass for a C-channel PFB: C*T taps, cutoff 1/C
    (scaled), unity DC gain."""
    return design_lowpass(channels * taps_per_branch,
                          cutoff_scale / channels)


def _branch_filter_frames(x: ComplexArray, h, channels: int
                          ) -> Tuple[Array, Array]:
    """Polyphase branch filtering over an (M, C) frame view.

    x: [..., M, C] complex frames (frame m = input samples
    [m*C, (m+1)*C)). Returns (re, im) shaped [..., M, C] with entry
    [m, p] = sum_t h[t*C+p] * x[(m-t)*C + p].
    """
    c = channels
    k = jnp.shape(jnp.asarray(h))[0]
    t_taps = -(-k // c)
    # hp[t, p] = h[t*C + p]; built with jnp so traced taps work too
    # (e.g. taps passed as a runtime argument under shard_map/jit).
    hp_flat = jnp.zeros((t_taps * c,), dtype=jnp.asarray(h).dtype)
    hp = hp_flat.at[:k].set(jnp.asarray(h)).reshape(t_taps, c)
    m = x.real.shape[-2]
    batch = x.real.shape[:-2]

    # Frames[m] needs x blocks m, m-1, ..., m-T+1 -> left-pad T-1 zero
    # blocks; block (m-t) is then a length-m row slice of the padded
    # block array at offset T-1-t, so the branch filter is T weighted
    # shifted slices instead of an index gather.
    def one_plane(xb):
        pad = [(0, 0)] * len(batch) + [(t_taps - 1, 0), (0, 0)]
        xp = jnp.pad(xb, pad)
        w = jnp.asarray(hp, dtype=xb.dtype)
        acc = None
        for t in range(t_taps):
            term = xp[..., t_taps - 1 - t: t_taps - 1 - t + m, :] * w[t]
            acc = term if acc is None else acc + term
        return acc

    return one_plane(x.real), one_plane(x.imag)


def _branch_filter(x: ComplexArray, h, channels: int
                   ) -> Tuple[Array, Array]:
    """Polyphase branch filtering of a flat stream [..., L], L = M*C."""
    c = channels
    m = x.real.shape[-1] // c
    batch = x.real.shape[:-1]
    frames = ComplexArray(x.real.reshape(batch + (m, c)),
                          x.imag.reshape(batch + (m, c)))
    return _branch_filter_frames(frames, h, c)


def pfb_channelize(x, channels: int, taps=None,
                   taps_per_branch: int = 8) -> ComplexArray:
    """Channelize IQ [..., L] (L multiple of C) into [..., M, C] complex
    channel samples, M = L // C; channel c is centred at +c/C of the
    input sample rate and runs at rate fs/C."""
    xc = as_complex_array(x)
    if taps is None:
        taps = pfb_taps(channels, taps_per_branch)
    taps = jnp.asarray(taps)
    if xc.real.shape[-1] % channels != 0:
        raise ValueError(
            f"input length {xc.real.shape[-1]} not a multiple of "
            f"channels={channels}")
    vr, vi = _branch_filter(xc, taps, channels)
    # Analysis DFT across branches (forward kernel, unnormalised).
    return _fft(ComplexArray(vr, vi), axis=-1)


def pfb_channelize_frames(x, channels: int, taps=None,
                          taps_per_branch: int = 8) -> ComplexArray:
    """Channelize an (M, C)-frame view of the IQ stream: input
    [..., M, C] complex frames (frame m holds stream samples
    [m*C, (m+1)*C)) -> [..., M, C] natural-order channel samples,
    numerically identical to ``pfb_channelize`` on the flat stream.

    This is the entry for consumers whose upstream already holds
    frames (chunked streaming, sharded pipelines): it skips the flat
    entry's 1-D -> 2-D reshape into the frame view.
    """
    xc = as_complex_array(x)
    if xc.real.ndim < 2 or xc.real.shape[-1] != channels:
        raise ValueError(
            f"frames input must be [..., M, {channels}], "
            f"got {xc.real.shape}")
    if taps is None:
        taps = pfb_taps(channels, taps_per_branch)
    taps = jnp.asarray(taps)
    vr, vi = _branch_filter_frames(xc, taps, channels)
    return _fft(ComplexArray(vr, vi), axis=-1)


class PfbState(NamedTuple):
    """Streaming carry: last (T-1)*C input samples."""

    tail_re: Array
    tail_im: Array


def pfb_stream_init(channels: int, taps_per_branch: int = 8,
                    batch_shape: Tuple[int, ...] = (),
                    dtype=jnp.float32) -> PfbState:
    n = (taps_per_branch - 1) * channels
    z = jnp.zeros(batch_shape + (n,), dtype=dtype)
    return PfbState(tail_re=z, tail_im=z)


def pfb_channelize_step(state: PfbState, chunk, channels: int, taps=None,
                        taps_per_branch: int = 8
                        ) -> Tuple[PfbState, ComplexArray]:
    """Chunked channelizer matching the batch result (chunk length must
    be a multiple of C)."""
    xc = as_complex_array(chunk)
    if taps is None:
        taps = pfb_taps(channels, taps_per_branch)
    t_taps = -(-int(jnp.shape(jnp.asarray(taps))[0]) // channels)
    hist = (t_taps - 1) * channels
    buf = ComplexArray(
        jnp.concatenate([state.tail_re, xc.real], axis=-1),
        jnp.concatenate([state.tail_im, xc.imag], axis=-1))
    full = pfb_channelize(buf, channels, taps, taps_per_branch)
    # The first (T-1) output frames re-compute history already emitted.
    out = ComplexArray(full.real[..., t_taps - 1:, :],
                       full.imag[..., t_taps - 1:, :])
    new = PfbState(tail_re=buf.real[..., buf.real.shape[-1] - hist:],
                   tail_im=buf.imag[..., buf.imag.shape[-1] - hist:])
    return new, out


class PfbFramesState(NamedTuple):
    """Streaming carry in frame view: last (T-1) input frames, each C
    samples — the branch-filter history, never re-flattened."""

    tail_re: Array                       # [..., T-1, C]
    tail_im: Array


def pfb_frames_stream_init(channels: int, taps_per_branch: int = 8,
                           batch_shape: Tuple[int, ...] = (),
                           dtype=jnp.float32) -> PfbFramesState:
    z = jnp.zeros(batch_shape + (taps_per_branch - 1, channels),
                  dtype=dtype)
    return PfbFramesState(tail_re=z, tail_im=z)


def pfb_channelize_frames_step(state: PfbFramesState, chunk_frames,
                               channels: int, taps=None,
                               taps_per_branch: int = 8
                               ) -> Tuple[PfbFramesState, ComplexArray]:
    """Chunked channelizer over (Mc, C) frame chunks, matching the batch
    ``pfb_channelize_frames`` result — the whole streaming loop stays in
    the frame view and never re-flattens its tail.
    """
    xc = as_complex_array(chunk_frames)
    if xc.real.ndim < 2 or xc.real.shape[-1] != channels:
        raise ValueError(
            f"chunk must be [..., Mc, {channels}], got {xc.real.shape}")
    if taps is None:
        taps = pfb_taps(channels, taps_per_branch)
    t_taps = -(-int(jnp.shape(jnp.asarray(taps))[0]) // channels)
    hist = t_taps - 1                      # history in FRAMES
    buf = ComplexArray(
        jnp.concatenate([state.tail_re, xc.real], axis=-2),
        jnp.concatenate([state.tail_im, xc.imag], axis=-2))
    full = pfb_channelize_frames(buf, channels, taps, taps_per_branch)
    # The first (T-1) output frames re-compute history already emitted.
    out = ComplexArray(full.real[..., hist:, :], full.imag[..., hist:, :])
    new = PfbFramesState(
        tail_re=buf.real[..., buf.real.shape[-2] - hist:, :],
        tail_im=buf.imag[..., buf.imag.shape[-2] - hist:, :])
    return new, out
