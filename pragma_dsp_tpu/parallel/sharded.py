"""Sharded DSP pipelines: halo-exchange overlap-save FIR, sharded
spectrogram, and the channel-sharded PFB channelizer corner turn.

Layouts follow the scaling-book recipe: pick a mesh, shard the
embarrassingly-parallel axis (batch / frames / channels) with shard_map,
and exchange only what the math requires — the K-1-sample filter halo
via `ppermute` (neighbour traffic only), the channelizer's
frame->channel reshard via one `all_to_all`.

Every entry point accepts either a single mesh axis name or a TUPLE of
axis names (the ≥2-host story, BASELINE config 5): on a 2-D
``make_mesh((hosts, chips), ("host", "chip"))`` mesh pass
``axis=("host", "chip")`` and the time axis shards over the host-major
flattened joint axis. Host-major means the `ppermute` halo hops stay
between devices of one host for (chips-1)/chips of the ring and cross
the host network only at host boundaries, while the PFB's one
`all_to_all` corner turn spans the joint axis and leaves the channel
dimension sharded host-major: each host owns a contiguous block of
whole channels, the config-5 layout.

Every entry point builds its shard_map'd + jitted program once per
static signature (lru_cache): repeated calls hit the compilation cache.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..core.complex import Array, ComplexArray, as_complex_array
from ..ops.channelizer import (pfb_channelize,
                               pfb_channelize_frames, pfb_taps)
from ..ops.fir import fir_filter
from ..public.spectrum import SpectrumPeak, SpectrumResult
from ..stream.stft import spectrogram as _spectrogram
from ..xform.fourier import bin_frequencies

__all__ = ["sharded_fir_filter", "sharded_spectrogram",
           "sharded_pfb_channelize",
           "sharded_pfb_channelize_frames",
           "sharded_channel_power", "sharded_upfirdn",
           "sharded_resample_poly", "sharded_wbfm_demod"]


def _last_axis_spec(nd: int, axis) -> P:
    return P(*([None] * (nd - 1) + [axis]))


def _axes(axis) -> Tuple[str, ...]:
    """Normalise a mesh-axis argument (name or tuple of names)."""
    return axis if isinstance(axis, tuple) else (axis,)


def _extent(mesh: Mesh, axis) -> int:
    return int(np.prod([mesh.shape[a] for a in _axes(axis)]))


def _flat_index(mesh: Mesh, axis):
    """Device position along the flattened joint axis (row-major over the
    tuple order, matching how a PartitionSpec tuple entry shards)."""
    axes = _axes(axis)
    idx = jax.lax.axis_index(axes[0])
    for a in axes[1:]:
        idx = idx * mesh.shape[a] + jax.lax.axis_index(a)
    return idx


@functools.lru_cache(maxsize=128)
def _build_sharded_fir(mesh: Mesh, axis, k: int, nd: int, method: str,
                       is_complex: bool):
    d = _extent(mesh, axis)

    def one_plane(xb, taps):
        tail = xb[..., xb.shape[-1] - (k - 1):]
        perm = [(i, (i + 1) % d) for i in range(d)]
        halo = jax.lax.ppermute(tail, axis, perm)
        is_first = _flat_index(mesh, axis) == 0
        halo = jnp.where(is_first, jnp.zeros_like(halo), halo)
        buf = jnp.concatenate([halo, xb], axis=-1)
        return fir_filter(buf, taps, method)[..., k - 1:]

    spec = _last_axis_spec(nd, axis)
    tspec = P(None)
    if is_complex:
        fn = shard_map(
            lambda r, i, taps: (one_plane(r, taps), one_plane(i, taps)),
            mesh=mesh, in_specs=(spec, spec, tspec),
            out_specs=(spec, spec), check_vma=False)
    else:
        fn = shard_map(one_plane, mesh=mesh, in_specs=(spec, tspec),
                       out_specs=spec, check_vma=False)
    return jax.jit(fn)


def sharded_fir_filter(x, taps, mesh: Mesh, axis="x",
                       method: str = "auto") -> Array:
    """Causal FIR of a time-block-sharded signal, exactly equal to the
    single-device result.

    x: [..., L] with the last axis sharded over ``axis`` in D contiguous
    blocks. Each device needs the previous block's last K-1 samples —
    one `ppermute` neighbour shift (the overlap-save halo, SURVEY.md §5
    long-context analogue); device 0's halo is the filter's zero initial
    state.
    """
    taps = jnp.asarray(taps)
    k = int(taps.shape[0])

    def _check(length):
        lloc = length // _extent(mesh, axis)
        if lloc < k - 1:
            # the halo slice would clamp and return silently wrong values
            raise ValueError(
                f"per-device block {lloc} must cover the K-1 = {k - 1}"
                "-sample filter history; use fewer devices or longer "
                "blocks")

    if isinstance(x, ComplexArray):
        _check(x.real.shape[-1])
        nd = x.real.ndim
        fn = _build_sharded_fir(mesh, axis, k, nd, method, True)
        ore, oim = fn(x.real, x.imag, taps)
        return ComplexArray(ore, oim)
    x = jnp.asarray(x)
    if jnp.iscomplexobj(x):
        return sharded_fir_filter(ComplexArray(x.real, x.imag), taps, mesh,
                                  axis, method)
    _check(x.shape[-1])
    fn = _build_sharded_fir(mesh, axis, k, x.ndim, method, False)
    return fn(x, taps)


@functools.lru_cache(maxsize=128)
def _build_sharded_spectrogram(mesh: Mesh, axis, n_fft: int, hop: int,
                               window: str, sample_rate: float, sides: str,
                               nd: int):
    d = _extent(mesh, axis)
    overlap = n_fft - hop

    def body(xb):
        # Pull the first `overlap` samples of the RIGHT neighbour so the
        # frames at our block boundary are complete; the last device
        # zero-pads (its trailing frames treat the stream end as zeros).
        head = xb[..., :overlap]
        perm = [(i, (i - 1) % d) for i in range(d)]
        halo = jax.lax.ppermute(head, axis, perm)
        is_last = _flat_index(mesh, axis) == d - 1
        halo = jnp.where(is_last, jnp.zeros_like(halo), halo)
        buf = jnp.concatenate([xb, halo], axis=-1)
        r = _spectrogram(buf, n_fft, hop, window, sample_rate, sides)
        return (r.amplitude, r.phase, r.peak.index, r.peak.frequency,
                r.peak.amplitude, r.peak.phase)

    in_spec = _last_axis_spec(nd, axis)
    frame_spec = P(*([None] * (nd - 1) + [axis, None]))
    peak_spec = _last_axis_spec(nd, axis)
    fn = shard_map(body, mesh=mesh, in_specs=(in_spec,),
                   out_specs=(frame_spec, frame_spec, peak_spec, peak_spec,
                              peak_spec, peak_spec),
                   check_vma=False)
    return jax.jit(fn)


def sharded_spectrogram(x, n_fft: int, hop: Optional[int] = None,
                        window: str = "hann", sample_rate: float = 1.0,
                        sides: str = "one", *, mesh: Mesh,
                        axis="x", pad_tail: bool = False
                        ) -> SpectrumResult:
    """Spectrogram with the time axis sharded in contiguous blocks.

    Frames never straddle shards thanks to a (n_fft - hop)-sample halo
    pulled from the right neighbour with `ppermute`. Per-shard frame
    counts stay static, so the whole thing jits. Local block length must
    be a multiple of hop. Result frames are sharded over ``axis``.

    By default the result is EXACTLY the single-device
    ``stream.spectrogram`` frame set (1 + (L - n_fft)//hop frames): the
    per-shard shapes stay uniform inside shard_map and the trailing
    (n_fft-hop)//hop frames — which would treat the stream end as
    zero-padded, since the last device has no right neighbour — are
    sliced off the global result. Pass ``pad_tail=True`` to keep them
    (L//hop frames total, zero-padded stream end), e.g. when a uniform
    frames-per-shard layout matters more than tail parity.
    """
    hop = hop if hop is not None else n_fft // 4
    x = jnp.asarray(x)
    d = _extent(mesh, axis)
    if x.shape[-1] // d < n_fft - hop:
        # the right-neighbour halo slice would clamp silently
        raise ValueError(
            f"per-device block {x.shape[-1] // d} must cover the "
            f"n_fft - hop = {n_fft - hop}-sample frame overlap; use "
            "fewer devices or longer blocks")
    if (x.shape[-1] // d) % hop != 0:
        raise ValueError(
            f"local block {x.shape[-1] // d} must be a multiple of hop {hop}")
    fn = _build_sharded_spectrogram(mesh, axis, n_fft, hop, window,
                                    float(sample_rate), sides, x.ndim)
    amp, ph, pidx, pfreq, pamp, pph = fn(x)
    if not pad_tail:
        n_exact = 1 + (x.shape[-1] - n_fft) // hop
        amp = amp[..., :n_exact, :]
        ph = ph[..., :n_exact, :]
        pidx = pidx[..., :n_exact]
        pfreq = pfreq[..., :n_exact]
        pamp = pamp[..., :n_exact]
        pph = pph[..., :n_exact]
    freqs = bin_frequencies(n_fft, sample_rate, sides, dtype=amp.dtype)
    return SpectrumResult(
        frequencies=freqs, amplitude=amp, phase=ph,
        peak=SpectrumPeak(index=pidx, frequency=pfreq, amplitude=pamp,
                          phase=pph))


@functools.lru_cache(maxsize=128)
def _build_sharded_pfb(mesh: Mesh, axis, channels: int, t_taps: int,
                       taps_per_branch: int, nd: int,
                       channels_sharded_out: bool):
    d = _extent(mesh, axis)
    hist = (t_taps - 1) * channels

    def body(xr, xi, taps):
        perm = [(i, (i + 1) % d) for i in range(d)]
        hr = jax.lax.ppermute(xr[..., xr.shape[-1] - hist:], axis, perm)
        hi = jax.lax.ppermute(xi[..., xi.shape[-1] - hist:], axis, perm)
        first = _flat_index(mesh, axis) == 0
        hr = jnp.where(first, jnp.zeros_like(hr), hr)
        hi = jnp.where(first, jnp.zeros_like(hi), hi)
        buf = ComplexArray(jnp.concatenate([hr, xr], axis=-1),
                           jnp.concatenate([hi, xi], axis=-1))
        y = pfb_channelize(buf, channels, taps, taps_per_branch)
        # Drop the T-1 warm-up frames recomputed from the halo.
        yr = y.real[..., t_taps - 1:, :]
        yi = y.imag[..., t_taps - 1:, :]
        if channels_sharded_out:
            # Corner turn: frames-sharded (M/D, C) -> channels-sharded
            # (M, C/D): one tiled all_to_all over the mesh axis.
            yr = jax.lax.all_to_all(yr, axis, split_axis=yr.ndim - 1,
                                    concat_axis=yr.ndim - 2, tiled=True)
            yi = jax.lax.all_to_all(yi, axis, split_axis=yi.ndim - 1,
                                    concat_axis=yi.ndim - 2, tiled=True)
        return yr, yi

    in_spec = _last_axis_spec(nd, axis)
    if channels_sharded_out:
        out_spec = P(*([None] * (nd - 1) + [None, axis]))
    else:
        out_spec = P(*([None] * (nd - 1) + [axis, None]))
    fn = shard_map(body, mesh=mesh, in_specs=(in_spec, in_spec, P(None)),
                   out_specs=(out_spec, out_spec), check_vma=False)
    return jax.jit(fn)


def sharded_pfb_channelize(x, channels: int, taps=None,
                           taps_per_branch: int = 8, *, mesh: Mesh,
                           axis="x",
                           channels_sharded_out: bool = True) -> ComplexArray:
    """PFB channelizer with the time axis sharded; one all_to_all corner
    turn reshards the output so each device owns C/D whole channels
    (BASELINE config 5's layout for per-channel downstream DSP).

    Input [..., L] complex, L/D a multiple of C. Branch history crosses
    shard boundaries via a (T-1)*C-sample `ppermute` halo, so the result
    equals the single-device channelizer exactly.
    """
    xc = as_complex_array(x)
    if taps is None:
        taps = pfb_taps(channels, taps_per_branch)
    taps = jnp.asarray(np.asarray(taps, dtype=np.float64))
    t_taps = -(-int(taps.shape[0]) // channels)
    d = _extent(mesh, axis)
    lloc = xc.real.shape[-1] // d
    if lloc % channels != 0:
        raise ValueError(
            f"per-device block {lloc} must be a multiple of "
            f"channels={channels}")
    if lloc < (t_taps - 1) * channels:
        # the halo slice would clamp and return silently wrong values
        raise ValueError(
            f"per-device block {lloc} must cover the "
            f"{(t_taps - 1) * channels}-sample branch history "
            f"(T={t_taps} taps/branch); use fewer devices or longer "
            "blocks")
    fn = _build_sharded_pfb(mesh, axis, channels, t_taps, taps_per_branch,
                            xc.real.ndim, channels_sharded_out)
    ore, oim = fn(xc.real, xc.imag, taps)
    return ComplexArray(ore, oim)


def _check_pfb_frames_block(xc, mesh, axis, t_taps):
    """The (T-1)-frame halo slice clamps silently when a shard holds
    fewer frames than the branch history — reject instead."""
    d = _extent(mesh, axis)
    mloc = xc.real.shape[-2] // d
    if mloc < t_taps - 1:
        raise ValueError(
            f"per-device frame count {mloc} must cover the "
            f"{t_taps - 1}-frame branch history (T={t_taps} "
            "taps/branch); use fewer devices or more frames")


def _pfb_frames_local(xr, xi, taps, *, mesh, axis, d, hist, channels,
                      taps_per_branch):
    """Inside shard_map: (T-1)-frame ppermute halo + local frames-path
    channelizer + warm-up drop. Returns the frames-sharded (Mloc, C)
    channel planes, exact vs the single-device pfb_channelize_frames."""
    perm = [(i, (i + 1) % d) for i in range(d)]
    hr = jax.lax.ppermute(xr[..., xr.shape[-2] - hist:, :], axis, perm)
    hi = jax.lax.ppermute(xi[..., xi.shape[-2] - hist:, :], axis, perm)
    first = _flat_index(mesh, axis) == 0
    hr = jnp.where(first, jnp.zeros_like(hr), hr)
    hi = jnp.where(first, jnp.zeros_like(hi), hi)
    buf = ComplexArray(jnp.concatenate([hr, xr], axis=-2),
                       jnp.concatenate([hi, xi], axis=-2))
    y = pfb_channelize_frames(buf, channels, taps, taps_per_branch)
    # Drop the T-1 warm-up frames recomputed from the halo.
    return y.real[..., hist:, :], y.imag[..., hist:, :]


@functools.lru_cache(maxsize=128)
def _build_sharded_pfb_frames(mesh: Mesh, axis, channels: int, t_taps: int,
                              taps_per_branch: int, nd: int,
                              channels_sharded_out: bool):
    d = _extent(mesh, axis)
    hist = t_taps - 1                    # branch history in FRAMES

    def body(xr, xi, taps):
        yr, yi = _pfb_frames_local(xr, xi, taps, mesh=mesh, axis=axis,
                                   d=d, hist=hist, channels=channels,
                                   taps_per_branch=taps_per_branch)
        if channels_sharded_out:
            # Corner turn: frames-sharded (M/D, C) -> channels-sharded
            # (M, C/D): one tiled all_to_all over the mesh axis.
            yr = jax.lax.all_to_all(yr, axis, split_axis=yr.ndim - 1,
                                    concat_axis=yr.ndim - 2, tiled=True)
            yi = jax.lax.all_to_all(yi, axis, split_axis=yi.ndim - 1,
                                    concat_axis=yi.ndim - 2, tiled=True)
        return yr, yi

    in_spec = P(*([None] * (nd - 2) + [axis, None]))
    if channels_sharded_out:
        out_spec = P(*([None] * (nd - 2) + [None, axis]))
    else:
        out_spec = in_spec
    fn = shard_map(body, mesh=mesh, in_specs=(in_spec, in_spec, P(None)),
                   out_specs=(out_spec, out_spec), check_vma=False)
    return jax.jit(fn)


def sharded_pfb_channelize_frames(x, channels: int, taps=None,
                                  taps_per_branch: int = 8, *, mesh: Mesh,
                                  axis="x",
                                  channels_sharded_out: bool = True
                                  ) -> ComplexArray:
    """PFB channelizer over an (M, C)-frame view with the FRAME axis
    sharded — the no-relayout variant of ``sharded_pfb_channelize`` for
    pipelines whose upstream already holds frames (chunked streaming,
    config-5 ingest): each shard feeds the fused kernel its fast
    frames-shaped path (the flat entry pays a 1-D -> 2-D relayout into
    the frame view).

    Input [..., M, C] complex frames, M/D a multiple of 1 (any M that
    shards evenly). Branch history crosses shard boundaries as a
    (T-1)-frame `ppermute` halo, so the result equals the single-device
    ``pfb_channelize_frames`` exactly. With ``channels_sharded_out``
    (default) one all_to_all corner turn reshards the output so each
    device owns C/D whole channels; pass False to keep frames sharded —
    the layout that skips the fat collective entirely (see
    ``sharded_channel_power``).
    """
    xc = as_complex_array(x)
    if xc.real.ndim < 2 or xc.real.shape[-1] != channels:
        raise ValueError(
            f"frames input must be [..., M, {channels}], "
            f"got {xc.real.shape}")
    if taps is None:
        taps = pfb_taps(channels, taps_per_branch)
    taps = jnp.asarray(np.asarray(taps, dtype=np.float64))
    t_taps = -(-int(taps.shape[0]) // channels)
    _check_pfb_frames_block(xc, mesh, axis, t_taps)
    fn = _build_sharded_pfb_frames(mesh, axis, channels, t_taps,
                                   taps_per_branch, xc.real.ndim,
                                   channels_sharded_out)
    ore, oim = fn(xc.real, xc.imag, taps)
    return ComplexArray(ore, oim)


@functools.lru_cache(maxsize=64)
def _build_sharded_channel_power(mesh: Mesh, axis, channels: int,
                                 t_taps: int, taps_per_branch: int,
                                 n_fft: int, window: str, nd: int):
    from ..xform.fourier import create_window, window_values
    from ..ops.dispatch import fft as _fft

    d = _extent(mesh, axis)
    hist = t_taps - 1
    # window power in f64 numpy at build time (a jnp f64 cast would
    # warn/truncate on non-x64 runtimes)
    wpow = float(np.sum(np.asarray(window_values(window, n_fft),
                                   np.float64) ** 2))

    def body(xr, xi, taps):
        yr, yi = _pfb_frames_local(xr, xi, taps, mesh=mesh, axis=axis,
                                   d=d, hist=hist, channels=channels,
                                   taps_per_branch=taps_per_branch)
        # Per-channel Welch periodogram over the LOCAL frames: segments
        # of n_fft consecutive channel samples along the frame axis,
        # windowed, FFT over axis -2 (the C channels are the batch),
        # magnitude-squared, summed.
        mloc = yr.shape[-2]
        nseg = mloc // n_fft
        lead = yr.shape[:-2]
        sr = yr[..., : nseg * n_fft, :].reshape(
            lead + (nseg, n_fft, channels))
        si = yi[..., : nseg * n_fft, :].reshape(
            lead + (nseg, n_fft, channels))
        w = create_window(window, n_fft, dtype=sr.dtype)[:, None]
        spec = _fft(ComplexArray(sr * w, si * w), axis=-2)
        p = jnp.sum(spec.real * spec.real + spec.imag * spec.imag,
                    axis=-3)
        # The only cross-shard combine: a psum of n_fft*C floats —
        # bytes independent of stream length, vs the corner turn's
        # 8 B/sample all_to_all. This is the config-5 no-turn layout
        # consumed end-to-end.
        p = jax.lax.psum(p, axis)
        return p / (d * nseg * n_fft * wpow)

    in_spec = P(*([None] * (nd - 2) + [axis, None]))
    out_spec = P(*([None] * nd))         # replicated [n_fft, C] PSD
    fn = shard_map(body, mesh=mesh, in_specs=(in_spec, in_spec, P(None)),
                   out_specs=out_spec, check_vma=False)
    return jax.jit(fn)


def sharded_channel_power(x, channels: int, taps=None,
                          taps_per_branch: int = 8, *, mesh: Mesh,
                          axis="x", n_fft: int = 128,
                          window: str = "hann") -> Array:
    """Per-channel Welch power spectra consuming the frames-sharded PFB
    output IN PLACE — the config-5 no-turn pipeline (the running
    downstream consumer of ``channels_sharded_out=False``).

    Input [..., M, C] complex IQ frames with the frame axis sharded;
    each device channelizes its block locally (frames-path kernel, no
    relayout), computes per-channel segment periodograms over its own
    frames, and the ONLY cross-shard communication is a psum of the
    [n_fft, C] power accumulator — no all_to_all corner turn anywhere,
    so nothing fat ever crosses hosts on a (host, chip) mesh.

    Returns [..., n_fft, C]: bin k of channel c is the mean
    ``|FFT_k(w * y_seg[:, c])|^2 / (n_fft * sum(w^2))`` over all
    ``M // n_fft`` non-overlapping segments (Welch with zero overlap).
    ``n_fft`` must divide the per-device frame count M/D so device-local
    segments ARE the global segments — the property that makes the
    whole reduction local.
    """
    xc = as_complex_array(x)
    if xc.real.ndim < 2 or xc.real.shape[-1] != channels:
        raise ValueError(
            f"frames input must be [..., M, {channels}], "
            f"got {xc.real.shape}")
    if taps is None:
        taps = pfb_taps(channels, taps_per_branch)
    taps = jnp.asarray(np.asarray(taps, dtype=np.float64))
    t_taps = -(-int(taps.shape[0]) // channels)
    _check_pfb_frames_block(xc, mesh, axis, t_taps)
    d = _extent(mesh, axis)
    mloc = xc.real.shape[-2] // d
    if mloc % n_fft != 0:
        raise ValueError(
            f"per-device frame count {mloc} must be a multiple of "
            f"n_fft={n_fft} (local segments must tile the stream)")
    fn = _build_sharded_channel_power(mesh, axis, channels, t_taps,
                                      taps_per_branch, n_fft, window,
                                      xc.real.ndim)
    return fn(xc.real, xc.imag, taps)


@functools.lru_cache(maxsize=64)
def _build_sharded_upfirdn(mesh: Mesh, axis, taps_bytes: bytes, k: int,
                           up: int, down: int, nd: int, is_complex: bool):
    from ..ops.polyphase import _upfirdn_history, upfirdn

    # Taps close over the builder as a CONCRETE numpy array: passing
    # them as a shard_map argument would trace them and silently knock
    # upfirdn off its banded-matmul path onto the dilated-conv
    # fallback (jaxpr-guarded in tests).
    taps_np = np.frombuffer(taps_bytes, dtype=np.float64).copy()
    d = _extent(mesh, axis)
    hist = _upfirdn_history(k, up, down)
    start = hist * up // down

    def one_plane(xb):
        tail = xb[..., xb.shape[-1] - hist:]
        perm = [(i, (i + 1) % d) for i in range(d)]
        halo = jax.lax.ppermute(tail, axis, perm)
        is_first = _flat_index(mesh, axis) == 0
        halo = jnp.where(is_first, jnp.zeros_like(halo), halo)
        buf = jnp.concatenate([halo, xb], axis=-1)
        full = upfirdn(buf, taps_np, up, down)
        count = xb.shape[-1] * up // down
        return full[..., start:start + count]

    spec = _last_axis_spec(nd, axis)
    if is_complex:
        fn = shard_map(lambda r, i: (one_plane(r), one_plane(i)),
                       mesh=mesh, in_specs=(spec, spec),
                       out_specs=(spec, spec), check_vma=False)
    else:
        fn = shard_map(one_plane, mesh=mesh, in_specs=(spec,),
                       out_specs=spec, check_vma=False)
    return jax.jit(fn)


def sharded_upfirdn(x, taps, up: int = 1, down: int = 1, *, mesh: Mesh,
                    axis="x") -> Array:
    """scipy-semantics ``upfirdn`` with the time axis sharded in D
    contiguous blocks, equal to the PREFIX of the single-device result
    (the filter ring-out tail — the last ceil((K-up)/down) samples,
    which depend on input that hasn't arrived — is omitted, the same
    streaming-prefix contract as ``ops.upfirdn_step``).

    Each device pulls the previous block's last ``history`` input
    samples with one `ppermute` (history rounded up so the polyphase
    decimation grid realigns exactly: history*up % down == 0 — the
    quantum-aligned-shift property the WBFM chain also relies on) and
    drops the recomputed warm-up outputs. The per-device block length
    must satisfy (L/D)*up % down == 0 so every shard emits a static,
    equal output count.
    """
    taps_np = np.asarray(taps, dtype=np.float64)
    k = int(taps_np.shape[0])
    from ..ops.polyphase import _upfirdn_history

    d = _extent(mesh, axis)
    is_complex = isinstance(x, ComplexArray) or jnp.iscomplexobj(x)
    xc = as_complex_array(x) if is_complex else None
    length = (xc.real if is_complex else jnp.asarray(x)).shape[-1]
    lloc = length // d
    if (lloc * up) % down != 0:
        raise ValueError(
            f"per-device block {lloc} must satisfy block*{up} % "
            f"{down} == 0")
    hist = _upfirdn_history(k, up, down)
    if lloc < hist:
        # The halo slice would clamp and return silently wrong values.
        raise ValueError(
            f"per-device block {lloc} must cover the {hist}-sample "
            f"quantum-aligned filter history (len(taps)={k}, up={up}, "
            f"down={down}); use fewer devices or longer blocks")
    if is_complex:
        fn = _build_sharded_upfirdn(mesh, axis, taps_np.tobytes(), k, up,
                                    down, xc.real.ndim, True)
        ore, oim = fn(xc.real, xc.imag)
        return ComplexArray(ore, oim)
    fn = _build_sharded_upfirdn(mesh, axis, taps_np.tobytes(), k, up,
                                down, jnp.asarray(x).ndim, False)
    return fn(jnp.asarray(x))


def sharded_resample_poly(x, up: int, down: int, taps=None,
                          num_taps: int = 127, *, mesh: Mesh,
                          axis="x") -> Array:
    """Time-sharded rational resampler (config 3 at the "1 host" scale):
    ``ops.resample_poly`` semantics over a block-sharded stream, exact
    prefix of the single-device result (see ``sharded_upfirdn``)."""
    import math as _math

    from ..ops.polyphase import resampler_taps

    g = _math.gcd(up, down)
    up //= g
    down //= g
    if taps is None:
        taps = resampler_taps(up, down, num_taps)
    return sharded_upfirdn(x, taps, up, down, mesh=mesh, axis=axis)


@functools.lru_cache(maxsize=32)
def _build_sharded_wbfm(mesh: Mesh, axis, config, halo: int, nd: int):
    from ..models.fm_receiver import FmReceiver

    rx = FmReceiver(config)
    q = rx.chunk_quantum
    d = _extent(mesh, axis)
    skip = (halo // q) * rx._up          # warm-up audio samples to drop

    def body(xr, xi):
        nloc = (xr.shape[-1] // q) * rx._up
        perm = [(i, (i + 1) % d) for i in range(d)]
        hr = jax.lax.ppermute(xr[..., xr.shape[-1] - halo:], axis, perm)
        hi = jax.lax.ppermute(xi[..., xi.shape[-1] - halo:], axis, perm)
        first = _flat_index(mesh, axis) == 0
        hr = jnp.where(first, jnp.zeros_like(hr), hr)
        hi = jnp.where(first, jnp.zeros_like(hi), hi)
        buf = ComplexArray(jnp.concatenate([hr, xr], axis=-1),
                           jnp.concatenate([hi, xi], axis=-1))
        # Device 0's halo is zero-fill (the stream's true start), which
        # keeps the channel FIR exactly equal to the batch chain's
        # implicit zero history — but leaves the discriminator's
        # boundary dphi as atan2(+-0, +-0) instead of the batch
        # stream-start convention angle(chan[0]); stream_start_if
        # recomputes that one IF sample inside the receiver, gated to
        # device 0.
        audio = rx(buf, stream_start_if=halo // rx._decim1,
                   stream_start_mask=first)
        return audio[..., skip:skip + nloc]

    spec = _last_axis_spec(nd, axis)
    fn = shard_map(body, mesh=mesh, in_specs=(spec, spec),
                   out_specs=spec, check_vma=False)
    return jax.jit(fn)


def sharded_wbfm_demod(iq, mesh: Mesh, axis="x", config=None,
                       halo: int = 8192) -> Array:
    """WBFM receiver chain (BASELINE config 4) with the IQ time axis
    sharded in contiguous blocks — the "1 host" scale of config 4.

    Unlike the FIR/PFB pipelines, whose state is finite (K-1 samples),
    the receiver contains an IIR (de-emphasis) whose state is infinite
    but exponentially decaying, so exact halo exchange is impossible and
    a WARM-UP halo is used instead: each device pulls the previous
    block's last ``halo`` IQ samples with one `ppermute`, runs the whole
    chain locally from zero state, and drops the warm-up portion of the
    audio. Both resampler stages commute with quantum-aligned shifts
    (the polyphase decimation grids realign exactly when the shift is a
    multiple of ``FmReceiver.chunk_quantum``), and the de-emphasis
    transient decays as alpha^m — at the default 75 us / 240 kHz IF,
    alpha**(halo/decim - audio_taps) ~ 2e-17 for halo=8200, below even
    f64 round-off. Device 0's halo is zero-fill (the true stream start),
    which keeps its channel FIR bit-equal to the batch chain; the one
    convention-sensitive sample — the discriminator's boundary dphi,
    whose previous sample the batch chain takes as 1+0j — is recomputed
    inside the receiver (``FmReceiver.__call__(stream_start_if=...)``),
    so the parity below holds from the very first audio sample. Result:
    the exact steady-state audio prefix of
    `models.fm_receiver.wbfm_demod`, length (L // quantum) * up per
    signal (ring-out tail samples omitted, matching the streaming
    interface's prefix contract).

    Local block length L/D must be a multiple of the quantum and >= the
    (rounded-up) halo.
    """
    from ..models.fm_receiver import FmReceiver, FmReceiverConfig

    config = FmReceiverConfig() if config is None else config
    rx = FmReceiver(config)
    q = rx.chunk_quantum
    halo = -(-halo // q) * q
    xc = as_complex_array(iq)
    d = _extent(mesh, axis)
    lloc = xc.real.shape[-1] // d
    if xc.real.shape[-1] % d != 0 or lloc % q != 0:
        raise ValueError(
            f"signal length {xc.real.shape[-1]} must split into D={d} "
            f"blocks of a multiple of the chunk quantum {q}")
    if lloc < halo:
        raise ValueError(
            f"local block {lloc} shorter than the warm-up halo {halo}")
    fn = _build_sharded_wbfm(mesh, axis, config, halo, xc.real.ndim)
    return fn(xc.real, xc.imag)
