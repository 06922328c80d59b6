"""Wideband-FM broadcast receiver chain (BASELINE.json config 4).

IQ at ``iq_rate`` (e.g. 2.4 Msps) -> channel lowpass + decimate to
``if_rate`` -> quadrature discriminator -> de-emphasis -> resample to
``audio_rate``. Every stage is a batched jit-compilable array op; the
whole chain compiles to one XLA program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.complex import Array, ComplexArray, as_complex_array
from ..ops.demod import (FmDemodState, fm_discriminate, fm_stream_init,
                         fm_discriminate_step, deemphasis, iir_one_pole)
from ..ops.polyphase import (UpfirdnState, design_lowpass, resample_poly,
                             upfirdn, upfirdn_step, upfirdn_stream_init)

__all__ = ["FmReceiverConfig", "FmReceiver", "wbfm_demod",
           "WbfmStreamState"]


@dataclass(frozen=True)
class FmReceiverConfig:
    iq_rate: float = 2.4e6
    if_rate: float = 240e3          # post-channel-filter rate
    audio_rate: float = 48e3
    deviation: float = 75e3         # broadcast FM
    channel_taps: int = 127
    audio_taps: int = 127
    deemphasis_tau: Optional[float] = 75e-6

    def __post_init__(self):
        if self.iq_rate % self.if_rate != 0:
            raise ValueError("iq_rate must be an integer multiple of if_rate")


class WbfmStreamState(NamedTuple):
    """Full receiver carry: channel-filter tails (re/im), last IQ sample
    for the discriminator, de-emphasis IIR state, audio-resampler tail."""

    chan_re: UpfirdnState
    chan_im: UpfirdnState
    disc: FmDemodState
    deemph_y: Array
    audio: UpfirdnState


class FmReceiver:
    """Config-driven WBFM receiver; call with IQ [..., L]."""

    def __init__(self, config: FmReceiverConfig = FmReceiverConfig()):
        self.config = config
        c = config
        self._decim1 = int(c.iq_rate // c.if_rate)
        # Channel filter: keep ~200 kHz FM channel, cutoff at new Nyquist.
        self._chan_taps = design_lowpass(c.channel_taps, 1.0 / self._decim1)
        frac = c.audio_rate / c.if_rate
        g = math.gcd(int(c.audio_rate), int(c.if_rate))
        self._up = int(c.audio_rate) // g
        self._down = int(c.if_rate) // g
        audio_cut = min(1.0 / self._up, 1.0 / self._down)
        self._audio_taps = design_lowpass(
            c.audio_taps * max(1, self._up), audio_cut) * self._up

    def __call__(self, iq, *, stream_start_if: Optional[int] = None,
                 stream_start_mask=None) -> Array:
        """Demodulate IQ [..., L] to audio.

        ``stream_start_if`` marks IF sample index i as the TRUE stream
        start for the discriminator when the leading IQ samples are
        zero-fill warm-up (the sharded warm-up-halo path,
        parallel.sharded_wbfm_demod): the channel FIR of an all-zero
        halo is exactly 0, so dphi[i] would be atan2(+-0, +-0) — a
        sign-of-zero lottery over {0, +-pi} — instead of the batch
        convention angle(chan[i] * conj(1+0j)) (_phase_diff's implicit
        x[-1] = 1+0j). The sample is recomputed with that convention,
        bit-identical to the batch chain for nonzero chan[i].
        ``stream_start_mask`` (traced bool, e.g. axis_index()==0 inside
        shard_map) gates the fix per device.
        """
        c = self.config
        xc = as_complex_array(iq)
        # 1. channel select: lowpass + decimate in one polyphase pass.
        # Taps stay numpy: converting them with jnp.asarray here would
        # yield a TRACER when __call__ runs under an outer jit, and
        # upfirdn's banded-matmul path (which needs concrete taps) would
        # silently fall back to the dilated conv.
        chan = upfirdn(xc, self._chan_taps, 1, self._decim1)
        # 2. discriminator -> baseband audio at if_rate, normalised
        audio_if = fm_discriminate(chan, sample_rate=c.if_rate,
                                   deviation=c.deviation)
        if stream_start_if is not None and stream_start_if > 0:
            i = stream_start_if
            # Same rounding ORDER as fm_discriminate (multiply by
            # fs/(2 pi), then divide by deviation) so the recomputed
            # sample is bit-identical to the batch chain, not ~1 ulp
            # off from a pre-combined scale.
            fix = (jnp.arctan2(chan.imag[..., i], chan.real[..., i])
                   * (c.if_rate / (2.0 * np.pi))) / c.deviation
            if stream_start_mask is not None:
                fix = jnp.where(stream_start_mask, fix, audio_if[..., i])
            audio_if = audio_if.at[..., i].set(fix)
        # 3. de-emphasis
        if c.deemphasis_tau is not None:
            audio_if = deemphasis(audio_if, c.if_rate, c.deemphasis_tau)
        # 4. resample to audio rate
        audio = upfirdn(audio_if, self._audio_taps,
                        self._up, self._down)
        return audio



    # ── streaming (chunked) interface ────────────────────────────────

    @property
    def chunk_quantum(self) -> int:
        """IQ samples per chunk must be a multiple of this (decimation x
        audio down-ratio so both resampler grids stay aligned)."""
        return self._decim1 * self._down

    def stream_init(self, batch_shape: Tuple[int, ...] = (),
                    dtype=jnp.float32) -> "WbfmStreamState":
        """Zero (cold-start) state, matching the batch chain's implicit
        zero history."""
        return WbfmStreamState(
            chan_re=upfirdn_stream_init(self._chan_taps, 1, self._decim1,
                                        batch_shape, dtype),
            chan_im=upfirdn_stream_init(self._chan_taps, 1, self._decim1,
                                        batch_shape, dtype),
            disc=fm_stream_init(batch_shape, dtype),
            deemph_y=jnp.zeros(batch_shape + (1,), dtype=dtype),
            audio=upfirdn_stream_init(self._audio_taps, self._up, self._down,
                                      batch_shape, dtype),
        )

    def stream_step(self, state: "WbfmStreamState", iq_chunk):
        """Process one IQ chunk; concatenated outputs equal the PREFIX of
        the batch ``FmReceiver.__call__`` over the concatenated stream
        (the filter ring-out tails are emitted as later chunks arrive).
        lax.scan-compatible; donate the state via
        ``stream.jit_stream_step`` for an allocation-free chunk loop.
        """
        c = self.config
        xc = as_complex_array(iq_chunk)
        if xc.real.shape[-1] % self.chunk_quantum != 0:
            raise ValueError(
                f"chunk length {xc.real.shape[-1]} must be a multiple of "
                f"{self.chunk_quantum}")
        taps = self._chan_taps  # numpy: keeps upfirdn's banded path under jit
        cr, yr = upfirdn_step(state.chan_re, xc.real, taps, 1, self._decim1)
        ci, yi = upfirdn_step(state.chan_im, xc.imag, taps, 1, self._decim1)
        chan = ComplexArray(yr, yi)
        disc, dphi_hz = fm_discriminate_step(state.disc, chan,
                                             sample_rate=c.if_rate,
                                             deviation=c.deviation)
        audio_if = dphi_hz
        deemph_y = state.deemph_y
        if c.deemphasis_tau is not None:
            alpha = float(np.exp(-1.0 / (c.if_rate * c.deemphasis_tau)))
            audio_if = iir_one_pole(audio_if, alpha, y0=deemph_y)
            deemph_y = audio_if[..., -1:]
        ast, audio = upfirdn_step(state.audio, audio_if,
                                  self._audio_taps,
                                  self._up, self._down)
        return WbfmStreamState(chan_re=cr, chan_im=ci, disc=disc,
                               deemph_y=deemph_y, audio=ast), audio


def wbfm_demod(iq, iq_rate: float = 2.4e6, audio_rate: float = 48e3,
               deviation: float = 75e3) -> Array:
    """One-call WBFM demodulation with default chain parameters."""
    cfg = FmReceiverConfig(iq_rate=iq_rate, audio_rate=audio_rate,
                           deviation=deviation)
    return FmReceiver(cfg)(iq)
