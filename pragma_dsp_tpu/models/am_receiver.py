"""AM envelope receiver chain: IQ -> channel filter + decimate ->
envelope detector -> DC block -> audio resample.

The AM counterpart of models/fm_receiver.py; same batched one-XLA-program
structure.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ..core.complex import Array, as_complex_array
from ..ops.demod import am_demod
from ..ops.polyphase import design_lowpass, upfirdn

__all__ = ["AmReceiverConfig", "AmReceiver", "am_receive"]


@dataclass(frozen=True)
class AmReceiverConfig:
    iq_rate: float = 960e3
    if_rate: float = 96e3
    audio_rate: float = 48e3
    channel_taps: int = 127
    audio_taps: int = 127

    def __post_init__(self):
        if self.iq_rate % self.if_rate != 0:
            raise ValueError("iq_rate must be an integer multiple of if_rate")


class AmReceiver:
    """Config-driven AM envelope receiver; call with IQ [..., L]."""

    def __init__(self, config: AmReceiverConfig = AmReceiverConfig()):
        self.config = config
        c = config
        self._decim1 = int(c.iq_rate // c.if_rate)
        self._chan_taps = design_lowpass(c.channel_taps, 1.0 / self._decim1)
        g = math.gcd(int(c.audio_rate), int(c.if_rate))
        self._up = int(c.audio_rate) // g
        self._down = int(c.if_rate) // g
        cut = min(1.0 / max(self._up, 1), 1.0 / max(self._down, 1))
        self._audio_taps = design_lowpass(
            c.audio_taps * max(1, self._up), cut) * self._up

    def __call__(self, iq) -> Array:
        xc = as_complex_array(iq)
        # Taps stay numpy (see fm_receiver.__call__): an in-trace
        # jnp.asarray would trace them and knock upfirdn off its
        # banded-matmul path.
        chan = upfirdn(xc, self._chan_taps, 1, self._decim1)
        env = am_demod(chan, remove_dc=True)
        return upfirdn(env, self._audio_taps,
                       self._up, self._down)


def am_receive(iq, iq_rate: float = 960e3, audio_rate: float = 48e3) -> Array:
    """One-call AM demodulation with default chain parameters."""
    return AmReceiver(AmReceiverConfig(iq_rate=iq_rate,
                                       audio_rate=audio_rate))(iq)
