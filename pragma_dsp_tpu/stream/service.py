"""Caching Fourier service + streaming spectrum — the Effect-rung analogue.

The reference wraps plan/window caching and streaming in Effect-TS
(reference src/effect/index.ts:17-194): a ``Fourier`` service Tag, a
``FourierLive`` layer caching FFT instances by size and windows by
"type:size", ``spectrumFx`` and ``spectrumStream``. There is no effect
system here — the equivalents are a plain caching service
object (JAX's jit cache already memoises compiled kernels; the service
additionally memoises plan objects and window buffers) and Python
iterators for streams. For real throughput use the batched
``pragma_dsp_tpu.stream.stft`` path instead of per-frame streaming.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Optional, Tuple

import jax.numpy as jnp

from ..core.complex import Array, next_power_of_two
from ..public.spectrum import SpectrumResult, spectrum as _spectrum
from ..xform.fourier import FFT, create_window

__all__ = ["FourierService", "default_service", "spectrum_fx", "spectrum_stream"]


class FourierService:
    """Plan + window cache (reference FourierLive, src/effect/index.ts:27-51).

    ``fft(size)`` returns the same FFT instance for the same size;
    ``window(type, size)`` returns the same device buffer for the same key —
    cache-identity semantics the reference tests assert (effect.test.ts).
    """

    def __init__(self, dtype=jnp.float32):
        self._dtype = dtype
        self._fft_cache: Dict[int, FFT] = {}
        self._window_cache: Dict[Tuple[str, int], Array] = {}

    def fft(self, size: int) -> FFT:
        plan = self._fft_cache.get(size)
        if plan is None:
            plan = FFT(size)
            self._fft_cache[size] = plan
        return plan

    def window(self, window_type: str, size: int) -> Array:
        key = (window_type, size)
        win = self._window_cache.get(key)
        if win is None:
            win = create_window(window_type, size, dtype=self._dtype)
            self._window_cache[key] = win
        return win


_default_service: Optional[FourierService] = None


def default_service() -> FourierService:
    global _default_service
    if _default_service is None:
        _default_service = FourierService()
    return _default_service


def spectrum_fx(samples, *, service: Optional[FourierService] = None,
                sample_rate: float = 1.0, fft_size: Optional[int] = None,
                window: str = "rect", sides: str = "one") -> SpectrumResult:
    """Service-backed spectrum (reference spectrumFx, effect/index.ts:181-188).

    The reference duplicates the whole pipeline inside the effect module
    and asserts byte-parity with spectrum(); here there is exactly one
    pipeline — the service supplies the (cached) plan and window, and the
    computation is shared with :func:`pragma_dsp_tpu.spectrum`, so parity
    holds by construction.
    """
    svc = service if service is not None else default_service()
    target = fft_size if fft_size is not None else next_power_of_two(
        jnp.asarray(samples).shape[-1])
    svc.fft(target)          # warm/identity-cache the plan
    svc.window(window, target)
    return _spectrum(samples, sample_rate=sample_rate, fft_size=target,
                     window=window, sides=sides)


def spectrum_stream(frames: Iterable, *, service: Optional[FourierService] = None,
                    sample_rate: float = 1.0, fft_size: Optional[int] = None,
                    window: str = "rect", sides: str = "one",
                    ) -> Iterator[SpectrumResult]:
    """Lazily map spectrum_fx over an iterable of frames
    (reference spectrumStream, effect/index.ts:190-194).

    For throughput prefer stacking frames into a batch and calling
    ``spectrum`` once — per-frame iteration exists for API parity and
    interactive use.
    """
    svc = service if service is not None else default_service()
    for frame in frames:
        yield spectrum_fx(frame, service=svc, sample_rate=sample_rate,
                          fft_size=fft_size, window=window, sides=sides)
