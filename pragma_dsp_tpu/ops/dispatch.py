"""FFT implementation dispatch: the one place that picks a path per platform.

Two interchangeable implementations, both locked to the numpy convention
(forward unnormalised, inverse 1/N) and validated against the same
fixtures:

* ``xla``      — ``jnp.fft`` on complex64/complex128 (cuFFT on the GPU).
  The split planes are joined into a complex array at the boundary and
  split again on the way out.
* ``stockham`` — pure jnp radix-2 recursion (core/fft.py). Works on every
  backend and dtype (incl. f64 on CPU); the correctness reference.

Policy (:func:`policy`): ``stockham`` on the CPU, so the f64 fixture
tests keep comparing against the independent radix-2 reference; ``xla``
on the GPU, where it beat ``stockham`` (and a dense-matmul four-step
route, since removed) at every size measured (PERF.md, FFT routes).
Any other platform raises. Override globally with :func:`set_fft_impl`
or per call via ``impl=``.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..core.complex import ComplexArray, as_complex_array, is_power_of_two
from ..core.fft import fft as _fft_stockham, ifft as _ifft_stockham

__all__ = ["fft", "ifft", "set_fft_impl", "get_fft_impl", "policy",
           "fft_route"]

_IMPLS = ("auto", "xla", "stockham")
_impl = "auto"


def set_fft_impl(impl: str) -> None:
    """Globally select the FFT implementation ('auto' restores policy)."""
    global _impl
    if impl not in _IMPLS:
        raise ValueError(f"unknown fft impl {impl!r}; choose from {_IMPLS}")
    _impl = impl


def get_fft_impl() -> str:
    return _impl


def policy(platform: str) -> str:
    """The implementation 'auto' picks on ``platform`` (a
    ``jax.default_backend()`` name)."""
    if platform == "cpu":
        return "stockham"
    if platform == "gpu":
        return "xla"
    raise ValueError(
        f"no FFT policy for platform {platform!r}; known: 'cpu', 'gpu'")


def fft_route() -> str:
    """The implementation :func:`fft` uses now (global override or the
    policy for the default backend)."""
    return _impl if _impl != "auto" else policy(jax.default_backend())


def _xla(xc: ComplexArray, axis: int, inverse: bool) -> ComplexArray:
    dtype = xc.real.dtype
    # jnp.fft needs complex64/complex128; bf16 rides f32 and casts back.
    wide = dtype if dtype in (jnp.float32, jnp.float64) else jnp.float32
    z = jax.lax.complex(xc.real.astype(wide), xc.imag.astype(wide))
    out = jnp.fft.ifft(z, axis=axis) if inverse else jnp.fft.fft(z, axis=axis)
    return ComplexArray(jnp.real(out).astype(dtype),
                        jnp.imag(out).astype(dtype))


def _run(x, axis: int, impl: Optional[str], inverse: bool) -> ComplexArray:
    xc = as_complex_array(x)
    n = xc.real.shape[axis]
    if not is_power_of_two(n):
        raise ValueError(f"FFT size must be power of two, got {n}")
    chosen = impl if impl is not None else fft_route()
    if chosen == "xla":
        return _xla(xc, axis, inverse)
    if chosen == "stockham":
        return (_ifft_stockham if inverse else _fft_stockham)(xc, axis)
    raise ValueError(f"unknown fft impl {chosen!r}; choose from {_IMPLS[1:]}")


def fft(x, axis: int = -1, impl: Optional[str] = None) -> ComplexArray:
    """Forward FFT (numpy convention, unnormalised) via the chosen path."""
    return _run(x, axis, impl, inverse=False)


def ifft(x, axis: int = -1, impl: Optional[str] = None) -> ComplexArray:
    """Inverse FFT with 1/N normalisation via the chosen path."""
    return _run(x, axis, impl, inverse=True)
