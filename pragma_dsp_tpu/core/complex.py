"""Split real/imag complex representation — the core data type of the framework.

The reference (pragma-dsp) represents complex vectors as split typed arrays
``{real: Float64Array, imag: Float64Array}`` (reference src/core/fft.ts:1-14).
We keep that layout — as an immutable JAX pytree instead of a mutable
struct. The FFT boundary joins the planes into complex64 for ``jnp.fft``
and splits them again (ops/dispatch.py).

Unlike the reference, every array here may carry arbitrary leading batch
dimensions; the complex-element axis is always the last one. Batch-first is
where accelerator throughput comes from: per-frame loops in the reference
become a batch dimension here.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array
RealLike = Union[Array, np.ndarray, list, tuple]


class _ComplexArrayFields(NamedTuple):
    real: Array
    imag: Array


class ComplexArray(_ComplexArrayFields):
    """Split-plane complex array pytree (``real`` and ``imag`` same shape).

    Mirrors the reference's ``ComplexArray`` (src/core/fft.ts:1-4) but is an
    immutable pytree: ops return new values, never mutate.

    Planes must be REAL-dtype: a complex-dtype plane means the caller fed a
    ``jnp.complex64/128`` array somewhere it was treated as a real plane —
    the silent-corruption bug class the reference's input validation guards
    against (src/core/fft.ts:95-104) — so construction rejects it outright.
    """

    def __new__(cls, real, imag):
        # Tolerant checks: pytree unflattening may pass non-array
        # placeholders (no dtype/shape attribute) — only a dtype or shape
        # that is PRESENT and wrong is an error, because complex-dtype,
        # integer, or shape-mismatched planes are always a bug (silent
        # wrong answers downstream: int planes truncate the twiddle
        # products, complex planes drop half the data).
        for name, p in (("real", real), ("imag", imag)):
            dt = getattr(p, "dtype", None)
            if dt is None:
                continue
            if jnp.issubdtype(dt, jnp.complexfloating):
                raise TypeError(
                    f"ComplexArray.{name} plane has complex dtype {dt}; "
                    "planes must be real. Pass the complex array through "
                    "as_complex_array() (it splits complex-dtype input "
                    "into real/imag planes).")
            if not jnp.issubdtype(dt, jnp.floating):
                raise TypeError(
                    f"ComplexArray.{name} plane has non-float dtype {dt}; "
                    "integer/bool planes silently truncate twiddle "
                    "products. Pass the input through as_complex_array() "
                    "(it coerces to the default float dtype).")
        sr = getattr(real, "shape", None)
        si = getattr(imag, "shape", None)
        if sr is not None and si is not None and tuple(sr) != tuple(si):
            raise TypeError(
                f"ComplexArray plane shapes differ: real {tuple(sr)} vs "
                f"imag {tuple(si)}")
        return super().__new__(cls, real, imag)

    @property
    def shape(self):
        return self.real.shape

    @property
    def dtype(self):
        return self.real.dtype

    def __len__(self) -> int:
        return self.real.shape[-1]

    def to_numpy_complex(self) -> np.ndarray:
        """Materialise as a numpy complex ndarray (host transfer)."""
        return np.asarray(self.real) + 1j * np.asarray(self.imag)

    @staticmethod
    def from_numpy_complex(x: np.ndarray, dtype=None) -> "ComplexArray":
        x = np.asarray(x)
        re = jnp.asarray(x.real, dtype=dtype)
        im = jnp.asarray(x.imag, dtype=dtype)
        return ComplexArray(re, im)


def create_complex_array(size, fill: float = 0.0, dtype=jnp.float32) -> ComplexArray:
    """Allocate a complex array of ``size`` (int or shape tuple), optionally filled.

    Parity: ``createComplexArray`` (reference src/core/fft.ts:6-14).
    """
    shape = (size,) if isinstance(size, int) else tuple(size)
    if fill == 0.0:
        z = jnp.zeros(shape, dtype=dtype)
        return ComplexArray(z, z)
    f = jnp.full(shape, fill, dtype=dtype)
    return ComplexArray(f, f)


def as_complex_array(x, dtype=None) -> ComplexArray:
    """Coerce input into a ComplexArray.

    Accepted forms: ComplexArray (returned as-is), a ``(re, im)`` pair of
    real arrays, a numpy complex ndarray, a **complex-dtype JAX array**
    (``jnp.complex64/128`` — split into planes; default plane dtype is the
    dtype's real counterpart), or any real array-like (imag = zeros).

    The complex-dtype branch is load-bearing: the reference validates every
    input (src/core/fft.ts:95-104), and a complex array falling into the
    real-coercion branch would silently zero the imaginary part and return
    wrong answers with no error.
    """
    if isinstance(x, ComplexArray):
        return x
    if dtype is not None and not jnp.issubdtype(jnp.dtype(dtype),
                                                jnp.floating):
        raise TypeError(
            f"ComplexArray planes must be floating; requested dtype "
            f"{jnp.dtype(dtype)}")

    def plane(a):
        # int/bool coerces to the default float dtype (garbage twiddle
        # products otherwise); a complex-dtype PLANE passes through so
        # the ComplexArray constructor rejects it loudly.
        return ensure_float(jnp.asarray(a, dtype=dtype))

    if isinstance(x, tuple) and len(x) == 2 and not isinstance(x[0], (int, float)):
        return ComplexArray(plane(x[0]), plane(x[1]))
    if isinstance(x, np.ndarray) and np.iscomplexobj(x):
        return ComplexArray.from_numpy_complex(x, dtype=dtype)
    if jnp.iscomplexobj(x):
        # complex-dtype JAX array / tracer / python complex (scalar or list).
        arr = jnp.asarray(x)
        re, im = jnp.real(arr), jnp.imag(arr)  # real counterpart dtype
        if dtype is not None:
            re, im = re.astype(dtype), im.astype(dtype)
        return ComplexArray(re, im)
    re = plane(x)
    return ComplexArray(re, jnp.zeros_like(re))


def ensure_float(x) -> Array:
    """Coerce int/bool array-like input to the default float dtype;
    floating AND complex dtypes pass through unchanged (complex input
    keeps flowing to the caller's own complex handling — truncating it
    here would be the silent-corruption class this guard exists to
    stop).

    The boundary guard for real-signal entry points: several hot paths
    cast taps/windows to the INPUT's dtype for mixed-precision control,
    so an integer signal would silently zero the filter (observed:
    fir_filter(arange(64)) returned all zeros; spectrogram of an int
    ramp returned amplitude 0.0). Same bug class as the complex-dtype
    fix — validate-or-coerce, never garbage."""
    a = jnp.asarray(x)
    if (not jnp.issubdtype(a.dtype, jnp.floating)
            and not jnp.issubdtype(a.dtype, jnp.complexfloating)):
        a = a.astype(jnp.result_type(float))
    return a


def is_power_of_two(n: int) -> bool:
    """Parity: ``isPowerOfTwo`` (reference src/core/fft.ts:16)."""
    return n > 0 and (n & (n - 1)) == 0


def next_power_of_two(n: int) -> int:
    """Parity: ``nextPowerOfTwo`` (reference src/core/fft.ts:18-23)."""
    if n <= 1:
        return 1
    p = 1
    while p < n:
        p <<= 1
    return p
