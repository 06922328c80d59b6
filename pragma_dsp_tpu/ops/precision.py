"""Precision modes for the f32 matmuls on the main path.

Two modes exist:

* ``"highest"`` — full-f32 dots (``lax.Precision.HIGHEST``), no TF32
  rounding. The default.
* ``"bf16x3"`` — each f32 operand is split into a bf16 hi part and a
  bf16 lo residual, and the product is taken as three bf16 dots with f32
  accumulation (hi*hi + hi*lo + lo*hi). Used by the banded upfirdn
  (ops/polyphase.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

__all__ = ["resolve_precision"]

PRECISIONS = ("highest", "bf16x3")


def resolve_precision(precision: Optional[str]) -> str:
    """None or "auto" -> "highest"; otherwise validate the named mode."""
    if precision in (None, "auto"):
        return "highest"
    if precision not in PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}; choose from {PRECISIONS}")
    return precision


def _np_bsplit(m: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Trace-time hi/lo bf16 split of an f32 constant matrix."""
    bf16 = np.dtype(jnp.bfloat16.dtype)
    m32 = np.asarray(m, np.float32)
    hi = m32.astype(bf16)
    lo = (m32 - hi.astype(np.float32)).astype(bf16)
    return hi, lo


def _round_bf16_f32(a):
    """Round an f32 array to the bf16 grid (round-to-nearest-even), with
    the result kept in f32.

    NOT expressed as astype(bf16).astype(f32): XLA's allow-excess-
    precision simplifier may fold that down-then-up convert pair into
    identity, silently zeroing split residuals and turning bf16x3 into
    bf16x1 (~54 dB). This is the Veltkamp split at bit 16:
    t = a*(2^16+1); hi = t - (t - a) — three flops whose f32 roundings
    yield exactly the bf16 RNE value, in plain float arithmetic the
    simplifier must preserve. Overflows only beyond |a| ~ 5e33."""
    t = a * jnp.asarray(65537.0, a.dtype)
    return t - (t - a)


def _bsplit(a):
    """Runtime hi/lo bf16 split of an f32 operand (bf16x3 dot inputs).
    The hi part is rounded on the explicit bf16 grid (_round_bf16_f32)
    so the residual survives every compiler; the astype(bf16) of an
    already-rounded value is lossless."""
    hi_f = _round_bf16_f32(a)
    hi = hi_f.astype(jnp.bfloat16)
    lo = (a - hi_f).astype(jnp.bfloat16)
    return hi, lo
