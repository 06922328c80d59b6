"""Golden-fixture loading + SNR-bound comparison harness.

The reference validates in float64 with absolute tolerances down to 1e-10
(reference test/reallife/helpers.ts:97-136). On the GPU the compute dtype
is f32, where those tolerances are unreachable, so this harness offers
both:

* absolute/relative closeness for f64 runs (CPU tests with x64 enabled)
* SNR bounds in dB for f32 runs (BASELINE.json "within SNR bound")
"""

from __future__ import annotations

import gzip
import json
import os
from typing import Any, Dict

import numpy as np

__all__ = [
    "load_json",
    "fixtures_dir",
    "snr_db",
    "max_abs_error",
    "rms_error",
    "assert_close",
    "assert_snr",
]


def fixtures_dir() -> str:
    """Repo-root tests/fixtures directory."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.normpath(os.path.join(here, "..", "..", "tests", "fixtures"))


def load_json(path: str) -> Dict[str, Any]:
    """Load a fixture JSON; transparently handles .gz and bare .json paths."""
    if not os.path.exists(path) and os.path.exists(path + ".gz"):
        path = path + ".gz"
    if path.endswith(".gz"):
        with gzip.open(path, "rt", encoding="utf-8") as f:
            return json.load(f)
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def max_abs_error(ref, test) -> float:
    """Parity: maxAbsError (reference test/reallife/helpers.ts:139-149)."""
    ref = np.asarray(ref, dtype=np.float64)
    test = np.asarray(test, dtype=np.float64)
    return float(np.max(np.abs(ref - test))) if ref.size else 0.0


def rms_error(ref, test) -> float:
    """Parity: rmsError (reference test/reallife/helpers.ts:151-161)."""
    ref = np.asarray(ref, dtype=np.float64)
    test = np.asarray(test, dtype=np.float64)
    return float(np.sqrt(np.mean((ref - test) ** 2))) if ref.size else 0.0


def snr_db(ref, test) -> float:
    """Signal-to-error ratio in dB; +inf for exact match, -inf when the
    reference is zero but the output is not. Complex inputs compare
    both parts."""
    ref, test = np.asarray(ref), np.asarray(test)
    wide = (np.complex128 if np.iscomplexobj(ref) or np.iscomplexobj(test)
            else np.float64)
    ref, test = ref.astype(wide), test.astype(wide)
    sig = float(np.sum(np.abs(ref) ** 2))
    err = float(np.sum(np.abs(ref - test) ** 2))
    if err == 0.0:
        return float("inf")
    if sig == 0.0:
        return float("-inf")
    return 10.0 * np.log10(sig / err)


def assert_close(ref, test, abs_tol: float = 0.0, rel_tol: float = 0.0,
                 label: str = "") -> None:
    """Element-wise |ref-test| <= abs_tol + rel_tol*|ref| with a readable
    failure message (reference expectCloseArray/Relative semantics,
    test/reallife/helpers.ts:97-136)."""
    ref = np.asarray(ref, dtype=np.float64)
    test = np.asarray(test, dtype=np.float64)
    assert ref.shape == test.shape, f"{label}: shape {ref.shape} vs {test.shape}"
    bound = abs_tol + rel_tol * np.abs(ref)
    err = np.abs(ref - test)
    bad = err > bound
    if np.any(bad):
        i = int(np.argmax(err - bound))
        raise AssertionError(
            f"{label}: {int(bad.sum())}/{ref.size} elements out of tolerance; "
            f"worst at flat index {i}: ref={ref.flat[i]!r} test={test.flat[i]!r} "
            f"err={err.flat[i]:.3e} bound={np.asarray(bound).flat[i]:.3e}")


def assert_snr(ref, test, min_db: float, label: str = "") -> None:
    got = snr_db(ref, test)
    assert got >= min_db, f"{label}: SNR {got:.1f} dB < required {min_db:.1f} dB"
