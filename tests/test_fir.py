"""FIR filtering vs scipy.signal.lfilter goldens (BASELINE config 3 stack)."""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy import signal as sps

from pragma_dsp_tpu.core import ComplexArray
from pragma_dsp_tpu.ops.fir import (
    fir_filter, fir_step, fir_stream_init, overlap_save_filter,
)
from pragma_dsp_tpu.utils.fixtures import assert_snr

RNG = np.random.default_rng(10)


@pytest.mark.parametrize("k,method", [(31, "direct"), (127, "direct"),
                                      (127, "overlap_save"),
                                      (255, "overlap_save")])
def test_fir_matches_lfilter(k, method):
    x = RNG.standard_normal(5000)
    taps = sps.firwin(k, 0.25)
    ref = sps.lfilter(taps, 1.0, x)
    got = np.asarray(fir_filter(jnp.asarray(x), jnp.asarray(taps),
                                method=method))
    assert_snr(ref, got, 120, f"fir k={k} {method}")


def test_fir_batched():
    x = RNG.standard_normal((3, 4, 1000))
    taps = sps.firwin(63, 0.1)
    got = np.asarray(fir_filter(jnp.asarray(x), jnp.asarray(taps)))
    for i in range(3):
        for j in range(4):
            ref = sps.lfilter(taps, 1.0, x[i, j])
            assert_snr(ref, got[i, j], 120)


@pytest.mark.slow
def test_fir_complex_input():
    z = RNG.standard_normal(2000) + 1j * RNG.standard_normal(2000)
    taps = sps.firwin(65, 0.3)
    got = fir_filter(ComplexArray(jnp.asarray(z.real), jnp.asarray(z.imag)),
                     jnp.asarray(taps))
    ref = sps.lfilter(taps, 1.0, z)
    assert_snr(ref.real, np.asarray(got.real), 120)
    assert_snr(ref.imag, np.asarray(got.imag), 120)


@pytest.mark.slow
def test_overlap_save_equals_direct():
    x = RNG.standard_normal(10000)
    taps = sps.firwin(127, 0.2)
    d = np.asarray(fir_filter(jnp.asarray(x), jnp.asarray(taps), "direct"))
    o = np.asarray(overlap_save_filter(jnp.asarray(x), jnp.asarray(taps)))
    assert_snr(d, o, 120, "os vs direct")


def test_overlap_save_short_signal():
    # Signal shorter than one block still works.
    x = RNG.standard_normal(300)
    taps = sps.firwin(127, 0.2)
    ref = sps.lfilter(taps, 1.0, x)
    got = np.asarray(overlap_save_filter(jnp.asarray(x), jnp.asarray(taps)))
    assert got.shape == ref.shape
    assert_snr(ref, got, 120)


def test_streaming_matches_batch():
    taps = sps.firwin(65, 0.15)
    chunks = [RNG.standard_normal(512) for _ in range(5)]
    full = np.concatenate(chunks)
    ref = sps.lfilter(taps, 1.0, full)

    state = fir_stream_init(taps, dtype=jnp.float64)
    outs = []
    for ch in chunks:
        state, y = fir_step(state, jnp.asarray(ch), jnp.asarray(taps))
        outs.append(np.asarray(y))
    got = np.concatenate(outs)
    assert got.shape == ref.shape
    assert_snr(ref, got, 120, "stream vs batch")


def test_overlap_save_rejects_tiny_block():
    """ADVICE r1: block < 2*(k-1) breaks the row-shifted framing; must
    raise a clear ValueError instead of a trace-time shape error."""
    import pytest
    from pragma_dsp_tpu.ops.fir import overlap_save_filter

    x = jnp.asarray(np.random.default_rng(0).standard_normal(1024),
                    dtype=jnp.float32)
    taps = jnp.asarray(np.hamming(200), dtype=jnp.float32)
    with pytest.raises(ValueError, match="block"):
        overlap_save_filter(x, taps, block=256)
