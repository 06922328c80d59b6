"""Beginner spectrum() tests on the bin-centered sine fixture
(reference test/spectrum.test.ts:5-35)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pragma_dsp_tpu import spectrum


def _sine_case(unit_fixtures):
    for c in unit_fixtures["fftCases"]:
        if c["kind"] == "sine_bin_centered":
            return c
    raise AssertionError("missing sine fixture")


def test_peak_bin_and_frequency(unit_fixtures):
    c = _sine_case(unit_fixtures)
    r = spectrum(jnp.asarray(c["input"], dtype=jnp.float64),
                 sample_rate=c["sampleRate"])
    assert int(r.peak.index) == c["meta"]["binCenteredK"]
    assert abs(float(r.peak.frequency) - c["meta"]["expectedPeakHz"]) < 1e-6


def test_peak_amplitude(unit_fixtures):
    c = _sine_case(unit_fixtures)
    r = spectrum(jnp.asarray(c["input"], dtype=jnp.float64),
                 sample_rate=c["sampleRate"])
    assert abs(float(r.peak.amplitude) - c["meta"]["amplitude"]) < 1e-3


def test_default_fft_size_pads_to_next_pow2():
    x = jnp.asarray(np.ones(100), dtype=jnp.float64)
    r = spectrum(x)
    assert r.amplitude.shape[-1] == 128 // 2 + 1


@pytest.mark.slow
def test_batched_spectrum_matches_loop(unit_fixtures):
    c = _sine_case(unit_fixtures)
    x = np.asarray(c["input"])
    batch = np.stack([x, 2.0 * x, np.roll(x, 5)])
    rb = spectrum(jnp.asarray(batch), sample_rate=c["sampleRate"])
    for i in range(3):
        ri = spectrum(jnp.asarray(batch[i]), sample_rate=c["sampleRate"])
        np.testing.assert_allclose(np.asarray(rb.amplitude[i]),
                                   np.asarray(ri.amplitude), rtol=0, atol=1e-12)
        assert int(rb.peak.index[i]) == int(ri.peak.index)


def test_bf16_input_rides_f32_pipeline():
    """bf16 samples upcast to f32: the result is bit-identical to
    feeding the f32 value of the same bf16 data, and the transform is
    the one ops.dispatch chooses for the platform (no spectrum-specific
    kernel path)."""
    from pragma_dsp_tpu.ops.dispatch import fft_route, policy, set_fft_impl

    rng = np.random.default_rng(12)
    x16 = jnp.asarray(rng.standard_normal(256), jnp.bfloat16)
    r16 = spectrum(x16, sample_rate=48000.0, window="hann")
    r32 = spectrum(x16.astype(jnp.float32), sample_rate=48000.0,
                   window="hann")
    assert r16.amplitude.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(r16.amplitude),
                                  np.asarray(r32.amplitude))
    np.testing.assert_array_equal(np.asarray(r16.phase),
                                  np.asarray(r32.phase))
    # The dispatch choice, read off the traced program: the CPU policy
    # (stockham) has no fft primitive; pinning "xla" (the GPU policy)
    # puts exactly one jnp.fft in the beginner rung.
    assert fft_route() == policy(jax.default_backend()) == "stockham"
    def jaxpr_of_spectrum():
        # a fresh function each time: make_jaxpr caches by function
        return str(jax.make_jaxpr(
            lambda v: spectrum(v, sample_rate=48000.0, window="hann"))(x16))

    assert " fft[" not in jaxpr_of_spectrum()
    set_fft_impl("xla")
    try:
        jaxpr = jaxpr_of_spectrum()
        r_xla = spectrum(x16, sample_rate=48000.0, window="hann")
    finally:
        set_fft_impl("auto")
    assert jaxpr.count(" fft[") == 1
    np.testing.assert_allclose(np.asarray(r_xla.amplitude),
                               np.asarray(r32.amplitude), atol=1e-6)
