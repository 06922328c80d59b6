"""Polyphase resampler vs scipy.signal.upfirdn goldens (config 3:
48 kHz -> 44.1 kHz with a 127-tap FIR)."""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy import signal as sps

from pragma_dsp_tpu.core import ComplexArray
from pragma_dsp_tpu.ops.polyphase import (
    decimate, design_lowpass, interpolate, resample_poly, resampler_taps,
    upfirdn,
)
from pragma_dsp_tpu.utils.fixtures import assert_snr, snr_db

RNG = np.random.default_rng(20)


def test_design_lowpass_matches_firwin():
    for k, cut in [(127, 0.2), (64, 0.5), (255, 0.05)]:
        mine = design_lowpass(k, cut)
        ref = sps.firwin(k, cut)
        np.testing.assert_allclose(mine, ref, atol=1e-12)


@pytest.mark.parametrize("up,down", [(1, 4), (4, 1), (3, 2), (147, 160)])
def test_upfirdn_matches_scipy(up, down):
    x = RNG.standard_normal(2000)
    h = sps.firwin(127, min(1.0 / up, 1.0 / down) * 0.9)
    ref = sps.upfirdn(h, x, up, down)
    got = np.asarray(upfirdn(jnp.asarray(x), jnp.asarray(h), up, down))
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert_snr(ref, got, 120, f"upfirdn {up}/{down}")


@pytest.mark.parametrize("up,down", [(3, 2), (147, 160)])
def test_upfirdn_bf16x3_snr(up, down):
    """The opt-in bf16x3 banded matmul (3 DEFAULT bf16 passes on
    hi/lo-split operands) must stay >=100 dB of the f64 scipy golden —
    the same production gate the FFT kernels carry."""
    x = RNG.standard_normal(4000)
    h = sps.firwin(127, min(1.0 / up, 1.0 / down) * 0.9)
    ref = sps.upfirdn(h, x, up, down)
    got = np.asarray(upfirdn(jnp.asarray(x, jnp.float32), jnp.asarray(h),
                             up, down, precision="bf16x3"))
    assert got.shape == ref.shape
    assert_snr(ref, got, 100, f"upfirdn bf16x3 {up}/{down}")


def test_upfirdn_complex():
    z = RNG.standard_normal(1000) + 1j * RNG.standard_normal(1000)
    h = sps.firwin(63, 0.2)
    ref = sps.upfirdn(h, z, 2, 3)
    got = upfirdn(ComplexArray(jnp.asarray(z.real), jnp.asarray(z.imag)),
                  jnp.asarray(h), 2, 3)
    assert_snr(ref.real, np.asarray(got.real), 120)
    assert_snr(ref.imag, np.asarray(got.imag), 120)


def test_48k_to_44k1_sine_preserved():
    # Config 3: a 1 kHz sine resampled 48k->44.1k must stay a clean
    # 1 kHz sine at the new rate (SNR bound after edge trim). A filter
    # with up=147 needs >= a few taps per polyphase branch; a literal
    # 127-tap design (fewer taps than branches) cannot interpolate —
    # it exists only for the scipy-equivalence fixtures below.
    fs_in = 48000.0
    num_taps = 8 * 147 + 1
    t = np.arange(48000) / fs_in
    x = np.sin(2 * np.pi * 1000.0 * t)
    y = np.asarray(resample_poly(jnp.asarray(x), 147, 160,
                                 num_taps=num_taps))
    expected_len = -(-((len(x) - 1) * 147 + num_taps) // 160)
    assert y.shape[0] == expected_len
    t_out = np.arange(len(y)) * 160 / (147 * fs_in)
    delay = (num_taps - 1) / 2 / (fs_in * 147)
    ref = np.sin(2 * np.pi * 1000.0 * (t_out - delay))
    # ~56 dB achievable: limited by hamming windowed-sinc passband
    # ripple (scipy's own resample_poly shows the same), not by the
    # polyphase machinery.
    trim = slice(500, len(y) - 500)
    assert snr_db(ref[trim], y[trim]) > 50


def test_resample_poly_matches_scipy_given_same_taps():
    x = RNG.standard_normal(4096)
    taps = resampler_taps(147, 160, 127)
    ref = sps.upfirdn(taps, x, 147, 160)
    got = np.asarray(resample_poly(jnp.asarray(x), 147, 160))
    assert_snr(ref, got, 120)


def test_decimate_interpolate():
    x = RNG.standard_normal(4000)
    d = np.asarray(decimate(jnp.asarray(x), 4))
    h = design_lowpass(127, 0.25)
    ref = sps.upfirdn(h, x, 1, 4)
    assert_snr(ref, d, 120)
    u = np.asarray(interpolate(jnp.asarray(x[:500]), 4))
    refu = sps.upfirdn(design_lowpass(127, 0.25) * 4, x[:500], 4, 1)
    assert_snr(refu, u, 120)


def test_batched_resample():
    x = RNG.standard_normal((6, 2000))
    got = np.asarray(resample_poly(jnp.asarray(x), 3, 2))
    taps = resampler_taps(3, 2, 127)
    for i in range(6):
        ref = sps.upfirdn(taps, x[i], 3, 2)
        assert_snr(ref, got[i], 120)


# ── multi-stage cascade (round-4 VERDICT #4) ──


def test_cascade_matches_scipy_chain():
    """Each cascade stage is scipy-upfirdn-exact, so the whole cascade
    must match scipy applying the same stages in sequence."""
    from pragma_dsp_tpu.ops.polyphase import (resample_poly_cascade,
                                              resampler_taps)

    rng = np.random.default_rng(9)
    x = rng.standard_normal(4800)
    factors = [(3, 4), (7, 8), (7, 5)]
    ref = x
    for up, down in factors:
        h = resampler_taps(up, down, 8 * max(up, down) + 1)
        ref = sps.upfirdn(h, ref, up, down)
    got = np.asarray(resample_poly_cascade(jnp.asarray(x), factors))
    assert got.shape == ref.shape
    assert snr_db(ref, got) > 100.0


def test_cascade_rate_and_quality_match_single_stage():
    """(3/4)(7/8)(7/5) = 147/160: a passband tone comes through the
    cascade at the same rate and amplitude class as the single stage."""
    from pragma_dsp_tpu.ops.polyphase import (resample_poly,
                                              resample_poly_cascade)

    fs = 48000.0
    n = 48000
    t = np.arange(n) / fs
    x = np.sin(2 * np.pi * 1000.0 * t)
    a = np.asarray(resample_poly(jnp.asarray(x), 147, 160,
                                 num_taps=8 * 147 + 1))
    b = np.asarray(resample_poly_cascade(jnp.asarray(x),
                                         [(3, 4), (7, 8), (7, 5)]))
    # output lengths agree to within the differing group delays
    assert abs(len(a) - len(b)) < 64
    m = min(len(a), len(b)) - 2000
    # compare against the ideal resampled tone, skipping both transients
    fs2 = fs * 147 / 160
    t2 = np.arange(m - 1000) / fs2
    for y in (a, b):
        seg = y[1000:m]
        ref_c = np.exp(1j * 2 * np.pi * 1000.0 * t2)
        amp = np.abs(np.vdot(ref_c, seg)) * 2 / len(seg)
        # composite cascade passband ripple is ~0.2% with the default
        # per-stage designs vs ~0.02% single-stage — same quality class
        assert abs(amp - 1.0) < 5e-3, f"tone amplitude {amp}"


def test_cascade_validates_taps_list():
    from pragma_dsp_tpu.ops.polyphase import resample_poly_cascade

    with pytest.raises(ValueError, match="stages"):
        resample_poly_cascade(jnp.zeros(100), [(3, 4), (7, 8)],
                              taps=[np.ones(5)])


def test_cascade_quantum():
    from pragma_dsp_tpu.ops.polyphase import cascade_chunk_quantum

    assert cascade_chunk_quantum([(3, 4), (7, 8), (7, 5)]) == 160
    assert cascade_chunk_quantum([(1, 4)]) == 4
    assert cascade_chunk_quantum([(147, 160)]) == 160


def test_cascade_streaming_matches_batch():
    from pragma_dsp_tpu.ops.polyphase import (
        cascade_chunk_quantum, resample_cascade_step,
        resample_cascade_stream_init, resample_poly_cascade)

    factors = [(3, 4), (7, 8), (7, 5)]
    q = cascade_chunk_quantum(factors)
    rng = np.random.default_rng(11)
    chunks = [rng.standard_normal(q * 4) for _ in range(5)]
    full = np.concatenate(chunks)
    ref = np.asarray(resample_poly_cascade(jnp.asarray(full), factors))

    st = resample_cascade_stream_init(factors, dtype=jnp.float64)
    outs = []
    for ch in chunks:
        st, y = resample_cascade_step(st, jnp.asarray(ch), factors)
        outs.append(np.asarray(y))
    got = np.concatenate(outs)
    # streaming emits the prefix (ring-out tails arrive with later input)
    assert got.shape[0] <= ref.shape[0]
    assert got.shape[0] == len(full) * 147 // 160
    np.testing.assert_allclose(got, ref[: got.shape[0]], atol=1e-9)


def test_cascade_step_validates_quantum():
    from pragma_dsp_tpu.ops.polyphase import (
        resample_cascade_step, resample_cascade_stream_init)

    factors = [(3, 4), (7, 8), (7, 5)]
    st = resample_cascade_stream_init(factors)
    with pytest.raises(ValueError, match="quantum"):
        resample_cascade_step(st, jnp.zeros(100), factors)
