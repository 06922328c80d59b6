"""PFB channelizer vs a numpy golden implementation (BASELINE config 5)."""

import jax.numpy as jnp
import numpy as np
import pytest

from pragma_dsp_tpu.core import ComplexArray
from pragma_dsp_tpu.ops.channelizer import (
    pfb_channelize, pfb_channelize_frames, pfb_channelize_frames_step,
    pfb_channelize_step, pfb_frames_stream_init, pfb_stream_init, pfb_taps,
)
from pragma_dsp_tpu.utils.fixtures import assert_snr, snr_db

RNG = np.random.default_rng(40)


def numpy_pfb(x, h, c):
    """Golden: y[m, ch] = sum_p e^{-2j pi p ch / C} sum_t h[tC+p] x[(m-t)C+p]."""
    t_taps = -(-len(h) // c)
    hp = np.zeros((t_taps, c))
    hp.ravel()[: len(h)] = h
    m = len(x) // c
    xb = np.concatenate([np.zeros((t_taps - 1) * c, dtype=x.dtype), x])
    xb = xb.reshape(t_taps - 1 + m, c)
    v = np.zeros((m, c), dtype=np.complex128)
    for mi in range(m):
        acc = np.zeros(c, dtype=np.complex128)
        for t in range(t_taps):
            acc += hp[t] * xb[t_taps - 1 + mi - t]
        v[mi] = acc
    # analysis DFT e^{-2j pi p ch / C} = forward fft
    return np.fft.fft(v, axis=-1)


def _ca(z):
    return ComplexArray(jnp.asarray(z.real), jnp.asarray(z.imag))


def test_channelizer_matches_numpy_golden():
    c = 16
    x = (RNG.standard_normal(c * 64) + 1j * RNG.standard_normal(c * 64))
    h = pfb_taps(c, 8)
    ref = numpy_pfb(x, h, c)
    got = pfb_channelize(_ca(x), c, h)
    assert got.real.shape == (64, c)
    assert_snr(ref.real, np.asarray(got.real), 100, "pfb re")
    assert_snr(ref.imag, np.asarray(got.imag), 100, "pfb im")


def test_tone_lands_in_its_channel():
    # A tone at channel-k centre frequency must concentrate in channel k.
    c = 32
    m = 128
    n = c * m
    for k in (0, 3, 17, 31):
        f = k / c  # cycles/sample
        x = np.exp(2j * np.pi * f * np.arange(n))
        got = pfb_channelize(_ca(x), c)
        power = np.abs(np.asarray(got.real) + 1j * np.asarray(got.imag)) ** 2
        mean_power = power[8:].mean(axis=0)  # skip filter ramp-in
        assert int(np.argmax(mean_power)) == k
        leakage = mean_power.sum() - mean_power[k]
        assert leakage < 1e-3 * mean_power[k]


def test_channelizer_256ch():
    c = 256
    x = (RNG.standard_normal(c * 32) + 1j * RNG.standard_normal(c * 32))
    h = pfb_taps(c, 8)
    ref = numpy_pfb(x, h, c)
    got = pfb_channelize(_ca(x), c, h)
    assert_snr(ref.real, np.asarray(got.real), 100)
    assert_snr(ref.imag, np.asarray(got.imag), 100)


def test_streaming_matches_batch():
    c = 16
    chunks = [(RNG.standard_normal(c * 16) + 1j * RNG.standard_normal(c * 16))
              for _ in range(4)]
    full = np.concatenate(chunks)
    h = pfb_taps(c, 8)
    ref = pfb_channelize(_ca(full), c, h)

    state = pfb_stream_init(c, 8, dtype=jnp.float64)
    outs_re, outs_im = [], []
    for ch in chunks:
        state, y = pfb_channelize_step(state, _ca(ch), c, h)
        outs_re.append(np.asarray(y.real))
        outs_im.append(np.asarray(y.imag))
    got_re = np.concatenate(outs_re, axis=0)
    got_im = np.concatenate(outs_im, axis=0)
    assert got_re.shape == ref.real.shape
    np.testing.assert_allclose(got_re, np.asarray(ref.real), atol=1e-9)
    np.testing.assert_allclose(got_im, np.asarray(ref.imag), atol=1e-9)


def test_rejects_misaligned_length():

    with pytest.raises(ValueError):
        pfb_channelize(_ca(np.ones(100) + 0j), 16)


# ── (M, C)-frames entry (round-4 VERDICT #2: the measured no-relayout
#    path needs a public API) ──


def test_frames_entry_equals_flat():
    c = 16
    x = RNG.standard_normal(c * 64) + 1j * RNG.standard_normal(c * 64)
    h = pfb_taps(c, 8)
    ref = pfb_channelize(_ca(x), c, h)
    frames = x.reshape(64, c)
    got = pfb_channelize_frames(_ca(frames), c, h)
    np.testing.assert_allclose(np.asarray(got.real),
                               np.asarray(ref.real), atol=0)
    np.testing.assert_allclose(np.asarray(got.imag),
                               np.asarray(ref.imag), atol=0)


def test_frames_entry_batched():
    c = 16
    x = RNG.standard_normal((3, c * 32)) + 1j * RNG.standard_normal((3, c * 32))
    h = pfb_taps(c, 8)
    ref = pfb_channelize(_ca(x), c, h)
    got = pfb_channelize_frames(_ca(x.reshape(3, 32, c)), c, h)
    assert got.real.shape == (3, 32, c)
    np.testing.assert_allclose(np.asarray(got.real),
                               np.asarray(ref.real), atol=0)


def test_frames_entry_rejects_bad_shape():
    with pytest.raises(ValueError):
        pfb_channelize_frames(_ca(np.ones((8, 24)) + 0j), 16)
    with pytest.raises(ValueError):
        pfb_channelize_frames(_ca(np.ones(64) + 0j), 16)


def test_frames_streaming_matches_batch():
    c = 16
    chunks = [RNG.standard_normal((16, c)) + 1j * RNG.standard_normal((16, c))
              for _ in range(4)]
    full = np.concatenate(chunks, axis=0)
    h = pfb_taps(c, 8)
    ref = pfb_channelize_frames(_ca(full), c, h)

    state = pfb_frames_stream_init(c, 8, dtype=jnp.float64)
    outs_re, outs_im = [], []
    for ch in chunks:
        state, y = pfb_channelize_frames_step(state, _ca(ch), c, h)
        outs_re.append(np.asarray(y.real))
        outs_im.append(np.asarray(y.imag))
    got_re = np.concatenate(outs_re, axis=0)
    got_im = np.concatenate(outs_im, axis=0)
    assert got_re.shape == ref.real.shape
    np.testing.assert_allclose(got_re, np.asarray(ref.real), atol=1e-9)
    np.testing.assert_allclose(got_im, np.asarray(ref.imag), atol=1e-9)


def test_frames_streaming_equals_flat_streaming():
    """The frames step and the flat step are the same stream in two
    views: identical outputs frame-for-frame."""
    c = 16
    chunks = [RNG.standard_normal(c * 8) + 1j * RNG.standard_normal(c * 8)
              for _ in range(3)]
    h = pfb_taps(c, 8)
    sf = pfb_stream_init(c, 8, dtype=jnp.float64)
    sF = pfb_frames_stream_init(c, 8, dtype=jnp.float64)
    for ch in chunks:
        sf, yf = pfb_channelize_step(sf, _ca(ch), c, h)
        sF, yF = pfb_channelize_frames_step(
            sF, _ca(ch.reshape(-1, c)), c, h)
        np.testing.assert_allclose(np.asarray(yF.real),
                                   np.asarray(yf.real), atol=0)
        np.testing.assert_allclose(np.asarray(yF.imag),
                                   np.asarray(yf.imag), atol=0)
