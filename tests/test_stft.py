"""STFT / spectrogram / streaming-state tests (BASELINE.json config 2)."""

import jax.numpy as jnp
import numpy as np
import pytest

from pragma_dsp_tpu.stream import (
    StftState, frame_signal, istft, spectrogram, stft, stft_step,
    stft_stream_init,
)
from pragma_dsp_tpu.xform.fourier import window_values


def _numpy_stft(x, n_fft, hop, window):
    w = window_values(window, n_fft)
    n_frames = 1 + (len(x) - n_fft) // hop
    out = np.empty((n_frames, n_fft), dtype=np.complex128)
    for f in range(n_frames):
        out[f] = np.fft.fft(x[f * hop:f * hop + n_fft] * w)
    return out


def test_frame_signal_shapes():
    x = jnp.arange(100.0)
    fr = frame_signal(x, 16, 4)
    assert fr.shape == (22, 16)
    np.testing.assert_array_equal(np.asarray(fr[0]), np.arange(16.0))
    np.testing.assert_array_equal(np.asarray(fr[1]), np.arange(4.0, 20.0))


def test_stft_matches_numpy_oracle():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(4096)
    for window in ("rect", "hann"):
        got = stft(jnp.asarray(x), 1024, 256, window)
        ref = _numpy_stft(x, 1024, 256, window)
        np.testing.assert_allclose(np.asarray(got.real), ref.real, atol=1e-8)
        np.testing.assert_allclose(np.asarray(got.imag), ref.imag, atol=1e-8)


def test_stft_default_hop_is_75_percent_overlap():
    x = jnp.asarray(np.random.default_rng(1).standard_normal(4096 * 3))
    spec = stft(x, 4096)
    assert spec.real.shape == (1 + (4096 * 3 - 4096) // 1024, 4096)


def test_spectrogram_tracks_chirp_peak():
    # A slow chirp's per-frame peak frequency must increase monotonically.
    sr = 48000.0
    n = 48000
    t = np.arange(n) / sr
    f0, f1 = 1000.0, 8000.0
    x = np.sin(2 * np.pi * (f0 * t + (f1 - f0) * t * t / (2 * (n / sr))))
    r = spectrogram(jnp.asarray(x), 1024, 512, window="hann", sample_rate=sr)
    freqs = np.asarray(r.peak.frequency)
    assert freqs.shape[0] == 1 + (n - 1024) // 512
    assert np.all(np.diff(freqs) >= 0)
    assert abs(freqs[0] - f0) < 200 and abs(freqs[-1] - f1) < 400


def test_istft_roundtrip():
    rng = np.random.default_rng(2)
    x = rng.standard_normal(8192)
    spec = stft(jnp.asarray(x), 512, 128, "hann")
    rec = istft(spec, 128, "hann", length=8192)
    # Interior reconstruction is exact under WOLA; edges lack overlap.
    interior = slice(512, 8192 - 512)
    np.testing.assert_allclose(np.asarray(rec)[interior], x[interior],
                               atol=1e-8)


def test_streaming_equals_batch_with_zero_history():
    # Chunked stft with zero-initialised carry == batch stft of the
    # zero-prefixed signal.
    rng = np.random.default_rng(3)
    n_fft, hop = 256, 64
    chunks = [rng.standard_normal(512) for _ in range(4)]
    full = np.concatenate([np.zeros(n_fft - hop)] + chunks)

    state = stft_stream_init(n_fft, hop, dtype=jnp.float64)
    outs = []
    for ch in chunks:
        state, spec = stft_step(state, jnp.asarray(ch), n_fft, hop, "hann")
        outs.append(np.asarray(spec.real) + 1j * np.asarray(spec.imag))
    streamed = np.concatenate(outs, axis=0)

    ref = _numpy_stft(full, n_fft, hop, "hann")
    # Batch framing emits one extra trailing frame the stream hasn't seen yet
    assert streamed.shape[0] in (ref.shape[0], ref.shape[0] - 1)
    np.testing.assert_allclose(streamed, ref[:streamed.shape[0]], atol=1e-8)


def test_stft_step_rejects_misaligned_chunk():
    import pytest

    state = stft_stream_init(256, 64)
    with pytest.raises(ValueError):
        stft_step(state, jnp.zeros(100), 256, 64)


def test_spectrogram_amplitude_fast_path_matches_full():
    from pragma_dsp_tpu.stream import spectrogram_amplitude

    rng = np.random.default_rng(9)
    x = rng.standard_normal(8192).astype(np.float32)
    fast = np.asarray(spectrogram_amplitude(jnp.asarray(x), 1024, 256, "hann"))
    full = spectrogram(jnp.asarray(x), 1024, 256, "hann", 48000.0)
    np.testing.assert_allclose(fast, np.asarray(full.amplitude),
                               rtol=0, atol=2e-6)


def test_welch_psd_matches_scipy_rect():
    """rect window == scipy.welch boxcar exactly (density scaling,
    two-sided, zero overlap, detrend off)."""
    from scipy import signal as sps

    from pragma_dsp_tpu.stream import welch_psd

    rng = np.random.default_rng(21)
    x = rng.standard_normal(4096)
    n = 128
    got = np.asarray(welch_psd(jnp.asarray(x), n, window="rect", fs=48e3))
    _, ref = sps.welch(x, fs=48e3, window="boxcar", nperseg=n, noverlap=0,
                       detrend=False, return_onesided=False,
                       scaling="density")
    np.testing.assert_allclose(got, ref, rtol=1e-9)


def test_welch_psd_overlap_and_window_oracle():
    """hann (sym=True, the framework convention) + 50% overlap against
    an explicit numpy oracle; complex IQ input."""
    from pragma_dsp_tpu.stream import welch_psd
    from pragma_dsp_tpu.xform.fourier import window_values

    rng = np.random.default_rng(22)
    z = rng.standard_normal(2048) + 1j * rng.standard_normal(2048)
    n, hop = 256, 128
    got = np.asarray(welch_psd(jnp.asarray(z), n, hop, "hann"))
    w = window_values("hann", n)
    nseg = 1 + (len(z) - n) // hop
    segs = np.stack([z[i * hop:i * hop + n] for i in range(nseg)])
    ref = (np.abs(np.fft.fft(segs * w, axis=-1)) ** 2).mean(0) \
        / np.sum(w ** 2)
    np.testing.assert_allclose(got, ref, rtol=1e-9)


def test_welch_psd_is_channel_power_per_channel():
    """parallel.sharded_channel_power == welch_psd applied per channel
    of the channelizer output (fs = n_fft matches its normalisation)."""
    import jax

    from pragma_dsp_tpu.core import ComplexArray
    from pragma_dsp_tpu.ops.channelizer import pfb_channelize_frames
    from pragma_dsp_tpu.parallel import data_mesh, sharded_channel_power
    from pragma_dsp_tpu.stream import welch_psd

    rng = np.random.default_rng(23)
    c, n_fft = 32, 8
    m = 8 * n_fft * 2
    z = rng.standard_normal((m, c)) + 1j * rng.standard_normal((m, c))
    xc = ComplexArray(jnp.asarray(z.real), jnp.asarray(z.imag))
    pw = np.asarray(sharded_channel_power(xc, c, mesh=data_mesh(8),
                                          n_fft=n_fft, window="hann"))
    y = pfb_channelize_frames(xc, c)
    for ch in (0, 7, 31):
        zc = np.asarray(y.real[:, ch]) + 1j * np.asarray(y.imag[:, ch])
        ref = np.asarray(welch_psd(jnp.asarray(zc), n_fft, window="hann",
                                   fs=float(n_fft)))
        np.testing.assert_allclose(pw[:, ch], ref, rtol=1e-7)
