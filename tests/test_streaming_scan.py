"""Scan-driven streaming + donation (round-1 VERDICT next-step #5).

The carry designs (FirState / StftState / UpfirdnState / WbfmStreamState)
are exercised UNDER lax.scan, and the jitted+donated step is checked to
produce identical results — the analogue of the reference expert
rung's out-buffer-reuse contract (reference src/core/fft.ts:89-106,
README.md:41-51 "zero-allocation hot loop").
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pragma_dsp_tpu.core import ComplexArray
from pragma_dsp_tpu.models.fm_receiver import FmReceiver, FmReceiverConfig
from pragma_dsp_tpu.ops.polyphase import (
    upfirdn,
    upfirdn_step,
    upfirdn_stream_init,
    resampler_taps,
)
from pragma_dsp_tpu.stream import (
    jit_stream_step,
    scan_stream,
    stft,
    stft_step,
    stft_stream_init,
)


@pytest.mark.parametrize("up,down", [(1, 5), (147, 160), (3, 2)])
def test_upfirdn_step_matches_batch_prefix(up, down):
    import math

    rng = np.random.default_rng(3)
    h = resampler_taps(up, down, 127)
    x = rng.standard_normal((2, 3200)).astype(np.float32)
    ref = np.asarray(upfirdn(jnp.asarray(x), h, up, down))
    chunk = (down // math.gcd(up, down))
    chunk *= max(1, 640 // chunk)
    state = upfirdn_stream_init(h, up, down, (2,))
    outs = []
    for i in range(x.shape[-1] // chunk):
        state, o = upfirdn_step(state, jnp.asarray(x[:, i * chunk:(i + 1) * chunk]),
                                h, up, down)
        outs.append(np.asarray(o))
    y = np.concatenate(outs, -1)
    np.testing.assert_allclose(y, ref[:, :y.shape[-1]], atol=1e-6)


def test_stft_step_under_scan_matches_batch():
    """StftState threaded as a lax.scan carry reproduces the batch STFT
    (the carry design is scan-TESTED, not just scan-compatible)."""
    rng = np.random.default_rng(11)
    n_fft, hop, n_chunks, chunk = 128, 32, 6, 256
    x = rng.standard_normal(n_chunks * chunk).astype(np.float32)

    state = stft_stream_init(n_fft, hop)
    chunks = jnp.asarray(x.reshape(n_chunks, chunk))

    def step(st, ch):
        st, spec = stft_step(st, ch, n_fft, hop, "hann")
        return st, (spec.real, spec.imag)

    _, (res, ims) = scan_stream(step, state, chunks)
    got_re = np.asarray(res).reshape(-1, n_fft)
    got_im = np.asarray(ims).reshape(-1, n_fft)

    # batch reference over the zero-history-prefixed stream
    full = stft(jnp.concatenate([jnp.zeros(n_fft - hop), jnp.asarray(x)]),
                n_fft, hop, "hann")
    np.testing.assert_allclose(got_re, np.asarray(full.real)[:len(got_re)],
                               atol=1e-4)
    np.testing.assert_allclose(got_im, np.asarray(full.imag)[:len(got_im)],
                               atol=1e-4)


def test_wbfm_scan_matches_batch():
    """End-to-end chunked WBFM receive under lax.scan equals the batch
    receiver's output prefix (BASELINE.json config 4, streamed)."""
    cfg = FmReceiverConfig(iq_rate=2.4e6, if_rate=240e3, audio_rate=48e3)
    rx = FmReceiver(cfg)
    rng = np.random.default_rng(5)
    n_chunks, chunk = 5, 4800
    assert chunk % rx.chunk_quantum == 0
    total = n_chunks * chunk
    # FM-modulated tone + noise
    t = np.arange(total) / cfg.iq_rate
    msg = np.sin(2 * np.pi * 1000.0 * t)
    phase = 2 * np.pi * cfg.deviation * np.cumsum(msg) / cfg.iq_rate
    iq = np.exp(1j * phase) + 0.001 * (
        rng.standard_normal(total) + 1j * rng.standard_normal(total))
    re = iq.real.astype(np.float32)
    im = iq.imag.astype(np.float32)

    batch = np.asarray(rx(ComplexArray(jnp.asarray(re), jnp.asarray(im))))

    state = rx.stream_init()
    chunks = (jnp.asarray(re.reshape(n_chunks, chunk)),
              jnp.asarray(im.reshape(n_chunks, chunk)))

    def step(st, ch):
        return rx.stream_step(st, ComplexArray(ch[0], ch[1]))

    _, outs = scan_stream(step, state, chunks)
    y = np.asarray(outs).reshape(-1)
    assert y.size > 0
    np.testing.assert_allclose(y, batch[:y.size], atol=2e-4)


def test_jit_stream_step_donated_matches_undonated():
    """donate_argnums on the carry changes nothing numerically (and on
    the GPU reuses the state buffer in place)."""
    h = resampler_taps(1, 5, 127)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 2000)).astype(np.float32)

    def step(state, chunk):
        return upfirdn_step(state, chunk, jnp.asarray(h), 1, 5)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # CPU ignores donation with a warning
        donated = jit_stream_step(step, donate=True)
        plain = jit_stream_step(step, donate=False)
        s1 = upfirdn_stream_init(h, 1, 5, (2,))
        s2 = upfirdn_stream_init(h, 1, 5, (2,))
        for i in range(4):
            ch = jnp.asarray(x[:, i * 500:(i + 1) * 500])
            s1, o1 = donated(s1, ch)
            s2, o2 = plain(s2, ch)
            np.testing.assert_array_equal(np.asarray(o1), np.asarray(o2))
