"""Aux-subsystem tests: checkpoint/resume, sanitizer mode, barrier,
bench harness checksum determinism."""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pragma_dsp_tpu.ops.fir import fir_step, fir_stream_init
from pragma_dsp_tpu.stream import StftState, stft_stream_init
from pragma_dsp_tpu.utils import (
    checksum, restore_state, sanitizer_mode, save_state, snr_db,
)
from pragma_dsp_tpu.parallel import barrier


def test_checkpoint_roundtrip_stft_state():
    state = stft_stream_init(256, 64, dtype=jnp.float64)
    state = StftState(tail=state.tail + 1.5)
    with tempfile.TemporaryDirectory() as d:
        path = save_state(os.path.join(d, "stft_state"), state)
        fresh = stft_stream_init(256, 64, dtype=jnp.float64)
        restored = restore_state(path, fresh)
    np.testing.assert_array_equal(np.asarray(restored.tail),
                                  np.asarray(state.tail))


def test_checkpoint_resume_continues_stream():
    taps = jnp.asarray(np.hamming(33) / 33)
    chunks = [np.random.default_rng(i).standard_normal(128) for i in range(4)]
    # run 2 chunks, checkpoint, restore, run 2 more
    s = fir_stream_init(taps, dtype=jnp.float64)
    outs = []
    for ch in chunks[:2]:
        s, y = fir_step(s, jnp.asarray(ch), taps)
        outs.append(np.asarray(y))
    with tempfile.TemporaryDirectory() as d:
        path = save_state(os.path.join(d, "fir"), s)
        s2 = restore_state(path, fir_stream_init(taps, dtype=jnp.float64))
    for ch in chunks[2:]:
        s2, y = fir_step(s2, jnp.asarray(ch), taps)
        outs.append(np.asarray(y))
    got = np.concatenate(outs)

    # single pass reference
    s3 = fir_stream_init(taps, dtype=jnp.float64)
    ref = []
    for ch in chunks:
        s3, y = fir_step(s3, jnp.asarray(ch), taps)
        ref.append(np.asarray(y))
    np.testing.assert_allclose(got, np.concatenate(ref), atol=1e-12)


def test_sanitizer_mode_runs_kernels_interpreted():
    """The sanitizer build is NaN-checking: finite pipelines run as
    usual inside it (here the dispatch FFT against numpy), a primitive
    that makes a NaN raises at once, and the flag is restored after."""
    import pytest

    from pragma_dsp_tpu.core import ComplexArray
    from pragma_dsp_tpu.ops import fft

    z = np.random.default_rng(0).standard_normal((2, 256)).astype(np.float32)
    before = jax.config.jax_debug_nans
    with sanitizer_mode():
        assert jax.config.jax_debug_nans
        out = fft(ComplexArray(jnp.asarray(z), jnp.zeros_like(jnp.asarray(z))))
        with pytest.raises(FloatingPointError):
            jnp.log(jnp.asarray([-1.0])).block_until_ready()
    assert jax.config.jax_debug_nans == before
    ref = np.fft.fft(z, axis=-1)
    assert snr_db(np.stack([ref.real, ref.imag]),
                  np.stack([np.asarray(out.real), np.asarray(out.imag)])) > 110


@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3", "cpu",
                                  "NVIDIA H200", "NVIDIA A100-SXM4-80GB"])
def test_device_specs_known_kind_or_error(kind):
    """Peaks come from one published table keyed by device_kind; a
    device missing from it is an error, never a fallback."""
    from pragma_dsp_tpu.utils.benchharness import device_specs

    if kind.startswith("NVIDIA H100"):
        s = device_specs(kind)
        assert s["kind"] == kind
        assert s["hbm_bytes_per_s"] == 3.35e12
        assert (s["f32_flops"], s["tf32_flops"], s["bf16_flops"]) == (
            67.0e12, 495.0e12, 989.0e12)
    else:
        with pytest.raises(KeyError, match="no published peaks"):
            device_specs(kind)


@pytest.mark.parametrize("env_dir", [None, "/elsewhere/jax-cache"])
def test_compile_cache_placement(env_dir, monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set the helper sets nothing;
    otherwise it pins the fixed <repo>/.jax_cache (never a temp, pid or
    time-based path, which would miss on every run)."""
    from pragma_dsp_tpu.utils import compile_cache as cc

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cc.REPO_CACHE_DIR == os.path.join(repo, ".jax_cache")
    env = {} if env_dir is None else {"JAX_COMPILATION_CACHE_DIR": env_dir}
    want = cc.REPO_CACHE_DIR if env_dir is None else None
    assert cc.compile_cache_dir(env) == want

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    got = cc.enable_compile_cache()
    if env_dir is None:
        assert got == cc.REPO_CACHE_DIR
        assert calls == [("jax_compilation_cache_dir", cc.REPO_CACHE_DIR)]
    else:
        assert got == env_dir and calls == []


def test_barrier_on_local_mesh():
    barrier()  # 8 virtual devices; must not raise


def test_barrier_watchdog_and_health_check():
    """Failure-detection surface (SURVEY.md §5): the watchdogged barrier
    completes well inside its window on a healthy mesh, and health_check
    reports the full local topology without any collective."""
    from pragma_dsp_tpu.parallel import health_check

    barrier(timeout_s=120.0)
    hc = health_check()
    assert hc["process_count"] == 1
    assert hc["local_devices"] == hc["global_devices"] == len(jax.devices())
    assert len(hc["devices"]) == hc["local_devices"]
    assert all("hbm_in_use" in d for d in hc["devices"])


def test_checksum_deterministic_and_sensitive():
    a = np.arange(100.0)
    assert checksum(a) == checksum(a.copy())
    b = a.copy()
    b[50] += 1e-3
    assert checksum(a) != checksum(b)


def test_check_finite_raises_under_jit():
    """checkify-based finiteness check propagates to the caller (VERDICT
    round-1 weak #4): one NaN in, one host-side exception out."""
    import pytest
    from pragma_dsp_tpu.utils.debug import check_finite, checked

    @jax.jit
    def stage(x):
        y = x * 2.0
        check_finite("stage", y)
        return y

    good = jnp.ones((4,))
    np.testing.assert_array_equal(np.asarray(checked(stage)(good)), 2.0)
    bad = good.at[1].set(jnp.nan)
    with pytest.raises(Exception, match="check_finite failed at 'stage'"):
        checked(stage)(bad)
