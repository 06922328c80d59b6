"""chip_smoke.py at tiny sizes on the CPU, and the precision guard for
the pipelines it drives.

Each phase function of chip_smoke runs here at a small size against the
same float64 oracle (or one-device comparison) it uses on the card, so
a wrong path, shape or oracle shows up before a chip run. main() must
refuse the CPU. The guard walks the traced programs of configs 1-5, the
1M FFT and the direct FIR, under the GPU's FFT route, and requires
every f32 matmul or convolution to name Precision.HIGHEST (the GPU
would otherwise be free to run it in TF32).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.extend import core as jcore

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from pragma_dsp_tpu import models, ops, stream  # noqa: E402
from pragma_dsp_tpu.core import ComplexArray  # noqa: E402
from pragma_dsp_tpu.parallel import data_mesh  # noqa: E402

ONE_CARD = [
    (cs.phase_spectrum, dict(rows=64, n=1024)),
    (cs.phase_spectrogram, dict(length=24000)),
    (cs.phase_resample, dict(length=24000)),
    (cs.phase_wbfm, dict(length=96000)),
    (cs.phase_pfb, dict(length=1 << 15)),
    (cs.phase_fft1m, dict(batch=2, n=1 << 12)),
]
FOUR_CARD = [
    (cs.phase_sharded_pfb, dict(per_card=1 << 13, channels=64, n_fft=16)),
    (cs.phase_dist_fft, dict(n2=32, n1=64, chunk_counts=(1, 2))),
    (cs.phase_sharded_fir, dict(length=1 << 13)),
    (cs.phase_sharded_spectrogram, dict(frames_per_card=8, n_fft=256,
                                        hop=64)),
]


@pytest.mark.parametrize("phase,size", ONE_CARD,
                         ids=[f.__name__ for f, _ in ONE_CARD])
def test_one_card_phase_tiny(phase, size):
    checks = phase(**size)
    assert checks
    for c in checks:
        assert c.ok, c.line()
        assert c.phase in c.line() and ("PASS" in c.line())


@pytest.mark.parametrize("phase,size", FOUR_CARD,
                         ids=[f.__name__ for f, _ in FOUR_CARD])
def test_four_card_phase_tiny(phase, size):
    """On four of the eight virtual CPU devices: every check passes and
    the outputs are spread over all four."""
    checks = phase(data_mesh(4), **size)
    spread = [c for c in checks if c.metric == "devices_holding_shards"]
    assert spread and all(c.value == 4.0 for c in spread)
    for c in checks:
        assert c.ok, c.line()


def test_main_refuses_cpu(capsys):
    """No GPU: a non-zero exit and no result line on stdout."""
    assert cs.main([]) != 0
    assert cs.main(["--cards", "4"]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_failed_check_reads_fail():
    bad = cs.Check("p", "e", "[1]", "snr_db", float("nan"), 105.0)
    assert not bad.ok and bad.line().endswith("FAIL")
    good = cs.Check("p", "e", "[1]", "snr_db", 120.0, 105.0, 1.0, 2.0)
    assert good.ok and "compile_s=1.0 run_ms=2.0" in good.line()


# ── precision guard ──────────────────────────────────────────────────


def _eqns(jaxpr):
    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(sub, jcore.ClosedJaxpr):
                    yield from _eqns(sub.jaxpr)
                elif isinstance(sub, jcore.Jaxpr):
                    yield from _eqns(sub)


def _f32(n, seed=0):
    return jnp.asarray(np.random.default_rng(seed).standard_normal(n),
                       jnp.float32)


def _iq(n):
    return ComplexArray(_f32(n, 1), _f32(n, 2))


def _wbfm_stream(iq):
    rx = models.FmReceiver()
    return rx.stream_step(rx.stream_init(dtype=jnp.float32), iq)


PIPELINES = {
    "config1_spectrum": (lambda x: cs.pd.spectrum(x, sample_rate=48e3),
                         lambda: _f32((4, 1024)), 0),
    "config2_spectrogram": (
        lambda x: (stream.spectrogram_amplitude(x, 4096, 1024),
                   stream.spectrogram(x, 4096, 1024, "hann", 48e3)),
        lambda: _f32(3 * 4096), 0),
    "config3_resample": (lambda x: ops.resample_poly(x, 147, 160),
                         lambda: _f32(4800), 1),
    "config4_wbfm": (lambda iq: (models.wbfm_demod(iq), _wbfm_stream(iq)),
                     lambda: _iq(24000), 1),
    "config5_pfb": (lambda iq: (ops.pfb_channelize(iq, 256),
                                ops.pfb_channelize_frames(
                                    ComplexArray(iq.real.reshape(-1, 256),
                                                 iq.imag.reshape(-1, 256)),
                                    256)),
                    lambda: _iq(256 * 32), 0),
    "fir_direct": (lambda x: ops.fir_filter(x, np.hamming(127),
                                            method="direct"),
                   lambda: _f32(4096), 1),
    "fft1m": (lambda iq: ops.ifft(ops.fft(iq)), lambda: _iq(1 << 20), 0),
}


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_no_default_precision_f32_products(name):
    """No f32 dot_general or convolution on the config paths may leave
    its precision to the backend (DEFAULT lets the GPU use TF32, ~3
    decimal digits, far below the 100-105 dB gates). Traced under the
    GPU's FFT route; pipelines with matmuls must have some (a guard
    that finds none would prove nothing there)."""
    from pragma_dsp_tpu.ops.dispatch import policy, set_fft_impl

    fn, make, min_products = PIPELINES[name]
    set_fft_impl(policy("gpu"))
    try:
        jaxpr = jax.make_jaxpr(lambda a: fn(a))(make()).jaxpr
    finally:
        set_fft_impl("auto")
    products = [e for e in _eqns(jaxpr)
                if e.primitive.name in ("dot_general", "conv_general_dilated")
                and any(v.aval.dtype == jnp.float32 for v in e.invars)]
    assert len(products) >= min_products
    hi = jax.lax.Precision.HIGHEST
    for e in products:
        prec = e.params.get("precision")
        assert prec is not None and all(p == hi for p in prec), (
            f"{name}: {e.primitive.name} with precision {prec}")
