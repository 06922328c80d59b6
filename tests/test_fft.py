"""FFT unit tests vs NumPy goldens (reference test/fft.test.ts:18-43)."""

import jax.numpy as jnp
import numpy as np
import pytest

from pragma_dsp_tpu.core import ComplexArray, Radix2Fft, fft, ifft
from pragma_dsp_tpu.utils.fixtures import assert_close, snr_db


def _cases(unit_fixtures, kind=None):
    for c in unit_fixtures["fftCases"]:
        if kind is None or c["kind"] == kind:
            yield c


def test_forward_matches_numpy(unit_fixtures):
    for c in _cases(unit_fixtures, "random_normal"):
        x = jnp.asarray(c["input"], dtype=jnp.float64)
        out = fft(x)
        assert_close(c["fftRe"], np.asarray(out.real), abs_tol=1e-6,
                     label=f"{c['name']} re")
        assert_close(c["fftIm"], np.asarray(out.imag), abs_tol=1e-6,
                     label=f"{c['name']} im")


def test_roundtrip(unit_fixtures):
    for c in _cases(unit_fixtures, "random_normal"):
        x = jnp.asarray(c["input"], dtype=jnp.float64)
        rt = ifft(fft(x))
        assert_close(c["input"], np.asarray(rt.real), abs_tol=1e-6,
                     label=f"{c['name']} rt re")
        assert_close(np.zeros(c["n"]), np.asarray(rt.imag), abs_tol=1e-6,
                     label=f"{c['name']} rt im")


def test_plan_class_validates():
    with pytest.raises(ValueError):
        Radix2Fft(12)
    plan = Radix2Fft(16)
    with pytest.raises(ValueError):
        plan.forward(jnp.zeros(8))


@pytest.mark.slow
def test_plan_forward_inverse(unit_fixtures):
    for c in _cases(unit_fixtures, "random_normal"):
        plan = Radix2Fft(c["n"])
        out = plan.forward(jnp.asarray(c["input"], dtype=jnp.float64))
        assert_close(c["fftRe"], np.asarray(out.real), abs_tol=1e-6)
        rt = plan.inverse(out)
        assert_close(c["input"], np.asarray(rt.real), abs_tol=1e-6)


def test_forward_complex_matches_numpy():
    rng = np.random.default_rng(7)
    z = rng.standard_normal(64) + 1j * rng.standard_normal(64)
    out = fft(ComplexArray(jnp.asarray(z.real), jnp.asarray(z.imag)))
    ref = np.fft.fft(z)
    assert_close(ref.real, np.asarray(out.real), abs_tol=1e-10)
    assert_close(ref.imag, np.asarray(out.imag), abs_tol=1e-10)


@pytest.mark.slow
def test_batched_fft_matches_numpy():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 5, 128))
    out = fft(jnp.asarray(x))
    ref = np.fft.fft(x, axis=-1)
    assert_close(ref.real, np.asarray(out.real), abs_tol=1e-9)
    assert_close(ref.imag, np.asarray(out.imag), abs_tol=1e-9)


@pytest.mark.slow
def test_fft_over_axis0():
    rng = np.random.default_rng(13)
    x = rng.standard_normal((64, 9))
    out = fft(jnp.asarray(x), axis=0)
    ref = np.fft.fft(x, axis=0)
    assert_close(ref.real, np.asarray(out.real), abs_tol=1e-9)
    assert_close(ref.imag, np.asarray(out.imag), abs_tol=1e-9)


def test_non_power_of_two_raises():
    with pytest.raises(ValueError):
        fft(jnp.zeros(12))


def test_plan_routes_through_dispatch():
    """Radix2Fft is built on ops.dispatch: pinning the "xla" impl
    (jnp.fft, cuFFT on the GPU) flows through the expert rung and agrees
    with the portable stockham path and numpy."""
    from pragma_dsp_tpu.ops.dispatch import set_fft_impl

    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((4, 256)), jnp.float32)
    outs = {}
    for impl in ("xla", "stockham"):
        set_fft_impl(impl)
        try:
            outs[impl] = Radix2Fft(256).forward(x)
        finally:
            set_fft_impl("auto")
    ref = np.fft.fft(np.asarray(x, np.float64), axis=-1)
    for label, out in outs.items():
        assert_close(ref.real, np.asarray(out.real), abs_tol=1e-3,
                     label=f"{label} re")
        assert_close(ref.imag, np.asarray(out.imag), abs_tol=1e-3,
                     label=f"{label} im")
    np.testing.assert_allclose(np.asarray(outs["xla"].real),
                               np.asarray(outs["stockham"].real), atol=2e-3)


@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("n", [8, 256, 1024, 4096])
def test_xla_impl_matches_numpy(n, axis):
    """The "xla" route joins the split planes into complex, runs
    jnp.fft and splits again: f64 in stays f64 (exact to rounding), f32
    stays f32, and inverse(forward) is the identity."""
    from pragma_dsp_tpu.ops import fft as dfft, ifft as difft

    rng = np.random.default_rng(n)
    shape = (3, n) if axis == -1 else (n, 3)
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    ref = np.fft.fft(z, axis=axis)
    for dtype, tol_db in ((jnp.float64, 250.0), (jnp.float32, 120.0)):
        xc = ComplexArray(jnp.asarray(z.real, dtype),
                          jnp.asarray(z.imag, dtype))
        out = dfft(xc, axis=axis, impl="xla")
        assert out.real.dtype == dtype and out.real.shape == shape
        got = np.asarray(out.real) + 1j * np.asarray(out.imag)
        assert snr_db(ref, got) > tol_db
        back = difft(out, axis=axis, impl="xla")
        rt = np.asarray(back.real) + 1j * np.asarray(back.imag)
        assert snr_db(z, rt) > tol_db


@pytest.mark.parametrize("platform,expected", [
    ("cpu", "stockham"), ("gpu", "xla"), ("rocm", None), ("METAL", None)])
def test_dispatch_policy_per_platform(platform, expected):
    """The per-platform choice lives in ops.dispatch alone: stockham on
    the CPU (the independent f64 reference), cuFFT on the GPU, and any
    other platform is an error instead of a silent default."""
    from pragma_dsp_tpu.ops.dispatch import policy

    if expected is None:
        with pytest.raises(ValueError, match="no FFT policy"):
            policy(platform)
    else:
        assert policy(platform) == expected


def test_fft_route_follows_override_and_rejects_unknown_impl():
    from pragma_dsp_tpu.ops.dispatch import (fft as dfft, fft_route,
                                             set_fft_impl)

    assert fft_route() == "stockham"          # the test process is CPU
    set_fft_impl("xla")
    try:
        assert fft_route() == "xla"
    finally:
        set_fft_impl("auto")
    for gone in ("pallas", "big", "fourstep"):
        with pytest.raises(ValueError, match="unknown fft impl"):
            set_fft_impl(gone)
    with pytest.raises(ValueError, match="unknown fft impl"):
        dfft(jnp.zeros(8), impl="pallas")
