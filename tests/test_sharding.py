"""Multi-chip sharding tests on the 8-device virtual CPU mesh
(SURVEY.md §4: collective logic testable without a pod)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P
from scipy import signal as sps

from pragma_dsp_tpu.core import ComplexArray
from pragma_dsp_tpu.ops.channelizer import pfb_channelize, pfb_taps
from pragma_dsp_tpu.parallel import (
    data_mesh, dist_fft, dist_fft_shape, dist_ifft,
    permuted_to_natural_host, sharded_fir_filter, sharded_pfb_channelize,
    sharded_spectrogram,
)
from pragma_dsp_tpu.stream import spectrogram
from pragma_dsp_tpu.utils.fixtures import assert_snr, snr_db

RNG = np.random.default_rng(50)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must spoof 8 cpu devices"
    return data_mesh(8)


def test_eight_virtual_devices_present():
    assert len(jax.devices()) == 8


def test_dist_fft_matches_numpy(mesh):
    n = 1 << 14
    n2, n1 = dist_fft_shape(n, 8)
    x = RNG.standard_normal(n) + 1j * RNG.standard_normal(n)
    xv = x.reshape(n2, n1)
    xc = ComplexArray(jnp.asarray(xv.real), jnp.asarray(xv.imag))
    p = dist_fft(xc, mesh)
    got = permuted_to_natural_host(p)
    ref = np.fft.fft(x)
    assert snr_db(np.stack([ref.real, ref.imag]),
                  np.stack([got.real, got.imag])) > 200  # f64 on cpu


def test_dist_fft_roundtrip(mesh):
    n = 1 << 12
    n2, n1 = dist_fft_shape(n, 8)
    x = RNG.standard_normal(n) + 1j * RNG.standard_normal(n)
    xv = x.reshape(n2, n1)
    xc = ComplexArray(jnp.asarray(xv.real), jnp.asarray(xv.imag))
    rt = dist_ifft(dist_fft(xc, mesh), mesh)
    got = (np.asarray(rt.real) + 1j * np.asarray(rt.imag)).reshape(n)
    np.testing.assert_allclose(got, x, atol=1e-10)


def test_dist_fft_million_point(mesh):
    # The headline 1M-point distributed FFT (config: north star).
    n = 1 << 20
    n2, n1 = dist_fft_shape(n, 8)
    x = (RNG.standard_normal(n) + 1j * RNG.standard_normal(n)).astype(np.complex64)
    xv = x.reshape(n2, n1)
    xc = ComplexArray(jnp.asarray(xv.real), jnp.asarray(xv.imag))
    p = dist_fft(xc, mesh)
    got = permuted_to_natural_host(p)
    ref = np.fft.fft(x)
    assert snr_db(np.stack([ref.real, ref.imag]),
                  np.stack([got.real, got.imag])) > 90  # f32


def test_sharded_fir_equals_lfilter(mesh):
    x = RNG.standard_normal(8 * 512)
    taps = sps.firwin(127, 0.2)
    y = sharded_fir_filter(jnp.asarray(x), jnp.asarray(taps), mesh,
                           method="direct")
    ref = sps.lfilter(taps, 1.0, x)
    assert_snr(ref, np.asarray(y), 120, "sharded fir")


def test_sharded_fir_complex(mesh):
    z = RNG.standard_normal(2048) + 1j * RNG.standard_normal(2048)
    taps = sps.firwin(63, 0.3)
    y = sharded_fir_filter(
        ComplexArray(jnp.asarray(z.real), jnp.asarray(z.imag)),
        jnp.asarray(taps), mesh)
    ref = sps.lfilter(taps, 1.0, z)
    assert_snr(ref.real, np.asarray(y.real), 120)
    assert_snr(ref.imag, np.asarray(y.imag), 120)


def test_sharded_spectrogram_matches_local(mesh):
    # Default tail policy: FULL-array equality with the single-device
    # result (round-1 VERDICT weak #6 — no foot-gun trailing frames).
    n_fft, hop = 256, 64
    x = RNG.standard_normal(8 * 1024)
    r = sharded_spectrogram(jnp.asarray(x), n_fft, hop, "hann", 48000.0,
                            mesh=mesh)
    local = spectrogram(jnp.asarray(x), n_fft, hop, "hann", 48000.0)
    assert r.amplitude.shape == local.amplitude.shape
    np.testing.assert_allclose(np.asarray(r.amplitude),
                               np.asarray(local.amplitude), atol=1e-10)
    np.testing.assert_allclose(np.asarray(r.phase), np.asarray(local.phase),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(r.peak.frequency),
                               np.asarray(local.peak.frequency), atol=0)
    np.testing.assert_allclose(np.asarray(r.peak.amplitude),
                               np.asarray(local.peak.amplitude), atol=1e-10)


def test_sharded_spectrogram_pad_tail(mesh):
    # pad_tail=True keeps the uniform L//hop frame grid; the extra
    # trailing frames treat the stream end as zero-padded.
    n_fft, hop = 256, 64
    x = RNG.standard_normal(8 * 1024)
    r = sharded_spectrogram(jnp.asarray(x), n_fft, hop, "hann", 48000.0,
                            mesh=mesh, pad_tail=True)
    local = spectrogram(jnp.asarray(x), n_fft, hop, "hann", 48000.0)
    f_local = local.amplitude.shape[0]
    assert r.amplitude.shape[0] == (8 * 1024) // hop
    np.testing.assert_allclose(np.asarray(r.amplitude)[:f_local],
                               np.asarray(local.amplitude), atol=1e-10)


def test_sharded_channelizer_matches_local(mesh):
    c = 32
    x = RNG.standard_normal(8 * c * 8) + 1j * RNG.standard_normal(8 * c * 8)
    xc = ComplexArray(jnp.asarray(x.real), jnp.asarray(x.imag))
    h = pfb_taps(c, 8)
    ref = pfb_channelize(xc, c, h)
    got = sharded_pfb_channelize(xc, c, h, mesh=mesh,
                                 channels_sharded_out=False)
    np.testing.assert_allclose(np.asarray(got.real), np.asarray(ref.real),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(got.imag), np.asarray(ref.imag),
                               atol=1e-10)


def test_sharded_channelizer_corner_turn(mesh):
    # channels_sharded_out=True must give the same values with the
    # channel axis sharded: compare against the frames-sharded result.
    c = 32
    x = RNG.standard_normal(8 * c * 8) + 1j * RNG.standard_normal(8 * c * 8)
    xc = ComplexArray(jnp.asarray(x.real), jnp.asarray(x.imag))
    a = sharded_pfb_channelize(xc, c, mesh=mesh, channels_sharded_out=False)
    b = sharded_pfb_channelize(xc, c, mesh=mesh, channels_sharded_out=True)
    np.testing.assert_allclose(np.asarray(b.real), np.asarray(a.real),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(b.imag), np.asarray(a.imag),
                               atol=1e-10)
    shard_shapes = {s.data.shape for s in b.real.addressable_shards}
    assert shard_shapes == {(a.real.shape[0], c // 8)}


@pytest.mark.slow
def test_sharded_channelizer_config5_256ch(mesh):
    """BASELINE.json config 5 at spec scale: 256-channel PFB over the
    8-device mesh, exact equality with the single-device channelizer and
    channel-sharded output shapes (round-1 VERDICT next-step #4).

    The 100 Msps / 1 s workload shape is driven CHUNKED (memory-bound on
    the CPU test mesh): each chunked sharded call carries the (T-1)*C
    branch history explicitly, exactly like ops.pfb_channelize_step, so
    the concatenated chunk outputs equal one continuous-stream result.
    """
    c = 256
    t_taps = 8
    h = pfb_taps(c, t_taps)
    chunk = 8 * c * 16                       # 32768 samples per chunk
    n_chunks = 6
    total = chunk * n_chunks
    x = (RNG.standard_normal(total)
         + 1j * RNG.standard_normal(total)).astype(np.complex64)

    # continuous-stream reference on one device
    ref = pfb_channelize(
        ComplexArray(jnp.asarray(x.real), jnp.asarray(x.imag)), c, h)

    # Carry 8*C = 2048 >= (T-1)*C history samples so history+chunk still
    # splits evenly over the 8-way mesh in whole channels; the first
    # 2048/C = 8 output frames of each call are warm-up recomputes.
    hist = 8 * c
    assert hist >= (t_taps - 1) * c
    warm = hist // c
    tail = np.zeros(hist, np.complex64)
    outs = []
    shard_shapes = None
    for i in range(n_chunks):
        seg = np.concatenate([tail, x[i * chunk:(i + 1) * chunk]])
        xc = ComplexArray(jnp.asarray(seg.real), jnp.asarray(seg.imag))
        got = sharded_pfb_channelize(xc, c, h, mesh=mesh,
                                     channels_sharded_out=True)
        shard_shapes = {s.data.shape for s in got.real.addressable_shards}
        outs.append((np.asarray(got.real)[warm:],
                     np.asarray(got.imag)[warm:]))
        tail = x[(i + 1) * chunk - hist:(i + 1) * chunk]
    got_re = np.concatenate([o[0] for o in outs], axis=0)
    got_im = np.concatenate([o[1] for o in outs], axis=0)
    assert got_re.shape == ref.real.shape == (total // c, c)
    np.testing.assert_allclose(got_re, np.asarray(ref.real), atol=1e-5)
    np.testing.assert_allclose(got_im, np.asarray(ref.imag), atol=1e-5)
    # channel-sharded layout: each device owns C/8 whole channels
    frames_per_call = (chunk + hist) // c
    assert shard_shapes == {(frames_per_call, c // 8)}


def test_input_shardings_respected(mesh):
    # Feed explicitly device-put sharded inputs; output must come back
    # sharded without errors.
    n = 1 << 14  # same size as test_dist_fft_matches_numpy -> shares jit cache
    n2, n1 = dist_fft_shape(n, 8)
    x = RNG.standard_normal((n2, n1))
    sh = NamedSharding(mesh, P(None, "x"))
    xr = jax.device_put(jnp.asarray(x), sh)
    xi = jax.device_put(jnp.zeros_like(jnp.asarray(x)), sh)
    p = dist_fft(ComplexArray(xr, xi), mesh)
    out_shard_shapes = {s.data.shape for s in p.real.addressable_shards}
    assert out_shard_shapes == {(n2 // 8, n1)}


# ── 2-D (host, chip) mesh — the >=2-host story (round-2 VERDICT #4) ──


@pytest.fixture(scope="module")
def mesh2d():
    from pragma_dsp_tpu.parallel import make_mesh
    return make_mesh((2, 4), ("host", "chip"))


def test_2d_mesh_pfb_channels_sharded_over_host(mesh2d):
    """Config-5 layout on a (2 hosts x 4 chips) mesh: time sharded over
    the host-major joint axis (halo ppermute hops ride 'chip' within a
    host), channels resharded by ONE all_to_all over the joint axis so
    the channel dim ends up sharded host-major — each host owns a
    contiguous block of whole channels."""
    c = 32
    x = RNG.standard_normal(8 * c * 8) + 1j * RNG.standard_normal(8 * c * 8)
    xc = ComplexArray(jnp.asarray(x.real), jnp.asarray(x.imag))
    h = pfb_taps(c, 8)
    ref = pfb_channelize(xc, c, h)
    got = sharded_pfb_channelize(xc, c, h, mesh=mesh2d,
                                 axis=("host", "chip"),
                                 channels_sharded_out=True)
    np.testing.assert_allclose(np.asarray(got.real), np.asarray(ref.real),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(got.imag), np.asarray(ref.imag),
                               atol=1e-10)
    # each of the 8 devices owns C/8 whole channels; host-major order
    shard_shapes = {s.data.shape for s in got.real.addressable_shards}
    assert shard_shapes == {(ref.real.shape[0], c // 8)}
    # the channel dim must be sharded over BOTH axes (host-major)
    spec = got.real.sharding.spec
    assert tuple(spec[-1]) == ("host", "chip")


def test_2d_mesh_pfb_frames_sharded(mesh2d):
    c = 32
    x = RNG.standard_normal(8 * c * 8) + 1j * RNG.standard_normal(8 * c * 8)
    xc = ComplexArray(jnp.asarray(x.real), jnp.asarray(x.imag))
    ref = pfb_channelize(xc, c)
    got = sharded_pfb_channelize(xc, c, mesh=mesh2d, axis=("host", "chip"),
                                 channels_sharded_out=False)
    np.testing.assert_allclose(np.asarray(got.real), np.asarray(ref.real),
                               atol=1e-10)


def test_2d_mesh_fir_halo(mesh2d):
    """FIR halos on the joint host-major ring must equal lfilter exactly
    (the K-1 halo crosses a host boundary only between chip 3 of host 0
    and chip 0 of host 1)."""
    taps = np.hamming(31)
    x = RNG.standard_normal(4096)
    ref = sps.lfilter(taps, 1.0, x)
    got = sharded_fir_filter(jnp.asarray(x), jnp.asarray(taps), mesh2d,
                             axis=("host", "chip"))
    np.testing.assert_allclose(np.asarray(got), ref, atol=1e-10)


def test_2d_mesh_spectrogram(mesh2d):
    n_fft, hop = 256, 64
    x = RNG.standard_normal(8 * 1024)
    ref = spectrogram(jnp.asarray(x), n_fft, hop, "hann", 48000.0)
    got = sharded_spectrogram(jnp.asarray(x), n_fft, hop, "hann", 48000.0,
                              mesh=mesh2d, axis=("host", "chip"))
    np.testing.assert_allclose(np.asarray(got.amplitude),
                               np.asarray(ref.amplitude), atol=1e-10)
    np.testing.assert_allclose(np.asarray(got.peak.index),
                               np.asarray(ref.peak.index))


def test_2d_mesh_chip_only_subaxis(mesh2d):
    """A 1-D pipeline can also run on just one axis of a 2-D mesh (e.g.
    halos confined to the 4-chip ICI axis, 2-way host batch outside)."""
    taps = np.hamming(17)
    x = RNG.standard_normal((2, 2048))
    ref = sps.lfilter(taps, 1.0, x, axis=-1)
    got = sharded_fir_filter(jnp.asarray(x), jnp.asarray(taps), mesh2d,
                             axis="chip")
    np.testing.assert_allclose(np.asarray(got), ref, atol=1e-10)


# ── dist_fft: batch dims + chunked overlap (round-2 VERDICT #6) ──


@pytest.mark.slow
def test_dist_fft_batched(mesh):
    """Leading batch axes run through the same sharded transform."""
    n = 1 << 12
    n2, n1 = dist_fft_shape(n, 8)
    x = RNG.standard_normal((3, n)) + 1j * RNG.standard_normal((3, n))
    xv = x.reshape(3, n2, n1)
    xc = ComplexArray(jnp.asarray(xv.real), jnp.asarray(xv.imag))
    p = dist_fft(xc, mesh)
    got = permuted_to_natural_host(p)
    ref = np.fft.fft(x, axis=-1)
    assert snr_db(np.stack([ref.real, ref.imag]),
                  np.stack([got.real, got.imag])) > 200
    rt = dist_ifft(p, mesh)
    back = (np.asarray(rt.real) + 1j * np.asarray(rt.imag)).reshape(3, n)
    np.testing.assert_allclose(back, x, atol=1e-10)


@pytest.mark.slow
@pytest.mark.parametrize("chunks", [1, 2, 4, 8])
def test_dist_fft_chunked_overlap_parity(mesh, chunks):
    """Every overlap depth must give the identical transform (the
    chunked corner turn slices output rows/lanes, changing only the
    collective schedule, never values)."""
    n = 1 << 14
    n2, n1 = dist_fft_shape(n, 8)
    x = RNG.standard_normal(n) + 1j * RNG.standard_normal(n)
    xv = x.reshape(n2, n1)
    xc = ComplexArray(jnp.asarray(xv.real), jnp.asarray(xv.imag))
    p = dist_fft(xc, mesh, chunks=chunks)
    got = permuted_to_natural_host(p)
    ref = np.fft.fft(x)
    assert snr_db(np.stack([ref.real, ref.imag]),
                  np.stack([got.real, got.imag])) > 200
    rt = dist_ifft(p, mesh, chunks=chunks)
    back = (np.asarray(rt.real) + 1j * np.asarray(rt.imag)).reshape(n)
    np.testing.assert_allclose(back, x, atol=1e-10)


def test_dist_fft_rejects_bad_chunks(mesh):
    n2, n1 = dist_fft_shape(1 << 12, 8)
    x = RNG.standard_normal((n2, n1))
    xc = ComplexArray(jnp.asarray(x), jnp.asarray(np.zeros_like(x)))
    with pytest.raises(ValueError, match="chunks"):
        dist_fft(xc, mesh, chunks=7)


def test_dist_fft_first_called_inside_jit(mesh):
    """Regression: the lru-cached shard_map builder used to materialise
    its twiddle tables as jnp constants at build time — if the FIRST
    dist_fft call happened inside a user's jit, those constants were
    trace-local tracers that leaked into every later call
    (UnexpectedTracerError). Clear the cache and trace-first-call."""
    from pragma_dsp_tpu.parallel.dist_fft import _build_dist_fft

    _build_dist_fft.cache_clear()
    n = 1 << 12
    n2, n1 = dist_fft_shape(n, 8)
    x = RNG.standard_normal(n) + 1j * RNG.standard_normal(n)
    xr = jnp.asarray(x.real.reshape(n2, n1))
    xi = jnp.asarray(x.imag.reshape(n2, n1))

    @jax.jit
    def run(r, i):
        def body(_, c):
            o = dist_ifft(dist_fft(ComplexArray(c[0], c[1]), mesh), mesh)
            return (o.real, o.imag)
        return jax.lax.fori_loop(0, 2, body, (r, i))

    orr, oii = run(xr, xi)
    np.testing.assert_allclose(np.asarray(orr), x.real.reshape(n2, n1),
                               atol=1e-9)
    np.testing.assert_allclose(np.asarray(oii), x.imag.reshape(n2, n1),
                               atol=1e-9)
    # and a fresh call OUTSIDE jit must still work (cache now warm)
    p = dist_fft(ComplexArray(xr, xi), mesh)
    got = permuted_to_natural_host(p)
    assert snr_db(np.stack([np.fft.fft(x).real, np.fft.fft(x).imag]),
                  np.stack([got.real, got.imag])) > 200


def test_2d_mesh_dist_fft_dp_over_host(mesh2d):
    """The 2-D pod layout for batched long transforms: batch (dp)
    sharded over 'host', each FFT's corner turn confined to the 4-chip
    'chip' (ICI) axis — no collective ever crosses the host axis."""
    n = 1 << 12
    n2, n1 = dist_fft_shape(n, 4)
    x = RNG.standard_normal((4, n)) + 1j * RNG.standard_normal((4, n))
    xv = x.reshape(4, n2, n1)
    xc = ComplexArray(jnp.asarray(xv.real), jnp.asarray(xv.imag))
    p = dist_fft(xc, mesh2d, axis="chip", batch_axis="host")
    got = permuted_to_natural_host(p)
    ref = np.fft.fft(x, axis=-1)
    assert snr_db(np.stack([ref.real, ref.imag]),
                  np.stack([got.real, got.imag])) > 200
    # output layout: batch over host, k2 rows over chip
    spec = p.real.sharding.spec
    assert spec[0] == "host" and spec[1] == "chip"
    rt = dist_ifft(p, mesh2d, axis="chip", batch_axis="host")
    back = (np.asarray(rt.real) + 1j * np.asarray(rt.imag)).reshape(4, n)
    np.testing.assert_allclose(back, x, atol=1e-10)


def test_dist_fft_batch_axis_validation(mesh2d):
    n2, n1 = dist_fft_shape(1 << 12, 4)
    x = RNG.standard_normal((n2, n1))
    xc = ComplexArray(jnp.asarray(x), jnp.asarray(np.zeros_like(x)))
    with pytest.raises(ValueError, match="batch"):
        dist_fft(xc, mesh2d, axis="chip", batch_axis="host")
    with pytest.raises(ValueError, match="not a mesh axis"):
        dist_fft(xc, mesh2d, axis="chip", batch_axis="nope")


# ── sharded WBFM chain — config 4 at the "1 host" scale ──


def _fm_iq(length, fs=2.4e6, dev=75e3, phi0=1.0):
    # phi0 != 0 so the stream's first sample has nonzero phase: the
    # device-0 boundary dphi equals angle(chan[0]) only if the sharded
    # chain honours the batch discriminator's x[-1]=1+0j convention
    # (with phi0=0 a broken boundary coincidentally matches).
    t = np.arange(length) / fs
    msg = 0.7 * np.sin(2 * np.pi * 1000.0 * t) \
        + 0.2 * np.sin(2 * np.pi * 4000.0 * t)
    z = np.exp(1j * (phi0 + 2 * np.pi * dev * np.cumsum(msg) / fs))
    return ComplexArray(jnp.asarray(z.real), jnp.asarray(z.imag))


def test_sharded_wbfm_matches_batch_prefix(mesh):
    """Warm-up-halo time sharding: exact (to f64 round-off) steady-state
    audio — the de-emphasis IIR transient decays below round-off inside
    the 8200-sample halo, and both polyphase grids realign because the
    shard offsets are quantum multiples."""
    from pragma_dsp_tpu.models.fm_receiver import FmReceiver
    from pragma_dsp_tpu.parallel import sharded_wbfm_demod

    xc = _fm_iq(8 * 16800)
    ref = np.asarray(FmReceiver()(xc))
    got = np.asarray(sharded_wbfm_demod(xc, mesh))
    assert got.shape[-1] == (8 * 16800 // 50)
    np.testing.assert_allclose(got, ref[: got.shape[-1]], atol=1e-12)


def test_sharded_wbfm_2d_mesh(mesh2d):
    from pragma_dsp_tpu.models.fm_receiver import FmReceiver
    from pragma_dsp_tpu.parallel import sharded_wbfm_demod

    xc = _fm_iq(8 * 16800)
    ref = np.asarray(FmReceiver()(xc))
    got = np.asarray(sharded_wbfm_demod(xc, mesh2d, axis=("host", "chip")))
    np.testing.assert_allclose(got, ref[: got.shape[-1]], atol=1e-12)


def test_sharded_wbfm_validation(mesh):
    from pragma_dsp_tpu.parallel import sharded_wbfm_demod

    with pytest.raises(ValueError, match="quantum"):
        sharded_wbfm_demod(_fm_iq(8 * 16801), mesh)
    with pytest.raises(ValueError, match="halo"):
        sharded_wbfm_demod(_fm_iq(8 * 400), mesh)


def test_sharded_wbfm_stays_on_banded_path(mesh):
    """Same guard as tests/test_fm_receiver.py: the receiver inside the
    shard_map body must keep numpy taps so upfirdn stays on its
    banded-matmul path (a traced-taps regression silently falls back to
    the dilated conv)."""
    from pragma_dsp_tpu.parallel import sharded_wbfm_demod

    xc = _fm_iq(8 * 16800)
    jaxpr = str(jax.make_jaxpr(
        lambda a, b: sharded_wbfm_demod(ComplexArray(a, b), mesh))(
            xc.real, xc.imag))
    assert "conv_general_dilated" not in jaxpr


# ── frames-sharded PFB + no-turn consumer (round-4 VERDICT #2/#5) ──


def test_sharded_pfb_frames_equals_single_device(mesh):
    from pragma_dsp_tpu.ops.channelizer import pfb_channelize_frames
    from pragma_dsp_tpu.parallel import sharded_pfb_channelize_frames

    c = 32
    m = 8 * 16
    x = RNG.standard_normal((m, c)) + 1j * RNG.standard_normal((m, c))
    xc = ComplexArray(jnp.asarray(x.real), jnp.asarray(x.imag))
    ref = pfb_channelize_frames(xc, c)
    got = sharded_pfb_channelize_frames(xc, c, mesh=mesh,
                                        channels_sharded_out=False)
    np.testing.assert_allclose(np.asarray(got.real), np.asarray(ref.real),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(got.imag), np.asarray(ref.imag),
                               atol=1e-10)
    # the frame axis stays sharded
    shard_shapes = {s.data.shape for s in got.real.addressable_shards}
    assert shard_shapes == {(m // 8, c)}


def test_sharded_pfb_frames_corner_turn(mesh):
    from pragma_dsp_tpu.parallel import sharded_pfb_channelize_frames

    c = 32
    m = 8 * 16
    x = RNG.standard_normal((m, c)) + 1j * RNG.standard_normal((m, c))
    xc = ComplexArray(jnp.asarray(x.real), jnp.asarray(x.imag))
    a = sharded_pfb_channelize_frames(xc, c, mesh=mesh,
                                      channels_sharded_out=False)
    b = sharded_pfb_channelize_frames(xc, c, mesh=mesh,
                                      channels_sharded_out=True)
    np.testing.assert_allclose(np.asarray(b.real), np.asarray(a.real),
                               atol=1e-10)
    shard_shapes = {s.data.shape for s in b.real.addressable_shards}
    assert shard_shapes == {(m, c // 8)}


def test_sharded_pfb_frames_equals_flat_sharded(mesh):
    """The frames-sharded entry and the flat-sharded entry are the same
    stream in two views."""
    from pragma_dsp_tpu.parallel import sharded_pfb_channelize_frames

    c = 32
    m = 8 * 16
    x = RNG.standard_normal(m * c) + 1j * RNG.standard_normal(m * c)
    flat = ComplexArray(jnp.asarray(x.real), jnp.asarray(x.imag))
    frames = ComplexArray(jnp.asarray(x.real.reshape(m, c)),
                          jnp.asarray(x.imag.reshape(m, c)))
    a = sharded_pfb_channelize(flat, c, mesh=mesh,
                               channels_sharded_out=False)
    b = sharded_pfb_channelize_frames(frames, c, mesh=mesh,
                                      channels_sharded_out=False)
    np.testing.assert_allclose(np.asarray(b.real), np.asarray(a.real),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(b.imag), np.asarray(a.imag),
                               atol=1e-12)


def _channel_power_oracle(y, n_fft, window_vals):
    """Welch (zero-overlap) per-channel power from the full channelizer
    output y [M, C]: mean |FFT(w * seg)|^2 / (n_fft * sum w^2)."""
    m, c = y.shape
    nseg = m // n_fft
    segs = y[: nseg * n_fft].reshape(nseg, n_fft, c)
    spec = np.fft.fft(segs * window_vals[None, :, None], axis=1)
    return (np.abs(spec) ** 2).mean(axis=0) / (
        n_fft * np.sum(window_vals ** 2))


def test_sharded_channel_power_matches_oracle(mesh):
    from pragma_dsp_tpu.ops.channelizer import pfb_channelize_frames
    from pragma_dsp_tpu.parallel import sharded_channel_power
    from pragma_dsp_tpu.xform import create_window

    c = 32
    n_fft = 8
    m = 8 * n_fft * 3                     # 3 segments per device
    x = RNG.standard_normal((m, c)) + 1j * RNG.standard_normal((m, c))
    xc = ComplexArray(jnp.asarray(x.real), jnp.asarray(x.imag))
    got = np.asarray(sharded_channel_power(xc, c, mesh=mesh, n_fft=n_fft,
                                           window="hann"))
    yref = pfb_channelize_frames(xc, c)
    y = np.asarray(yref.real) + 1j * np.asarray(yref.imag)
    w = np.asarray(create_window("hann", n_fft), np.float64)
    ref = _channel_power_oracle(y, n_fft, w)
    assert got.shape == (n_fft, c)
    np.testing.assert_allclose(got, ref, rtol=1e-7, atol=1e-12)


def test_sharded_channel_power_finds_tone(mesh):
    """A tone at channel-k centre must put its power in channel k's DC
    bin — the end-to-end no-turn config-5 pipeline sanity check."""
    from pragma_dsp_tpu.parallel import sharded_channel_power

    c = 32
    n_fft = 8
    m = 8 * n_fft * 2
    k = 11
    x = np.exp(2j * np.pi * (k / c) * np.arange(m * c))
    xc = ComplexArray(jnp.asarray(x.real.reshape(m, c)),
                      jnp.asarray(x.imag.reshape(m, c)))
    p = np.asarray(sharded_channel_power(xc, c, mesh=mesh, n_fft=n_fft,
                                         window="rect"))
    ch_power = p.sum(axis=0)
    assert int(np.argmax(ch_power)) == k
    # tone at exact channel centre -> DC bin of that channel
    assert int(np.argmax(p[:, k])) == 0


def test_sharded_channel_power_validation(mesh):
    from pragma_dsp_tpu.parallel import sharded_channel_power

    xc = ComplexArray(jnp.zeros((8 * 12, 32)), jnp.zeros((8 * 12, 32)))
    with pytest.raises(ValueError, match="multiple of"):
        sharded_channel_power(xc, 32, mesh=mesh, n_fft=8)
    with pytest.raises(ValueError, match="frames input"):
        sharded_channel_power(ComplexArray(jnp.zeros(64), jnp.zeros(64)),
                              32, mesh=mesh)


def test_2d_mesh_channel_power(mesh2d):
    """The no-turn pipeline on the (host, chip) mesh: nothing fat ever
    crosses DCN — the only collective is the [n_fft, C] psum."""
    from pragma_dsp_tpu.ops.channelizer import pfb_channelize_frames
    from pragma_dsp_tpu.parallel import sharded_channel_power
    from pragma_dsp_tpu.xform import create_window

    c = 32
    n_fft = 8
    m = 8 * n_fft * 2
    x = RNG.standard_normal((m, c)) + 1j * RNG.standard_normal((m, c))
    xc = ComplexArray(jnp.asarray(x.real), jnp.asarray(x.imag))
    got = np.asarray(sharded_channel_power(xc, c, mesh=mesh2d,
                                           axis=("host", "chip"),
                                           n_fft=n_fft, window="hann"))
    yref = pfb_channelize_frames(xc, c)
    y = np.asarray(yref.real) + 1j * np.asarray(yref.imag)
    w = np.asarray(create_window("hann", n_fft), np.float64)
    ref = _channel_power_oracle(y, n_fft, w)
    np.testing.assert_allclose(got, ref, rtol=1e-7, atol=1e-12)


def test_dist_fft_auto_depth_runs(mesh):
    """The default depth (chunks=1, the monolithic corner turn) keeps
    parity."""
    n = 1 << 12
    n2, n1 = dist_fft_shape(n, 8)
    x = RNG.standard_normal(n) + 1j * RNG.standard_normal(n)
    xc = ComplexArray(jnp.asarray(x.reshape(n2, n1).real),
                      jnp.asarray(x.reshape(n2, n1).imag))
    got = permuted_to_natural_host(dist_fft(xc, mesh))
    ref = np.fft.fft(x)
    assert snr_db(np.stack([ref.real, ref.imag]),
                  np.stack([got.real, got.imag])) > 200


# ── time-sharded resampler (completes the sharded surface: every ops
#    pipeline has a parallel counterpart) ──


def test_sharded_upfirdn_prefix_parity(mesh):
    from pragma_dsp_tpu.ops.polyphase import resampler_taps, upfirdn
    from pragma_dsp_tpu.parallel import sharded_upfirdn

    up, down = 147, 160
    taps = resampler_taps(up, down, 8 * up + 1)
    lloc = 3200                              # lloc*147 % 160 == 0
    x = RNG.standard_normal(8 * lloc)
    got = np.asarray(sharded_upfirdn(jnp.asarray(x), taps, up, down,
                                     mesh=mesh))
    full = np.asarray(upfirdn(jnp.asarray(x), taps, up, down))
    assert got.shape[0] == len(x) * up // down
    np.testing.assert_allclose(got, full[: got.shape[0]], atol=1e-9)


def test_sharded_resample_poly_complex(mesh):
    from pragma_dsp_tpu.ops.polyphase import resample_poly
    from pragma_dsp_tpu.parallel import sharded_resample_poly

    lloc = 3200
    z = RNG.standard_normal(8 * lloc) + 1j * RNG.standard_normal(8 * lloc)
    zc = ComplexArray(jnp.asarray(z.real), jnp.asarray(z.imag))
    got = sharded_resample_poly(zc, 147, 160, mesh=mesh)
    full = resample_poly(zc, 147, 160)
    m = got.real.shape[0]
    np.testing.assert_allclose(np.asarray(got.real),
                               np.asarray(full.real)[:m], atol=1e-9)
    np.testing.assert_allclose(np.asarray(got.imag),
                               np.asarray(full.imag)[:m], atol=1e-9)


def test_sharded_upfirdn_decimate(mesh):
    from pragma_dsp_tpu.ops.polyphase import design_lowpass, upfirdn
    from pragma_dsp_tpu.parallel import sharded_upfirdn

    taps = design_lowpass(127, 0.2)
    x = RNG.standard_normal(8 * 1024)
    got = np.asarray(sharded_upfirdn(jnp.asarray(x), taps, 1, 4,
                                     mesh=mesh))
    full = np.asarray(upfirdn(jnp.asarray(x), taps, 1, 4))
    np.testing.assert_allclose(got, full[: got.shape[0]], atol=1e-10)


def test_sharded_upfirdn_stays_on_banded_path(mesh):
    """The closed-over numpy taps must keep the banded-matmul lowering (a
    traced-taps regression falls onto the dilated-conv path —
    the config-4 bug class, jaxpr-guarded like the WBFM chain)."""
    from pragma_dsp_tpu.parallel.sharded import _build_sharded_upfirdn
    from pragma_dsp_tpu.ops.polyphase import resampler_taps

    taps = np.asarray(resampler_taps(3, 4, 25), np.float64)
    fn = _build_sharded_upfirdn(mesh, "x", taps.tobytes(), 25, 3, 4, 1,
                                False)
    jx = str(jax.make_jaxpr(fn)(jnp.zeros(8 * 64)))
    assert "conv_general_dilated" not in jx


def test_sharded_upfirdn_validates_block(mesh):
    from pragma_dsp_tpu.parallel import sharded_upfirdn

    with pytest.raises(ValueError, match="block"):
        sharded_upfirdn(jnp.zeros(8 * 100), np.ones(9), 147, 160,
                        mesh=mesh)


def test_sharded_halo_coverage_guards(mesh):
    """Per-device blocks shorter than the halo history must raise, not
    silently clamp the halo slice (round-5 review finding, verified to
    return wrong values before the guard)."""
    from pragma_dsp_tpu.ops.polyphase import resampler_taps
    from pragma_dsp_tpu.parallel import (sharded_channel_power,
                                         sharded_pfb_channelize_frames,
                                         sharded_upfirdn)

    # upfirdn decimator: hist(1177 taps, up=1) = 1176 > 64-sample blocks
    taps = resampler_taps(1, 4, 1177)
    with pytest.raises(ValueError, match="history"):
        sharded_upfirdn(jnp.zeros(8 * 64), taps, 1, 4, mesh=mesh)
    # FIR: K-1 = 126 > 64-sample blocks
    with pytest.raises(ValueError, match="history"):
        sharded_fir_filter(jnp.zeros(8 * 64), jnp.ones(127), mesh)
    # spectrogram: overlap 96 > 64-sample blocks
    with pytest.raises(ValueError, match="overlap"):
        sharded_spectrogram(jnp.zeros(8 * 64), 128, 32, mesh=mesh)
    # PFB frames: T-1 = 7 > 4 frames/device
    fr = ComplexArray(jnp.zeros((8 * 4, 32)), jnp.zeros((8 * 4, 32)))
    with pytest.raises(ValueError, match="branch history"):
        sharded_pfb_channelize_frames(fr, 32, mesh=mesh)
    with pytest.raises(ValueError, match="branch history"):
        sharded_channel_power(fr, 32, mesh=mesh, n_fft=4)
    # PFB flat: (T-1)*C = 224 > 32*4 = 128 samples/device
    flat = ComplexArray(jnp.zeros(8 * 128), jnp.zeros(8 * 128))
    with pytest.raises(ValueError, match="branch history"):
        sharded_pfb_channelize(flat, 32, mesh=mesh)
