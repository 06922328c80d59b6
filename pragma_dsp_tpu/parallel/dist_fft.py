"""Distributed four-step FFT over a device mesh (the 1M-point path).

The Bailey four-step decomposition X[k2 + N2*k1] =
DFT_N1(W_N^(n1*k2) * DFT_N2(x[n1 + N1*n2])) applied across devices:
view x as (N2, N1) with the n1 axis sharded; the column sub-DFT is
device-local, the digit-swap corner turn becomes a tiled `all_to_all`
over the mesh axis, and the row sub-DFT is local again. The long-context/sequence-parallel analogue
of SURVEY.md §5: the sequence (time) dimension is sharded and the only
communication is the corner turn.

The forward emits digit-permuted bins (P[k2, k1] = X[k2 + N2*k1], k2
sharded) and the inverse consumes them —
a distributed fft -> pointwise -> ifft pipeline communicates exactly
twice, and spectral postprocessing (scaling, peak-find) is layout-free.

**Comm/compute overlap** (SURVEY §7 hard-parts #1: at 1M points the
corner turn dominates): the all_to_all is split into ``chunks`` pieces
interleaved with the second local FFT — chunk c+1's collective has no
data dependence on chunk c's sub-FFT, so XLA's latency-hiding scheduler
can run the transfer behind the compute (async collective start/done
pairs on the GPU; on the virtual CPU test mesh the chunked path is
exercised for correctness). Chunking slices the OUTPUT rows (forward) /
output lanes (inverse) of the corner turn, so the pieces concatenate
back in natural order with no extra permutation.

Batch dims: input may carry leading batch axes ([..., N2, N1]); the
transform and the corner turn run over the trailing two axes.

Local sub-FFTs go through ops.dispatch (cuFFT on the GPU).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..core.complex import ComplexArray, as_complex_array, is_power_of_two
from ..ops.dispatch import fft as _fft, ifft as _ifft

__all__ = ["dist_fft", "dist_ifft", "dist_fft_shape",
           "permuted_to_natural_host"]


def dist_fft_shape(n: int, n_devices: int) -> Tuple[int, int]:
    """Pick (N2, N1) for a length-n distributed FFT on D devices:
    both factors divisible by D so each step shards evenly."""
    if not is_power_of_two(n):
        raise ValueError(f"FFT size must be power of two, got {n}")
    n1 = 1 << (n.bit_length() - 1) // 2
    n2 = n // n1
    while n1 % n_devices != 0 or n2 % n_devices != 0:
        n1 *= 2
        n2 //= 2
        if n2 < n_devices:
            raise ValueError(
                f"n={n} too small to shard over {n_devices} devices")
    return n2, n1


def _twiddle_factors(n: int, n2: int, n1: int, sign: float, lo: int,
                     dtype) -> Tuple[np.ndarray, ...]:
    """W_N^(k2*n1) = A[k2, h] * B[k2, l] for n1 = h*lo + l: the (k2, n1)
    twiddle table as two small factors, (n2, n1/lo) and (n2, lo), each
    (cos, sin) from float64 and cast once. The full table as a constant
    was embedded in every compiled program (512 MiB at N = 2^26, about a
    minute to compile each variant on an H100); the factors are a few
    MiB, and the product costs one complex multiply per element, which
    XLA fuses into the twiddle stage (~2 f32 ulp). NUMPY arrays:
    _build_dist_fft is lru-cached and its first call may happen inside a
    user's jit, where a jnp constant would be a trace-local tracer that
    leaks into every later call (UnexpectedTracerError)."""
    k2 = np.arange(n2, dtype=np.float64)[:, None]
    a = sign * 2.0 * np.pi * k2 * (np.arange(n1 // lo) * lo)[None, :] / n
    b = sign * 2.0 * np.pi * k2 * np.arange(lo)[None, :] / n
    npdt = np.dtype(str(dtype))
    return tuple(np.asarray(t, npdt) for t in
                 (np.cos(a), np.sin(a), np.cos(b), np.sin(b)))


def _twiddle_table(ac, as_, bc, bs):
    """Expand the factors of :func:`_twiddle_factors` (rows already
    sliced to this device) into the (rows, n1) cos and sin tables."""
    rows = ac.shape[0]
    tc = ac[:, :, None] * bc[:, None, :] - as_[:, :, None] * bs[:, None, :]
    ts = ac[:, :, None] * bs[:, None, :] + as_[:, :, None] * bc[:, None, :]
    return tc.reshape(rows, -1), ts.reshape(rows, -1)


@functools.lru_cache(maxsize=128)
def _build_dist_fft(mesh: Mesh, axis: str, n2: int, n1: int, nd: int,
                    dtype_name: str, inverse: bool, chunks: int,
                    batch_axis: Optional[str] = None):
    """Build + jit the shard_map'd transform once per static signature,
    so repeated dist_fft calls hit the compilation cache instead of
    retracing (shard_map closures are not cached by identity).

    ``batch_axis`` shards the OUTERMOST batch dim over a second mesh
    axis (the dp-over-host + sp-over-chip pod layout): the body is
    unchanged because its collectives only span ``axis``, so each
    batch shard runs an independent transform group."""
    import jax.numpy as _jnp

    n = n2 * n1
    d = mesh.shape[axis]
    sign = 1.0 if inverse else -1.0
    dtype = _jnp.dtype(dtype_name)
    # n1 = h*lo + l with lo | n1/d, so a device's n1 columns are whole
    # h-blocks of the A factor (forward) and its k2 rows slice both.
    lo = min(1 << (n1.bit_length() - 1) // 2, n1 // d)
    ac, as_, bc, bs = _twiddle_factors(n, n2, n1, sign, lo, dtype)
    lead = [None] * (nd - 2)
    if batch_axis is not None:
        lead[0] = batch_axis

    def a2a(t, split, concat):
        return jax.lax.all_to_all(t, axis, split_axis=split,
                                  concat_axis=concat, tiled=True)

    if inverse:
        in_spec = (P(*lead, axis, None), P(*lead, axis, None))
        out_spec = (P(*lead, None, axis), P(*lead, None, axis))

        def body_fixed(pr, pi):
            b = pr.shape[:-2]
            nb = len(b)
            # 1. local DFT+ over k1 with 1/N1 (full rows of the k2-shard).
            o = _ifft(ComplexArray(pr, pi), axis=-1)
            rr, ii = o.real, o.imag
            # 2. twiddle W^(+n1*k2) for this device's k2 rows.
            k2_off = jax.lax.axis_index(axis) * (n2 // d)
            tc, ts = _twiddle_table(*(
                jax.lax.dynamic_slice_in_dim(t, k2_off, n2 // d, 0)
                for t in (ac, as_, bc, bs)))
            tr = rr * tc - ii * ts
            ti = rr * ts + ii * tc
            # 3+4. chunked corner turn (n2/D, n1) -> (n2, n1/D) over
            # output-lane chunks, interleaved with the local DFT+ over
            # n2 — the two inverse normalisations compose to exactly 1/N.
            loc = n1 // d
            w = loc // chunks
            trv = tr.reshape(b + (n2 // d, d, loc))
            tiv = ti.reshape(b + (n2 // d, d, loc))
            outs_r, outs_i = [], []
            for c in range(chunks):
                sr = trv[..., c * w:(c + 1) * w].reshape(b + (n2 // d, d * w))
                si = tiv[..., c * w:(c + 1) * w].reshape(b + (n2 // d, d * w))
                ar = a2a(sr, nb + 1, nb)       # -> (..., n2, w)
                ai = a2a(si, nb + 1, nb)
                oc = _ifft(ComplexArray(ar, ai), axis=-2)
                outs_r.append(oc.real)
                outs_i.append(oc.imag)
            if chunks == 1:
                return outs_r[0], outs_i[0]
            return (jnp.concatenate(outs_r, axis=-1),
                    jnp.concatenate(outs_i, axis=-1))
    else:
        in_spec = (P(*lead, None, axis), P(*lead, None, axis))
        out_spec = (P(*lead, axis, None), P(*lead, axis, None))

        def body_fixed(xr, xi):
            b = xr.shape[:-2]
            nb = len(b)
            # 1. local DFT over n2 (full columns of the n1-shard).
            o = _fft(ComplexArray(xr, xi), axis=-2)
            rr, ii = o.real, o.imag            # (..., k2, n1_local)
            # 2. twiddle W^(n1*k2), n1 columns of this device.
            h_off = jax.lax.axis_index(axis) * (n1 // d // lo)
            tc, ts = _twiddle_table(
                jax.lax.dynamic_slice_in_dim(ac, h_off, n1 // d // lo, 1),
                jax.lax.dynamic_slice_in_dim(as_, h_off, n1 // d // lo, 1),
                bc, bs)
            tr = rr * tc - ii * ts
            ti = rr * ts + ii * tc
            # 3+4. chunked corner turn (n2, n1/D) -> (n2/D, n1) over
            # output-row chunks, interleaved with the local row DFTs:
            # chunk c+1's all_to_all is independent of chunk c's FFT, so
            # the scheduler can overlap transfer with compute.
            rows = n2 // d
            w = rows // chunks
            loc = n1 // d
            trv = tr.reshape(b + (d, rows, loc))
            tiv = ti.reshape(b + (d, rows, loc))
            outs_r, outs_i = [], []
            for c in range(chunks):
                sr = trv[..., c * w:(c + 1) * w, :].reshape(
                    b + (d * w, loc))
                si = tiv[..., c * w:(c + 1) * w, :].reshape(
                    b + (d * w, loc))
                ar = a2a(sr, nb, nb + 1)       # -> (..., w, n1)
                ai = a2a(si, nb, nb + 1)
                oc = _fft(ComplexArray(ar, ai), axis=-1)
                outs_r.append(oc.real)
                outs_i.append(oc.imag)
            if chunks == 1:
                return outs_r[0], outs_i[0]
            return (jnp.concatenate(outs_r, axis=-2),
                    jnp.concatenate(outs_i, axis=-2))

    return jax.jit(shard_map(body_fixed, mesh=mesh, in_specs=in_spec,
                             out_specs=out_spec, check_vma=False))


def dist_fft(x, mesh: Mesh, axis: str = "x", inverse: bool = False,
             chunks: int = 1,
             batch_axis: Optional[str] = None) -> ComplexArray:
    """Distributed FFT of a [..., N2, N1] view of length N2*N1 signals.

    forward: input (..., N2, N1) natural (x[n1 + N1*n2] at [n2, n1]),
    n1-axis sharded; output (..., N2, N1) permuted (X[k2 + N2*k1] at
    [k2, k1]), k2-axis sharded.
    inverse: exactly the reverse (consumes permuted, emits natural),
    with 1/N scaling. Leading axes are batch.

    ``chunks`` controls comm/compute overlap: the corner-turn
    all_to_all is issued in that many pieces interleaved with the
    second local FFT. The default 1 is the monolithic turn: on four
    H100s at N = 2^26 it tied with 2 and beat 4 and 8 (PERF.md).

    ``batch_axis`` names a second mesh axis over which the OUTERMOST
    batch dim is sharded (dp over hosts while each transform shards
    over ``axis`` — the 2-D multi-host layout); requires a batch dim.
    """
    xc = as_complex_array(x)
    n2, n1 = xc.real.shape[-2], xc.real.shape[-1]
    d = mesh.shape[axis]
    if n1 % d != 0 or n2 % d != 0:
        raise ValueError(f"(N2={n2}, N1={n1}) must both divide by D={d}")
    if batch_axis is not None:
        if batch_axis not in mesh.axis_names:
            raise ValueError(
                f"batch_axis {batch_axis!r} is not a mesh axis "
                f"(available: {tuple(mesh.axis_names)})")
        if xc.real.ndim < 3:
            raise ValueError("batch_axis needs a leading batch dim")
        db = mesh.shape[batch_axis]
        if xc.real.shape[0] % db != 0:
            raise ValueError(
                f"leading batch {xc.real.shape[0]} must divide by "
                f"mesh axis {batch_axis!r} size {db}")
    extent = (n1 // d) if inverse else (n2 // d)
    if extent % chunks != 0:
        raise ValueError(
            f"chunks={chunks} must divide the local corner-turn extent "
            f"{extent}")
    fn = _build_dist_fft(mesh, axis, n2, n1, xc.real.ndim,
                         str(xc.real.dtype), inverse, chunks, batch_axis)
    ore, oim = fn(xc.real, xc.imag)
    return ComplexArray(ore, oim)


def dist_ifft(p, mesh: Mesh, axis: str = "x",
              chunks: int = 1,
              batch_axis: Optional[str] = None) -> ComplexArray:
    """Inverse of :func:`dist_fft`: permuted k2-sharded in, natural
    n1-sharded out, 1/N normalised."""
    return dist_fft(p, mesh, axis, inverse=True, chunks=chunks,
                    batch_axis=batch_axis)


def permuted_to_natural_host(p: ComplexArray) -> np.ndarray:
    """Gather a permuted (..., N2, N1) spectrum to the host in natural
    order (test/debug utility — production pipelines stay permuted)."""
    pr = np.asarray(p.real)
    pi = np.asarray(p.imag)
    n2, n1 = pr.shape[-2:]
    z = pr + 1j * pi
    return np.swapaxes(z, -1, -2).reshape(z.shape[:-2] + (n2 * n1,))
