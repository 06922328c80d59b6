#!/usr/bin/env python3
"""DSP-chain golden generator: FIR, rational resampler, FM demod, PFB
channelizer references from SciPy/NumPy (BASELINE.json configs 3-5).

Extends the reference's generator family (scripts/gen_reallife_refs.py
style) to the batched build's filtering stack — committed, seeded, with the
convention documented inside the data (reference PLAN.md:144-167).

Usage: python scripts/gen_dsp_refs.py [--out-dir tests/fixtures/dsp]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from scipy import signal as sps

from signal_defs import floats, generator_meta, write_json

SEED = 2026


def fir_cases(rng):
    out = []
    for name, numtaps, cutoff, n in [("lowpass127", 127, 0.2, 4096),
                                     ("lowpass63", 63, 0.35, 2048)]:
        x = rng.standard_normal(n)
        taps = sps.firwin(numtaps, cutoff)
        y = sps.lfilter(taps, 1.0, x)
        out.append({
            "name": name, "kind": "fir_lfilter", "n": n,
            "numtaps": numtaps, "cutoff": cutoff,
            "taps": floats(taps), "input": floats(x), "output": floats(y),
            "convention": "y = scipy.signal.lfilter(taps, 1, x) "
                          "(causal, zero initial state)",
        })
    return out


def resampler_cases(rng):
    out = []
    for name, up, down, numtaps, n in [
            ("rs_48k_to_44k1_127tap", 147, 160, 127, 2000),
            ("rs_48k_to_44k1_1177tap", 147, 160, 8 * 147 + 1, 2000),
            ("decim4_127tap", 1, 4, 127, 4000)]:
        x = rng.standard_normal(n)
        cutoff = min(1.0 / max(up, 1), 1.0 / max(down, 1))
        taps = sps.firwin(numtaps, cutoff) * up
        y = sps.upfirdn(taps, x, up, down)
        out.append({
            "name": name, "kind": "upfirdn", "n": n, "up": up, "down": down,
            "numtaps": numtaps, "taps": floats(taps),
            "input": floats(x), "output": floats(y),
            "convention": "y = scipy.signal.upfirdn(taps, x, up, down)",
        })
    return out


def fm_cases(rng):
    out = []
    fs = 192000.0
    dev = 30000.0
    n = 8192
    t = np.arange(n) / fs
    msg = 0.8 * np.sin(2 * np.pi * 1000.0 * t) \
        + 0.3 * np.sin(2 * np.pi * 2500.0 * t)
    phase = 2 * np.pi * dev * np.cumsum(msg) / fs
    iq = np.exp(1j * phase)
    disc = np.angle(iq[1:] * np.conj(iq[:-1])) * fs / (2 * np.pi * dev)
    out.append({
        "name": "fm_two_tone", "kind": "fm_discriminator", "n": n,
        "sampleRate": fs, "deviation": dev,
        "message": floats(msg), "iqRe": floats(iq.real),
        "iqIm": floats(iq.imag), "discriminator": floats(disc),
        "convention": "disc[k] = angle(iq[k+1]*conj(iq[k])) * fs/(2*pi*dev)",
    })
    return out


def pfb_cases(rng):
    out = []
    for c, tpb, m in [(16, 8, 64), (64, 8, 32)]:
        n = c * m
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        h = sps.firwin(c * tpb, 1.0 / c)
        h = h / h.sum()
        t_taps = tpb
        hp = np.zeros((t_taps, c))
        hp.ravel()[: len(h)] = h
        xb = np.concatenate([np.zeros((t_taps - 1) * c, dtype=complex), x])
        xb = xb.reshape(t_taps - 1 + m, c)
        v = np.zeros((m, c), dtype=complex)
        for mi in range(m):
            for tt in range(t_taps):
                v[mi] += hp[tt] * xb[t_taps - 1 + mi - tt]
        y = np.fft.fft(v, axis=-1)
        out.append({
            "name": f"pfb_{c}ch", "kind": "pfb_channelizer", "channels": c,
            "tapsPerBranch": tpb, "frames": m, "taps": floats(h),
            "inputRe": floats(x.real), "inputIm": floats(x.imag),
            "outputRe": [floats(row) for row in y.real],
            "outputIm": [floats(row) for row in y.imag],
            "convention": "y[m,ch] = sum_p e^{-2j pi p ch/C} "
                          "sum_t h[tC+p] x[(m-t)C+p]; causal zero history",
        })
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out-dir", default="tests/fixtures/dsp")
    args = p.parse_args()
    rng = np.random.default_rng(SEED)
    meta = generator_meta("scripts/gen_dsp_refs.py")
    groups = {
        "fir": fir_cases(rng),
        "resampler": resampler_cases(rng),
        "fm_demod": fm_cases(rng),
        "channelizer": pfb_cases(rng),
    }
    for name, cases in groups.items():
        write_json(os.path.join(args.out_dir, f"{name}.json.gz"),
                   {**meta, "seed": SEED, "cases": cases})
        print(f"  {name}: {len(cases)} cases")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
