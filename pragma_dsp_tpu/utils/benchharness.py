"""Roofline bench harness with checksum guardrails.

Carries over the reference's BenchContext philosophy (bench/reallife/
helpers.ts:152-338): warmup + timed iterations, min/avg/max, and a
checksum accumulated from every result so runs are deterministic and
dead-code-elimination-proof ("guardrails, not bragging", reference
PLAN.md:169-184). Adds device accounting: HBM bytes and FLOPs per call
so every measurement on the card reports a roofline fraction.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import jax
import numpy as np

__all__ = ["BenchResult", "BenchContext", "checksum", "device_specs",
           "memory_snapshot"]

# Published peaks per device, keyed by jax ``device_kind``, for roofline
# accounting. Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part,
# dense rates without sparsity, at its 700 W power limit: 3.35 TB/s HBM3,
# 67 TFLOP/s f32 (CUDA cores), 495 TFLOP/s TF32 and 989 TFLOP/s bf16
# (tensor cores). A card set below 700 W (nvidia-smi power.limit) cannot
# hold these under load; report the limit beside every share.
_DEVICE_SPECS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "f32_flops": 67.0e12,
        "tf32_flops": 495.0e12,
        "bf16_flops": 989.0e12,
    },
}


def device_specs(kind: Optional[str] = None) -> Dict[str, Any]:
    """Published peaks of ``kind`` (default: the first JAX device). A
    device missing from the table is an error, never a default."""
    kind = jax.devices()[0].device_kind if kind is None else kind
    if kind not in _DEVICE_SPECS:
        raise KeyError(
            f"no published peaks for device kind {kind!r}; known: "
            f"{sorted(_DEVICE_SPECS)}")
    return dict(_DEVICE_SPECS[kind], kind=kind)


def memory_snapshot() -> Dict[str, int]:
    """Device + host memory snapshot (reference BenchContext.memory,
    bench/reallife/helpers.ts:249-265: heap/RSS before+after each
    section — here HBM live/peak via the PJRT allocator plus host RSS).

    Returns zeros for fields a backend doesn't report (CPU has no
    memory_stats; RSS falls back to /proc/self/status)."""
    out = {"hbm_in_use_bytes": 0, "hbm_peak_bytes": 0, "host_rss_bytes": 0}
    try:
        stats = jax.local_devices()[0].memory_stats() or {}
        out["hbm_in_use_bytes"] = int(stats.get("bytes_in_use", 0))
        out["hbm_peak_bytes"] = int(stats.get("peak_bytes_in_use", 0))
    except Exception:
        pass
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    out["host_rss_bytes"] = int(line.split()[1]) * 1024
                    break
    except OSError:
        pass
    return out


def checksum(*arrays) -> float:
    """Order-stable scalar digest of result arrays (DCE guard + regression
    guardrail, cf. reference bench/run.ts:18-35)."""
    total = 0.0
    for a in arrays:
        x = np.asarray(a, dtype=np.float64).ravel()
        if x.size == 0:
            continue
        w = np.arange(1, x.size + 1, dtype=np.float64)
        total += float(np.sum(x * np.cos(w * 1e-3))) % 1e6
    return total


@dataclass
class BenchResult:
    name: str
    iters: int
    min_s: float
    avg_s: float
    max_s: float
    samples_per_call: Optional[int] = None
    hbm_bytes_per_call: Optional[int] = None
    flops_per_call: Optional[int] = None
    checksum: float = 0.0
    mem_before: Optional[Dict[str, int]] = None
    mem_after: Optional[Dict[str, int]] = None

    @property
    def hbm_growth_bytes(self) -> Optional[int]:
        """Live-HBM delta across the timed section — ~0 for a
        steady-state streaming loop with a donated carry."""
        if self.mem_before is None or self.mem_after is None:
            return None
        return (self.mem_after["hbm_in_use_bytes"]
                - self.mem_before["hbm_in_use_bytes"])

    @property
    def msamples_per_s(self) -> Optional[float]:
        if self.samples_per_call is None:
            return None
        return self.samples_per_call / self.min_s / 1e6

    def roofline(self, specs: Dict[str, float]) -> Dict[str, float]:
        out = {}
        if self.hbm_bytes_per_call:
            out["hbm_fraction"] = (self.hbm_bytes_per_call / self.min_s
                                   / specs["hbm_bytes_per_s"])
        if self.flops_per_call:
            out["f32_fraction"] = (self.flops_per_call / self.min_s
                                   / specs["f32_flops"])
        return out


class BenchContext:
    """Timed sections with jax.block_until_ready discipline."""

    def __init__(self, warmup: int = 3, iters: int = 20):
        self.warmup = warmup
        self.iters = iters
        self.results: List[BenchResult] = []

    def time(self, name: str, fn: Callable[[], Any], *,
             samples_per_call: Optional[int] = None,
             hbm_bytes_per_call: Optional[int] = None,
             flops_per_call: Optional[int] = None,
             warmup: Optional[int] = None,
             iters: Optional[int] = None) -> BenchResult:
        warmup = self.warmup if warmup is None else warmup
        iters = self.iters if iters is None else iters
        out = None
        for _ in range(warmup):
            out = fn()
        jax.block_until_ready(out)
        mem_before = memory_snapshot()
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            out = fn()
            jax.block_until_ready(out)
            times.append(time.perf_counter() - t0)
        mem_after = memory_snapshot()
        leaves = jax.tree_util.tree_leaves(out)
        res = BenchResult(
            name=name, iters=iters, min_s=min(times),
            avg_s=sum(times) / len(times), max_s=max(times),
            samples_per_call=samples_per_call,
            hbm_bytes_per_call=hbm_bytes_per_call,
            flops_per_call=flops_per_call,
            checksum=checksum(*leaves[:2]),
            mem_before=mem_before, mem_after=mem_after,
        )
        self.results.append(res)
        return res

    def report(self) -> str:
        """One line per section. Roofline shares only on a device with
        published peaks; elsewhere (the CPU) times and checksums only."""
        kind = jax.devices()[0].device_kind
        specs = device_specs(kind) if kind in _DEVICE_SPECS else None
        lines = [f"device: {kind}"]
        for r in self.results:
            ms = r.min_s * 1e3
            line = f"{r.name:40s} min {ms:9.3f} ms  avg {r.avg_s*1e3:9.3f} ms"
            if r.msamples_per_s is not None:
                line += f"  {r.msamples_per_s:10.1f} MS/s"
            roof = r.roofline(specs) if specs else {}
            if "hbm_fraction" in roof:
                line += f"  hbm {100*roof['hbm_fraction']:5.1f}%"
            if "f32_fraction" in roof:
                line += f"  f32 {100*roof['f32_fraction']:5.1f}%"
            growth = r.hbm_growth_bytes
            if growth is not None and (r.mem_after or {}).get("hbm_in_use_bytes"):
                line += f"  hbmΔ {growth/1e6:+.1f}MB"
            line += f"  sum {r.checksum:.6g}"
            lines.append(line)
        mem = memory_snapshot()
        if mem["hbm_in_use_bytes"] or mem["host_rss_bytes"]:
            lines.append(
                f"memory: hbm live {mem['hbm_in_use_bytes']/1e6:.1f} MB, "
                f"hbm peak {mem['hbm_peak_bytes']/1e6:.1f} MB, "
                f"host rss {mem['host_rss_bytes']/1e6:.1f} MB")
        return "\n".join(lines)
