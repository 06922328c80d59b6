"""Mesh construction helpers for SPMD pipelines.

All multi-chip code in this package takes a `jax.sharding.Mesh` and
shards with `shard_map` + explicit collectives (ppermute halos,
all_to_all corner turns) — the comms layer is entirely XLA
collectives (SURVEY.md §5: no custom transport).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "data_mesh", "P", "Mesh", "NamedSharding"]


def make_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """Mesh over the first prod(shape) visible devices."""
    n = int(np.prod(shape))
    devices = jax.devices()[:n]
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(jax.devices())}")
    return Mesh(np.asarray(devices).reshape(tuple(shape)), tuple(axis_names))


def data_mesh(n_devices: Optional[int] = None, axis: str = "x") -> Mesh:
    """1-D mesh over all (or the first n) devices — the workhorse layout
    for batch/channel/time-block sharding."""
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    return make_mesh((n,), (axis,))
