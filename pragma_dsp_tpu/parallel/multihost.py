"""Multi-host runtime bring-up + failure detection (SURVEY.md §5 row).

On a multi-host pod slice each host runs the same program;
``init_multihost`` wires them into one JAX runtime and runs a
psum barrier as a startup health check so a dead host fails fast and
loud instead of hanging the first collective mid-pipeline.

Failure detection: collectives on a pod hang (not error) when a peer
dies, so ``barrier(timeout_s=...)`` runs the probe collective under a
watchdog and raises ``BarrierTimeout`` instead of blocking forever —
the caller can checkpoint/abort cleanly (utils/checkpoint.py holds the
stream state needed for an elastic restart). ``health_check`` reports
per-host device visibility and HBM occupancy for pre-flight validation.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import jax
import numpy as np

__all__ = ["init_multihost", "barrier", "is_multihost", "BarrierTimeout",
           "health_check"]


class BarrierTimeout(RuntimeError):
    """A barrier collective did not complete within its watchdog window —
    on a pod this almost always means a peer host died or never arrived
    (collectives hang rather than error on member loss)."""


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   timeout_s: Optional[float] = 300.0) -> None:
    """jax.distributed.initialize with explicit or env-provided topology
    (pass all three on a machine with no cluster environment), then a
    watchdogged barrier health check across all hosts."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    barrier(timeout_s=timeout_s)


def is_multihost() -> bool:
    return jax.process_count() > 1


def _psum_probe() -> int:
    """The probe collective: a tiny psum across every device."""
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devs = np.asarray(jax.devices())
    mesh = Mesh(devs, ("all",))
    ones = jax.device_put(
        jnp.ones((len(devs),), jnp.int32),
        NamedSharding(mesh, P("all")))
    return int(jax.jit(lambda v: jnp.sum(v))(ones))


def barrier(timeout_s: Optional[float] = None) -> None:
    """All-host barrier with optional watchdog.

    Without ``timeout_s`` the probe psum runs inline and raises only if
    the runtime is unhealthy enough to fail the collective. With it, the
    probe runs in a worker thread; if it has not completed within the
    window, ``BarrierTimeout`` is raised (the stuck collective thread is
    daemonic — the expected follow-up is checkpoint + abort, not
    continuing to dispatch onto a half-dead mesh)."""
    if jax.process_count() == 1 and len(jax.devices()) == 1:
        return
    n_dev = len(jax.devices())
    if timeout_s is None:
        total = _psum_probe()
    else:
        result: Dict[str, object] = {}

        def run():
            try:
                result["total"] = _psum_probe()
            except Exception as e:  # surfaced on the caller thread below
                result["error"] = e

        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(timeout_s)
        if t.is_alive():
            raise BarrierTimeout(
                f"barrier did not complete within {timeout_s:.1f}s "
                f"across {jax.process_count()} process(es) / {n_dev} "
                "device(s) — a peer host is likely dead or unreachable")
        if "error" in result:
            raise result["error"]  # type: ignore[misc]
        total = result["total"]  # type: ignore[assignment]
    if total != n_dev:
        raise RuntimeError(
            f"barrier psum mismatch: {total} != {n_dev} devices")


def health_check() -> Dict[str, object]:
    """Pre-flight report for this process: topology + per-device HBM.

    Keys: process_index, process_count, local_devices, global_devices,
    platform, devices (list of {id, kind, hbm_in_use, hbm_limit}).
    Cheap and collective-free — safe to call even when peers are dead."""
    devices = []
    for d in jax.local_devices():
        try:
            stats = d.memory_stats() or {}
        except Exception:
            stats = {}
        devices.append({
            "id": d.id,
            "kind": d.device_kind,
            "hbm_in_use": int(stats.get("bytes_in_use", 0)),
            "hbm_limit": int(stats.get("bytes_limit", 0)),
        })
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
        "platform": jax.default_backend(),
        "devices": devices,
    }
