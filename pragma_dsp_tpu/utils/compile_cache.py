"""Persistent XLA compilation cache for the repo's entry scripts.

Called at the top of ``chip_smoke.py`` and ``bench.py``, never on library
import. Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its
cache there and nothing is set here. Otherwise the cache goes to a fixed
``<repo>/.jax_cache`` (listed in ``.gitignore``): the path is part of the
cache key, so it must not depend on a temp dir, a pid or the time.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

__all__ = ["REPO_CACHE_DIR", "compile_cache_dir", "enable_compile_cache"]

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def compile_cache_dir(environ: Mapping[str, str] = os.environ
                      ) -> Optional[str]:
    """The directory this module would set: None when the environment
    already names one, else :data:`REPO_CACHE_DIR`."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return REPO_CACHE_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    import jax

    path = compile_cache_dir()
    if path is None:
        return os.environ["JAX_COMPILATION_CACHE_DIR"]
    jax.config.update("jax_compilation_cache_dir", path)
    return path
