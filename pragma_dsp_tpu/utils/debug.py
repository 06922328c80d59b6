"""Debug / sanitizer utilities (SURVEY.md §5 "race detection / sanitizers").

There are no data races in this model — everything is functional — so the
"sanitizer build" means: check for NaN/Inf at every primitive and at
stage boundaries, and make failures loud. The reference's
analogue is TypeScript strict + noUncheckedIndexedAccess (tsconfig).
"""

from __future__ import annotations

import contextlib
from typing import Any

import jax
import jax.numpy as jnp

__all__ = ["sanitizer_mode", "check_finite", "checked", "debug_nans"]


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Toggle jax_debug_nans for a block."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", enable)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def sanitizer_mode():
    """Run the enclosed block with jax NaN-checking enabled: any
    primitive that produces a NaN raises FloatingPointError at once —
    slow, loud. The 'sanitizer build' of SURVEY.md §5."""
    return debug_nans(True)


def check_finite(name: str, *arrays) -> None:
    """Finiteness assertion at a pipeline stage boundary.

    Uses ``jax.experimental.checkify.check`` so the failure actually
    propagates to the caller: wrap the enclosing function with
    :func:`checked` (or ``checkify.checkify`` directly) and the error is
    raised on the host, under jit included. Called eagerly (outside any
    trace) it raises immediately."""
    from jax.experimental import checkify

    for i, a in enumerate(arrays):
        checkify.check(jnp.all(jnp.isfinite(a)),
                       f"check_finite failed at '{name}' (array {i})")


def checked(fn):
    """Functionalise :func:`check_finite` assertions inside ``fn`` and
    re-raise them on the host: ``checked(jitted_fn)(*args)`` raises
    ``checkify.JaxRuntimeError`` when any check fails."""
    import functools

    from jax.experimental import checkify

    cfn = checkify.checkify(fn, errors=checkify.user_checks)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        err, out = cfn(*args, **kwargs)
        checkify.check_error(err)
        return out

    return wrapper
