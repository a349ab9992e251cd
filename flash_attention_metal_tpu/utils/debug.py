"""Numerics sanitizer layer (SURVEY.md §5 race-detection/sanitizer line).

The reference found its races by output mismatch and fixed them with
atomics (``project_narrative.md:70-73``); here determinism is
structural (no atomics in any kernel), so the sanitizer layer targets the
remaining failure class: silent NaN/Inf propagation.  Two tools:

* ``checked(fn)`` — wrap a jittable function with ``checkify`` so float
  errors (NaN/Inf from div, log, etc.) raise with a location instead of
  propagating.  Works on the XLA paths; Pallas kernels are covered by
  interpret mode plus ``assert_all_finite`` on their outputs.
* ``assert_all_finite(tree, name)`` — host-side finite check over a
  pytree, for harness/test use.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax.experimental import checkify


def checked(fn: Callable, *, errors=None) -> Callable:
    """Wrap ``fn`` so float errors raise ``checkify.JaxRuntimeError``.

    Usage::

        safe = checked(lambda q, k, v: flash_attention(q, k, v, impl="xla"))
        out = safe(q, k, v)   # raises on NaN/Inf instead of propagating
    """
    if errors is None:
        errors = checkify.float_checks

    wrapped = checkify.checkify(fn, errors=errors)

    def run(*args, **kwargs):
        err, out = wrapped(*args, **kwargs)
        err.throw()
        return out

    return run


def assert_all_finite(tree: Any, name: str = "value") -> None:
    """Raise ``FloatingPointError`` if any leaf holds NaN/Inf."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if not hasattr(leaf, "dtype") or not jnp.issubdtype(
            leaf.dtype, jnp.floating
        ):
            continue
        if not bool(jnp.all(jnp.isfinite(leaf.astype(jnp.float32)))):
            key = jax.tree_util.keystr(path)
            raise FloatingPointError(
                f"non-finite values in {name}{key} "
                f"(shape {leaf.shape}, dtype {leaf.dtype})"
            )
