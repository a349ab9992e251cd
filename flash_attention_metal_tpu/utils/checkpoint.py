"""Checkpoint / resume (params + decode-state snapshots).

The reference's closest analog is the logsumexp tensor its forward
persists as re-entry state for the backward pass (``kernels.metal:
861-864``, SURVEY.md §5); this module generalizes that into real
durability: Orbax-backed save/restore of model params and of the decode
engine's KV-cache snapshot, so a multi-host decode loop can restart from
the last snapshot instead of re-prefilling every sequence.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import jax

try:
    import orbax.checkpoint as ocp

    _HAS_ORBAX = True
except ImportError:
    _HAS_ORBAX = False

import pickle

import numpy as np


def save_pytree(path: str, tree: Any) -> None:
    """Save any JAX pytree (params, optimizer state, KVCache snapshot)."""
    path = os.path.abspath(path)
    if _HAS_ORBAX:
        ckptr = ocp.StandardCheckpointer()
        ckptr.save(path, tree, force=True)
        ckptr.wait_until_finished()
    else:
        leaves, treedef = jax.tree_util.tree_flatten(tree)
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "fallback.pkl"), "wb") as f:
            pickle.dump(
                ([np.asarray(x) for x in leaves], treedef), f
            )


def restore_pytree(path: str, like: Optional[Any] = None) -> Any:
    """Restore a pytree saved by ``save_pytree``.

    ``like``: an abstract/concrete pytree with the target structure and
    shapes (required by Orbax for typed restore; optional for fallback).
    """
    path = os.path.abspath(path)
    if _HAS_ORBAX:
        ckptr = ocp.StandardCheckpointer()
        if like is not None:
            abstract = jax.tree_util.tree_map(
                lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype)
                if hasattr(x, "shape")
                else x,
                like,
            )
            return ckptr.restore(path, abstract)
        return ckptr.restore(path)
    with open(os.path.join(path, "fallback.pkl"), "rb") as f:
        leaves, treedef = pickle.load(f)
    return jax.tree_util.tree_unflatten(treedef, leaves)
