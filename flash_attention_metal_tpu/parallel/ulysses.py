"""Ulysses-style sequence parallelism via head redistribution.

The alternative SP mode (SURVEY.md §2 parallelism table): instead of
rotating KV shards (ring), two ``all_to_all`` collectives re-shard the
activations from sequence-sharded to head-sharded, run a *completely
local* full-sequence flash attention per head group, and re-shard back.

Trade-off vs ring: Ulysses moves Q, K, V, and O once each over the
interconnect (4 tensors, all-to-all), while ring moves K and V
``n-1`` times (2 tensors, neighbor-only); Ulysses needs
``num_heads % axis_size == 0`` but keeps every flash kernel invocation
identical to the single-chip case (simplest to reason about, and the
full causal diagonal stays device-local).

Call inside ``shard_map`` with sequence sharded on ``axis_name``.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..config import BlockSizes
from ..ops.attention import flash_attention


def ulysses_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    axis_name: str,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    block_sizes: Optional[BlockSizes] = None,
    impl: str = "auto",
) -> jax.Array:
    """Ulysses attention over ``[B, H, n_local, D]`` sequence shards.

    Differentiable: built from two ``all_to_all`` (self-transposing) and
    the custom-vjp flash op.

    Head-divisibility: the all_to_all head split requires
    ``n_q_heads % axis_size == 0``.  GQA KV heads additionally need
    ``n_kv_heads % axis_size == 0`` — when instead ``axis_size %
    n_kv_heads == 0`` (fewer KV heads than devices), each KV head is
    replicated ``axis_size // n_kv_heads`` times before the split so
    every device lands exactly one KV head group (extra interconnect volume:
    the replication factor on K/V only); other ratios raise.
    """
    h_q, h_kv = q.shape[1], k.shape[1]
    # psum of a Python literal folds to the static axis size.
    axis_size = int(jax.lax.psum(1, axis_name))

    def seq_to_heads(x):
        # [B, H, n_loc, D] -> [B, H/n_dev, N_full, D]
        return jax.lax.all_to_all(
            x, axis_name, split_axis=1, concat_axis=2, tiled=True
        )

    def heads_to_seq(x):
        return jax.lax.all_to_all(
            x, axis_name, split_axis=2, concat_axis=1, tiled=True
        )

    if h_q % axis_size:
        raise ValueError(
            f"Ulysses requires q heads ({h_q}) divisible by the sp axis "
            f"size ({axis_size}); use ring attention otherwise"
        )
    if h_kv % axis_size:
        if axis_size % h_kv == 0:
            # Replicate KV heads up to one per device; the post-split
            # local problem is then MQA (1 KV head under h_q/axis
            # Q heads), which the kernel folds natively.
            reps = axis_size // h_kv
            k = jnp.repeat(k, reps, axis=1)
            v = jnp.repeat(v, reps, axis=1)
        else:
            raise ValueError(
                f"Ulysses GQA requires kv heads ({h_kv}) divisible by "
                f"the sp axis size ({axis_size}) or vice versa; got "
                f"neither — use ring attention for this config"
            )

    q_h = seq_to_heads(q)
    k_h = seq_to_heads(k)
    v_h = seq_to_heads(v)
    o_h = flash_attention(
        q_h,
        k_h,
        v_h,
        causal=causal,
        sm_scale=sm_scale,
        block_sizes=block_sizes,
        impl=impl,
    )
    return heads_to_seq(o_h)
