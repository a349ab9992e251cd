"""Context parallelism: all-gather and lse-combine strategies.

Two alternatives to ring attention for sequence-sharded KV (boom guide
§15 shapes; both absent from the single-device reference by design,
``project_narrative.md:50-53``):

* ``allgather_attention`` — gather the full KV onto every device, run the
  local flash kernel.  Highest bandwidth cost, simplest, and **fully
  differentiable** (``all_gather`` transposes to ``psum_scatter``, and the
  local kernel carries the custom FA-2 vjp), so this is the training-time
  context-parallel path.

* ``lse_combine_attention`` — each device attends its queries against only
  its *local* KV shard, then partials merge across the axis with a
  pmax/psum logsumexp combine — the cross-chip form of the reference's
  online-softmax merge (``kernels.metal:148-159``).  O(D) bytes per query
  on the wire instead of the whole KV cache.  Forward-only (the LSE
  residual is not differentiated); decode-oriented.

Both are meant to be called INSIDE ``shard_map``.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..config import BlockSizes
from ..kernels._common import pack_dropout_seed
from ..kernels.flash_fwd import flash_attention_fwd
from ..ops.attention import flash_attention
from ..reference.oracle import attention_reference_with_lse


def allgather_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    axis_name: str,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    block_sizes: Optional[BlockSizes] = None,
    impl: str = "auto",
    dropout_rate: float = 0.0,
    dropout_seed: Optional[jax.Array] = None,
    dropout_heads: Optional[int] = None,
) -> jax.Array:
    """Differentiable context-parallel attention via KV all-gather.

    ``q, k, v``: local ``[B, H, n_local, D]`` shards, sequence sharded on
    ``axis_name``.  Returns the local output shard.

    ``dropout_*``: in-kernel attention dropout at GLOBAL mask coordinates
    — the gathered KV columns are already global, and this shard's row
    origin is added to the (optionally pre-packed, see
    ``kernels._common.pack_dropout_seed``) seed's row offset, so the
    sharded run regenerates the exact single-device mask.
    """
    n_loc = q.shape[2]
    my = jax.lax.axis_index(axis_name)
    k_full = jax.lax.all_gather(k, axis_name, axis=2, tiled=True)
    v_full = jax.lax.all_gather(v, axis_name, axis=2, tiled=True)
    drop = {}
    if dropout_rate:
        sv = pack_dropout_seed(dropout_seed)
        drop = dict(
            dropout_rate=dropout_rate,
            dropout_seed=sv[0],
            dropout_offsets=(sv[1] + my * n_loc, sv[2], sv[3], sv[4]),
            dropout_heads=dropout_heads,
        )
    return flash_attention(
        q,
        k_full,
        v_full,
        q_offset=my * n_loc,
        causal=causal,
        sm_scale=sm_scale,
        block_sizes=block_sizes,
        impl=impl,
        **drop,
    )


def lse_combine_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    axis_name: str,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    block_sizes: Optional[BlockSizes] = None,
    impl: str = "pallas",
) -> jax.Array:
    """Partial-attention + cross-chip logsumexp combine (forward only).

    Every device holds the SAME queries (replicated) and one KV shard;
    output is the replicated combined attention.  This is the decode
    topology: the new token's Q is broadcast, the KV cache is sharded.
    """
    my = jax.lax.axis_index(axis_name)
    n_kv_loc = k.shape[2]
    n_q = q.shape[2]
    axis_size = jax.lax.psum(1, axis_name)
    # Q rows are the LAST n_q rows of the global sequence; KV shard s
    # covers global columns [s*n_kv_loc, (s+1)*n_kv_loc).
    total_kv = axis_size * n_kv_loc
    offset = (total_kv - n_q) - my * n_kv_loc

    if impl == "xla":
        o_l, lse_l = attention_reference_with_lse(
            q, k, v, causal=causal, sm_scale=sm_scale, q_offset=offset
        )
    else:
        o_l, lse_l = flash_attention_fwd(
            q,
            k,
            v,
            offset,
            causal=causal,
            sm_scale=sm_scale,
            block_sizes=block_sizes,
            save_lse=True,
        )

    return lse_psum_combine(o_l, lse_l, axis_name).astype(q.dtype)


def lse_psum_combine(
    o_l: jax.Array, lse_l: jax.Array, axis_name: str
) -> jax.Array:
    """Cross-chip online-softmax combine of per-shard attention partials.

    ``o_l``: local normalized partial ``[..., N, D]``; ``lse_l``: local
    logsumexp ``[..., N]`` (``-inf`` == this shard saw no visible keys).
    Returns the fp32 combined output, replicated over ``axis_name`` — the
    reference's online-softmax merge (``kernels.metal:148-159``) as a
    pmax/psum pair (boom guide §15 approach 2).  The sequence-sharded
    decode engine (``runtime.sp_decode``) rides this per layer.
    """
    lse_l = lse_l[..., None].astype(jnp.float32)
    m_g = jax.lax.pmax(lse_l, axis_name)
    m_safe = jnp.where(jnp.isneginf(m_g), 0.0, m_g)
    w = jnp.where(jnp.isneginf(lse_l), 0.0, jnp.exp(lse_l - m_safe))
    o_w = jax.lax.psum(o_l.astype(jnp.float32) * w, axis_name)
    w_sum = jax.lax.psum(w, axis_name)
    w_safe = jnp.where(w_sum == 0.0, 1.0, w_sum)
    return o_w / w_safe
