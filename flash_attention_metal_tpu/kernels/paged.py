"""Paged flash-attention: decode/prefill over a pooled, page-table KV cache.

vLLM-style paged KV for fragmentation-free long-tail serving.  Physical
KV storage is a shared pool of fixed-size pages ``[P, H_kv, page_size, D]``
and each batch slot owns an int32 row of a page table mapping *logical*
page index -> physical page id.  The forward kernel
(``flash_fwd._fwd_kernel``) walks logical pages one per loop step and
loads each step's physical page id from the table itself (the GPU has no
scalar prefetch).  All masking runs in logical position space, so
results are independent of physical placement, and the causal loop bound
stops at the diagonal page: pages past a slot's length are never read.

This generalizes the reference's cross-invocation state design seed (the
persisted logsumexp, ``kernels.metal:861-864``) the same way the dense
cache does (``runtime/kv_cache.py``) while removing its one scaling flaw:
a slot no longer reserves ``max_len`` contiguous tokens up front.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax

from .flash_fwd import attention_fwd


@functools.partial(
    jax.jit,
    static_argnames=("sm_scale", "window", "sinks", "softcap", "pos_div"),
)
def flash_attention_paged(
    q: jax.Array,
    pool_k: jax.Array,
    pool_v: jax.Array,
    page_table: jax.Array,
    lengths: jax.Array,
    *,
    sm_scale: Optional[float] = None,
    window: Optional[int] = None,
    sinks: int = 0,
    softcap: Optional[float] = None,
    alibi_slopes: Optional[jax.Array] = None,
    pos_div: int = 1,
) -> jax.Array:
    """Causal flash attention reading KV through a page table.

    * ``q``: ``[B, H, T_new, D]`` — the step's query rows (T_new = 1 for
      decode, up to a prefill chunk otherwise).
    * ``pool_k`` / ``pool_v``: ``[P, H_kv, page_size, D]`` shared page
      pool (one layer's view); ``page_size`` is a power of two >= 16.
    * ``page_table``: ``[B, max_pages]`` int32 — physical page id per
      logical page.  Every logical page that can hold a visible position
      (i.e. up to ``ceil((lengths[b] + T_new) / page_size)``) MUST be
      allocated; entries past that are never dereferenced.
    * ``lengths``: ``[B]`` int32 — tokens already in the cache *before*
      this step's rows (the causal q_offset, exactly as the dense decode
      path uses it).

    ``window`` / ``sinks`` / ``softcap`` / ``alibi_slopes`` / ``pos_div``
    compose as in ``flash_attention_fwd`` (ALiBi distance is logical
    position distance).  Forward-only (serving).
    """
    return attention_fwd(
        q, pool_k, pool_v, lengths, page_table=page_table, causal=True,
        sm_scale=sm_scale, window=window, sinks=sinks, softcap=softcap,
        alibi_slopes=alibi_slopes, pos_div=pos_div,
    )


@functools.partial(
    jax.jit,
    static_argnames=("sm_scale", "window", "sinks", "softcap", "pos_div"),
)
def flash_attention_paged_quant(
    q: jax.Array,
    pool_k_q: jax.Array,
    pool_v_q: jax.Array,
    pool_k_scale: jax.Array,
    pool_v_scale: jax.Array,
    page_table: jax.Array,
    lengths: jax.Array,
    *,
    sm_scale: Optional[float] = None,
    window: Optional[int] = None,
    sinks: int = 0,
    softcap: Optional[float] = None,
    alibi_slopes: Optional[jax.Array] = None,
    pos_div: int = 1,
) -> jax.Array:
    """Causal flash attention over an 8-bit paged KV pool.

    The paged analog of ``kernels/quant.py::flash_attention_quant``: the
    kernel reads 8-bit pages plus per-token scales and converts them in
    registers.

    * ``pool_k_q`` / ``pool_v_q``: ``[P, H_kv, page_size, D]`` int8/fp8.
    * ``pool_k_scale`` / ``pool_v_scale``: ``[P, H_kv, page_size]``
      fp32 per-token scales.
    * ``page_table`` / ``lengths``: as ``flash_attention_paged``.
    """
    return attention_fwd(
        q, pool_k_q, pool_v_q, lengths, page_table=page_table,
        k_scale=pool_k_scale, v_scale=pool_v_scale, causal=True,
        sm_scale=sm_scale, window=window, sinks=sinks, softcap=softcap,
        alibi_slopes=alibi_slopes, pos_div=pos_div,
    )
