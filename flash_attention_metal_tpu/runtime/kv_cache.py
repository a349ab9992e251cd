"""Dense per-slot KV cache for autoregressive decode.

The reference's only cross-invocation state is the logsumexp tensor its
forward persists for backward (``kernels.metal:861-864``); the decode
runtime generalizes that idea into real state management: a fixed-capacity
``[L, B, H_kv, max_len, D]`` cache with per-slot valid lengths.  Ragged
lengths never touch the kernels as dynamic shapes — they ride the
per-batch causal offset (``flash_fwd.py``), so one compiled program
serves every batch composition (continuous batching stays jit-friendly).
"""

from __future__ import annotations

import dataclasses
import functools
import jax
import jax.numpy as jnp

from ..kernels.quant import quantize_tokens

# The attention kernel's KV tile (``config.BlockSizes.resolve``): a cache
# length that is a multiple of it is read in place, anything else would
# be padded (copied) on every step.
KV_BLOCK = 64


def _check_kv_block(name: str, n: int) -> None:
    if n % KV_BLOCK:
        raise ValueError(
            f"{name}={n} must be a multiple of {KV_BLOCK} (the attention "
            "kernel's KV block)"
        )


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class KVCache:
    """k/v: ``[n_layers, B, H_kv, max_len, head_dim]``; lengths: ``[B]``."""

    k: jax.Array
    v: jax.Array
    lengths: jax.Array  # int32 valid token count per slot

    def tree_flatten(self):
        return (self.k, self.v, self.lengths), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def batch(self) -> int:
        return self.k.shape[1]


def init_cache(
    n_layers: int,
    batch: int,
    n_kv_heads: int,
    max_len: int,
    head_dim: int,
    dtype=jnp.bfloat16,
) -> KVCache:
    _check_kv_block("max_len", max_len)
    shape = (n_layers, batch, n_kv_heads, max_len, head_dim)
    return KVCache(
        k=jnp.zeros(shape, dtype),
        v=jnp.zeros(shape, dtype),
        lengths=jnp.zeros((batch,), jnp.int32),
    )


def append_tokens(
    cache: KVCache,
    layer: int,
    k_new: jax.Array,
    v_new: jax.Array,
) -> KVCache:
    """Insert ``[B, H_kv, T, D]`` keys/values at each slot's write head.

    Does NOT bump ``lengths`` (the caller bumps once after all layers).
    """

    def put(buf, new, start):
        return jax.lax.dynamic_update_slice(buf, new, (0, start, 0))

    k_l = jax.vmap(put)(cache.k[layer], k_new, cache.lengths)
    v_l = jax.vmap(put)(cache.v[layer], v_new, cache.lengths)
    return KVCache(
        k=cache.k.at[layer].set(k_l),
        v=cache.v.at[layer].set(v_l),
        lengths=cache.lengths,
    )


def bump_lengths(cache, n: int, mask: jax.Array):
    """Advance write heads by ``n`` for slots where ``mask`` is True
    (works for both dense and quantized caches)."""
    return dataclasses.replace(
        cache,
        lengths=cache.lengths + jnp.where(mask, n, 0).astype(jnp.int32),
    )


def reset_slot(cache, slot: int):
    """Free a slot for reuse (stale KV is masked out by lengths=0; a
    rolling cache also clears its position map so the next occupant
    cannot see the previous one's entries)."""
    updates = {"lengths": cache.lengths.at[slot].set(0)}
    if hasattr(cache, "positions"):
        updates["positions"] = cache.positions.at[slot].set(-1)
    return dataclasses.replace(cache, **updates)



# ---------------------------------------------------------------------------
# Quantized KV cache (BASELINE.json config 5: 8-bit KV + continuous batching)
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class QuantKVCache:
    """8-bit per-slot KV cache with per-token absmax scales.

    ``k_q/v_q``: ``[n_layers, B, H_kv, max_len, head_dim]`` int8/fp8;
    ``k_scale/v_scale``: ``[n_layers, B, H_kv, max_len]`` fp32, one per
    token; ``lengths``: ``[B]``.
    Tokens are quantized once at append time — HBM holds 8-bit KV, halving
    (vs bf16) the decode-dominant cache reads (``kernels/quant.py``).
    """

    k_q: jax.Array
    v_q: jax.Array
    k_scale: jax.Array
    v_scale: jax.Array
    lengths: jax.Array

    def tree_flatten(self):
        return (
            self.k_q,
            self.v_q,
            self.k_scale,
            self.v_scale,
            self.lengths,
        ), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def max_len(self) -> int:
        return self.k_q.shape[3]

    @property
    def batch(self) -> int:
        return self.k_q.shape[1]


def init_quant_cache(
    n_layers: int,
    batch: int,
    n_kv_heads: int,
    max_len: int,
    head_dim: int,
    dtype=jnp.int8,
) -> QuantKVCache:
    _check_kv_block("max_len", max_len)
    shape = (n_layers, batch, n_kv_heads, max_len, head_dim)
    sshape = shape[:-1]
    return QuantKVCache(
        k_q=jnp.zeros(shape, dtype),
        v_q=jnp.zeros(shape, dtype),
        # Scale 1.0 for unwritten slots keeps dequant of stale zeros at 0.
        k_scale=jnp.ones(sshape, jnp.float32),
        v_scale=jnp.ones(sshape, jnp.float32),
        lengths=jnp.zeros((batch,), jnp.int32),
    )


def append_tokens_quant(
    cache: QuantKVCache,
    layer: int,
    k_new: jax.Array,
    v_new: jax.Array,
) -> QuantKVCache:
    """Quantize + insert ``[B, H_kv, T, D]`` keys/values at the write head.

    Symmetric per-token absmax, matching ``kernels.quant.quantize_kv``.
    Does NOT bump ``lengths`` (the caller bumps once after all layers).
    """

    qdtype = cache.k_q.dtype
    quant = functools.partial(quantize_tokens, dtype=qdtype)

    kq_new, ks_new = quant(k_new)
    vq_new, vs_new = quant(v_new)

    def put(buf, new, start):
        return jax.lax.dynamic_update_slice(buf, new, (0, start, 0))

    def put_s(buf, new, start):
        return jax.lax.dynamic_update_slice(buf, new, (0, start))

    k_l = jax.vmap(put)(cache.k_q[layer], kq_new, cache.lengths)
    v_l = jax.vmap(put)(cache.v_q[layer], vq_new, cache.lengths)
    ks_l = jax.vmap(put_s)(cache.k_scale[layer], ks_new, cache.lengths)
    vs_l = jax.vmap(put_s)(cache.v_scale[layer], vs_new, cache.lengths)
    return dataclasses.replace(
        cache,
        k_q=cache.k_q.at[layer].set(k_l),
        v_q=cache.v_q.at[layer].set(v_l),
        k_scale=cache.k_scale.at[layer].set(ks_l),
        v_scale=cache.v_scale.at[layer].set(vs_l),
    )


# ---------------------------------------------------------------------------
# Rolling (wrapped) KV cache for sliding-window models: O(window) memory
# ---------------------------------------------------------------------------


def rolling_slots(pos, capacity: int, sinks: int = 0):
    """Slot index for global position ``pos`` in a rolling cache.

    The first ``sinks`` positions are pinned (attention sinks); the rest
    of the capacity is a wrap-around region for the sliding window.
    """
    if sinks:
        return jnp.where(
            pos < sinks, pos, sinks + (pos - sinks) % (capacity - sinks)
        )
    return pos % capacity


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class RollingKVCache:
    """Fixed-capacity wrapped cache for sliding-window attention.

    ``k/v``: ``[n_layers, B, H_kv, capacity, head_dim]``; global position
    ``p`` lives in slot ``p % capacity``.  ``positions``: ``[B, capacity]``
    int32 — the global position each slot currently holds (-1 == never
    written); the attention kernel masks in position space
    (``flash_fwd.py kv_positions``), so eviction is just being
    overwritten.  ``lengths``: ``[B]`` global token counts.
    """

    k: jax.Array
    v: jax.Array
    positions: jax.Array
    lengths: jax.Array
    sinks: int = 0  # static: pinned attention-sink positions

    def tree_flatten(self):
        return (self.k, self.v, self.positions, self.lengths), self.sinks

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, sinks=aux)

    @property
    def capacity(self) -> int:
        return self.k.shape[3]

    @property
    def batch(self) -> int:
        return self.k.shape[1]


def init_rolling_cache(
    n_layers: int,
    batch: int,
    n_kv_heads: int,
    capacity: int,
    head_dim: int,
    dtype=jnp.bfloat16,
    sinks: int = 0,
) -> RollingKVCache:
    _check_kv_block("capacity", capacity)
    shape = (n_layers, batch, n_kv_heads, capacity, head_dim)
    return RollingKVCache(
        k=jnp.zeros(shape, dtype),
        v=jnp.zeros(shape, dtype),
        positions=jnp.full((batch, capacity), -1, jnp.int32),
        lengths=jnp.zeros((batch,), jnp.int32),
        sinks=sinks,
    )


def append_tokens_rolling(
    cache: RollingKVCache,
    layer: int,
    k_new: jax.Array,
    v_new: jax.Array,
) -> RollingKVCache:
    """Insert ``[B, H_kv, T, D]`` at each slot's write head, wrapping.

    Requires T <= capacity - sinks: a larger chunk would wrap onto itself
    (duplicate scatter indices with unspecified write order).  Correctness
    of a *rolling* prefill additionally needs
    ``capacity >= window + sinks + chunk``: every chunk row's window must
    still be resident when the chunk's attention runs (longer prefills
    must be chunked — see ``runtime.decode.prefill_slot``).  Does NOT
    bump ``lengths``; the final layer's caller also refreshes
    ``positions`` via ``bump_rolling_positions``.
    """
    t_new = k_new.shape[2]
    cap = cache.capacity
    if t_new > cap - cache.sinks:
        raise ValueError(
            f"append of {t_new} tokens exceeds rolling wrap region "
            f"{cap} - {cache.sinks} sinks (chunk the prefill)"
        )

    def put(buf, new, start):
        # buf [H, C, D], new [H, T, D]: scatter rows at wrapped indices.
        idx = rolling_slots(start + jnp.arange(t_new), cap, cache.sinks)
        return buf.at[:, idx, :].set(new)

    k_l = jax.vmap(put)(cache.k[layer], k_new, cache.lengths)
    v_l = jax.vmap(put)(cache.v[layer], v_new, cache.lengths)
    return dataclasses.replace(
        cache,
        k=cache.k.at[layer].set(k_l),
        v=cache.v.at[layer].set(v_l),
    )


def bump_rolling_positions(
    cache: RollingKVCache, t_new: int, mask: jax.Array
) -> RollingKVCache:
    """Record the positions just written and advance lengths (masked)."""
    cap = cache.capacity

    sinks = getattr(cache, "sinks", 0)

    def put(posrow, start):
        idx = rolling_slots(start + jnp.arange(t_new), cap, sinks)
        return posrow.at[idx].set(start + jnp.arange(t_new))

    new_pos = jax.vmap(put)(cache.positions, cache.lengths)
    positions = jnp.where(mask[:, None], new_pos, cache.positions)
    return dataclasses.replace(
        cache,
        positions=positions,
        lengths=cache.lengths + jnp.where(mask, t_new, 0).astype(jnp.int32),
    )


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class RollingQuantKVCache:
    """8-bit rolling window cache: quantized storage + position map."""

    k_q: jax.Array
    v_q: jax.Array
    k_scale: jax.Array  # [n_layers, B, H_kv, capacity]
    v_scale: jax.Array
    positions: jax.Array  # [B, capacity]
    lengths: jax.Array
    sinks: int = 0

    def tree_flatten(self):
        return (
            self.k_q,
            self.v_q,
            self.k_scale,
            self.v_scale,
            self.positions,
            self.lengths,
        ), self.sinks

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, sinks=aux)

    @property
    def capacity(self) -> int:
        return self.k_q.shape[3]

    @property
    def batch(self) -> int:
        return self.k_q.shape[1]


def init_rolling_quant_cache(
    n_layers: int,
    batch: int,
    n_kv_heads: int,
    capacity: int,
    head_dim: int,
    dtype=jnp.int8,
    sinks: int = 0,
) -> RollingQuantKVCache:
    _check_kv_block("capacity", capacity)
    shape = (n_layers, batch, n_kv_heads, capacity, head_dim)
    return RollingQuantKVCache(
        k_q=jnp.zeros(shape, dtype),
        v_q=jnp.zeros(shape, dtype),
        k_scale=jnp.ones(shape[:-1], jnp.float32),
        v_scale=jnp.ones(shape[:-1], jnp.float32),
        positions=jnp.full((batch, capacity), -1, jnp.int32),
        lengths=jnp.zeros((batch,), jnp.int32),
        sinks=sinks,
    )


def append_tokens_rolling_quant(
    cache: RollingQuantKVCache,
    layer: int,
    k_new: jax.Array,
    v_new: jax.Array,
) -> RollingQuantKVCache:
    """Quantize + insert at the wrapped write head.

    Same ``T <= capacity - sinks`` / chunking contract as
    ``append_tokens_rolling``.
    """

    t_new = k_new.shape[2]
    cap = cache.capacity
    if t_new > cap - cache.sinks:
        raise ValueError(
            f"append of {t_new} tokens exceeds rolling wrap region "
            f"{cap} - {cache.sinks} sinks (chunk the prefill)"
        )
    qdtype = cache.k_q.dtype
    quant = functools.partial(quantize_tokens, dtype=qdtype)

    kq_new, ks_new = quant(k_new)
    vq_new, vs_new = quant(v_new)

    def put(buf, new, start):
        idx = rolling_slots(start + jnp.arange(t_new), cap, cache.sinks)
        return buf.at[:, idx].set(new)

    k_l = jax.vmap(put)(cache.k_q[layer], kq_new, cache.lengths)
    v_l = jax.vmap(put)(cache.v_q[layer], vq_new, cache.lengths)
    ks_l = jax.vmap(put)(cache.k_scale[layer], ks_new, cache.lengths)
    vs_l = jax.vmap(put)(cache.v_scale[layer], vs_new, cache.lengths)
    return dataclasses.replace(
        cache,
        k_q=cache.k_q.at[layer].set(k_l),
        v_q=cache.v_q.at[layer].set(v_l),
        k_scale=cache.k_scale.at[layer].set(ks_l),
        v_scale=cache.v_scale.at[layer].set(vs_l),
    )
