"""Paged KV cache: pooled pages + per-slot page tables + host allocator.

Storage layout (vs the dense ``KVCache``'s ``[L, B, H, max_len, D]``):

* ``pool_k/pool_v``: ``[n_layers, n_pages, H_kv, page_size, D]`` — one
  shared physical pool; a page holds ``page_size`` consecutive tokens of
  exactly one slot (all layers use the same logical->physical mapping, so
  the table is shared across layers).
* ``page_table``: ``[B, max_pages]`` int32 — physical page per logical
  page, 0 where unallocated (never dereferenced; see
  ``kernels/paged.py``).
* ``lengths``: ``[B]`` int32 — valid token count per slot.

The allocator is deliberately host-side (``PageAllocator``): page grant/
release happens at admission/retirement boundaries in the serving loop,
far off the device's critical path, and the jitted step programs only
ever see dense int32 arrays.  This mirrors the reference's split of
"host decides, device computes" (``main.mm`` owns all buffer lifetimes,
``kernels.metal`` never allocates).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List

import jax
import jax.numpy as jnp

from ..kernels.quant import quantize_tokens


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class PagedKVCache:
    pool_k: jax.Array  # [L, P, H_kv, page_size, D]
    pool_v: jax.Array
    page_table: jax.Array  # [B, max_pages] int32
    lengths: jax.Array  # [B] int32

    def tree_flatten(self):
        return (self.pool_k, self.pool_v, self.page_table, self.lengths), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def page_size(self) -> int:
        return self.pool_k.shape[3]

    @property
    def n_pages(self) -> int:
        return self.pool_k.shape[1]

    @property
    def max_pages(self) -> int:
        return self.page_table.shape[1]

    @property
    def batch(self) -> int:
        return self.page_table.shape[0]

    @property
    def max_len(self) -> int:
        # Logical capacity per slot (physical capacity is the pool, which
        # may be intentionally smaller than B * max_len — that's the point).
        return self.max_pages * self.page_size


def init_paged_cache(
    n_layers: int,
    batch: int,
    n_kv_heads: int,
    max_len: int,
    head_dim: int,
    *,
    n_pages: int,
    page_size: int = 128,
    dtype=jnp.bfloat16,
) -> PagedKVCache:
    """``n_pages`` physical pages shared by ``batch`` slots of up to
    ``max_len`` logical tokens each (oversubscription is allowed and is
    the feature; the allocator raises when the pool truly runs dry)."""
    if page_size < 16 or page_size & (page_size - 1):
        raise ValueError(
            f"page_size={page_size} must be a power of two >= 16 (the "
            "paged kernel reads one page per KV block)"
        )
    if max_len % page_size:
        raise ValueError(f"max_len={max_len} must be a multiple of page_size")
    shape = (n_layers, n_pages, n_kv_heads, page_size, head_dim)
    return PagedKVCache(
        pool_k=jnp.zeros(shape, dtype),
        pool_v=jnp.zeros(shape, dtype),
        page_table=jnp.zeros((batch, max_len // page_size), jnp.int32),
        lengths=jnp.zeros((batch,), jnp.int32),
    )


class PageAllocator:
    """Host-side refcounted free list over the physical pool.

    Page 0 is reserved as the never-dereferenced placeholder for
    unallocated table entries, so a freshly zeroed ``page_table`` is
    always safe to index through.  Pages are refcounted so prefix
    sharing works: a physical page may be referenced by several slots'
    tables (and pinned by the engine's prefix registry) and returns to
    the free list only when the last reference drops.
    """

    def __init__(self, n_pages: int, batch: int):
        if n_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._owned: List[List[int]] = [[] for _ in range(batch)]
        self._refs: List[int] = [0] * n_pages
        # Worst-case reservation accounting: the engine reserves each
        # request's maximum page footprint at admission, so mid-flight
        # growth can never hit an empty pool (admission control by
        # memory, not by slot count).  Registry-pinned pages commit too.
        self._reserved: List[int] = [0] * batch
        self._committed = 0
        self._pinned = 0
        self._capacity = n_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_of(self, slot: int) -> int:
        return len(self._owned[slot])

    def can_reserve(self, pages: int) -> bool:
        return self._committed + self._pinned + pages <= self._capacity

    def reserve(self, slot: int, pages: int) -> None:
        if not self.can_reserve(pages):
            raise MemoryError(
                f"cannot reserve {pages} pages ({self._capacity - self._committed - self._pinned} uncommitted)"
            )
        self._committed += pages - self._reserved[slot]
        self._reserved[slot] = pages

    # -- prefix sharing ------------------------------------------------
    def adopt(self, cache: PagedKVCache, slot: int, phys: int) -> PagedKVCache:
        """Install an existing (shared) physical page as ``slot``'s next
        logical page, taking a reference."""
        owned = self._owned[slot]
        if len(owned) >= cache.max_pages:
            raise ValueError(f"slot {slot} table full")
        self._refs[phys] += 1
        logical = len(owned)
        owned.append(phys)
        return dataclasses.replace(
            cache,
            page_table=cache.page_table.at[slot, logical].set(phys),
        )

    def pin(self, phys: int) -> None:
        """Registry reference: keeps a prefix page resident after its
        last slot releases (evicted via ``unpin`` under pressure)."""
        self._refs[phys] += 1
        self._pinned += 1

    def unpin(self, phys: int) -> None:
        self._refs[phys] -= 1
        self._pinned -= 1
        if self._refs[phys] == 0:
            self._free.append(phys)

    def grow(self, cache: PagedKVCache, slot: int, n_tokens: int) -> PagedKVCache:
        """Ensure ``slot`` owns enough pages for ``n_tokens`` logical
        tokens, installing any new physical ids in the table."""
        ps = cache.page_size
        need_pages = -(-n_tokens // ps)
        owned = self._owned[slot]
        if need_pages > cache.max_pages:
            raise ValueError(
                f"slot {slot} wants {need_pages} pages > max_pages "
                f"{cache.max_pages}"
            )
        table = cache.page_table
        new_logical = []
        new_phys = []
        while len(owned) < need_pages:
            if not self._free:
                raise MemoryError(
                    f"page pool exhausted growing slot {slot} to "
                    f"{n_tokens} tokens ({need_pages} pages)"
                )
            phys = self._free.pop()
            self._refs[phys] = 1
            new_logical.append(len(owned))
            new_phys.append(phys)
            owned.append(phys)
        if new_logical:
            table = table.at[slot, jnp.asarray(new_logical)].set(
                jnp.asarray(new_phys, jnp.int32)
            )
        return dataclasses.replace(cache, page_table=table)

    def release(self, cache: PagedKVCache, slot: int) -> PagedKVCache:
        """Drop all of ``slot``'s page references and clear its table
        row + length (the paged analog of ``kv_cache.reset_slot``).
        Shared/pinned pages survive until their last reference drops."""
        for phys in reversed(self._owned[slot]):
            self._refs[phys] -= 1
            if self._refs[phys] == 0:
                self._free.append(phys)
        self._owned[slot] = []
        self._committed -= self._reserved[slot]
        self._reserved[slot] = 0
        return dataclasses.replace(
            cache,
            page_table=cache.page_table.at[slot].set(0),
            lengths=cache.lengths.at[slot].set(0),
        )


def append_tokens_paged(
    cache: PagedKVCache,
    layer: int,
    k_new: jax.Array,
    v_new: jax.Array,
) -> PagedKVCache:
    """Insert ``[B, H_kv, T, D]`` keys/values at each slot's write head.

    Positions ``lengths[b] .. lengths[b]+T-1`` scatter into the slot's
    pages through the table.  Requires those pages to be allocated
    (``PageAllocator.grow`` ran for ``lengths[b]+T`` tokens).  Does NOT
    bump ``lengths`` (the caller bumps once after all layers).
    """
    t_new = k_new.shape[2]
    ps = cache.page_size
    pos = cache.lengths[:, None] + jnp.arange(t_new)[None, :]  # [B, T]
    logical = jnp.clip(pos // ps, 0, cache.max_pages - 1)
    row = pos % ps
    phys = jnp.take_along_axis(cache.page_table, logical, axis=1)  # [B, T]

    def scatter(pool_l, new):  # pool_l [P, H, ps, D], new [B, H, T, D]
        vals = new.transpose(0, 2, 1, 3)  # [B, T, H, D]
        return pool_l.at[phys, :, row, :].set(vals)

    return dataclasses.replace(
        cache,
        pool_k=cache.pool_k.at[layer].set(scatter(cache.pool_k[layer], k_new)),
        pool_v=cache.pool_v.at[layer].set(scatter(cache.pool_v[layer], v_new)),
    )


def gather_slot_kv(cache: PagedKVCache, layer: int, slot: int) -> tuple:
    """Densify one slot's KV ``[H_kv, max_len, D]`` (debug/test helper)."""
    table = cache.page_table[slot]  # [max_pages]
    k = cache.pool_k[layer][table]  # [max_pages, H, ps, D]
    v = cache.pool_v[layer][table]
    k = k.transpose(1, 0, 2, 3).reshape(k.shape[1], -1, k.shape[3])
    v = v.transpose(1, 0, 2, 3).reshape(v.shape[1], -1, v.shape[3])
    return k, v


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class PagedQuantKVCache:
    """8-bit paged pool: int8/fp8 pages + per-token fp32 scale pages.

    Same table/lengths semantics as ``PagedKVCache``; tokens are
    quantized at append (symmetric per-token absmax, matching
    ``kv_cache.append_tokens_quant``) so HBM holds 8-bit pages and the
    paged-quant kernel dequantizes in registers."""

    pool_k_q: jax.Array  # [L, P, H_kv, page_size, D] int8/fp8
    pool_v_q: jax.Array
    pool_k_scale: jax.Array  # [L, P, H_kv, page_size] fp32
    pool_v_scale: jax.Array
    page_table: jax.Array  # [B, max_pages] int32
    lengths: jax.Array  # [B] int32

    def tree_flatten(self):
        return (
            self.pool_k_q,
            self.pool_v_q,
            self.pool_k_scale,
            self.pool_v_scale,
            self.page_table,
            self.lengths,
        ), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def page_size(self) -> int:
        return self.pool_k_q.shape[3]

    @property
    def n_pages(self) -> int:
        return self.pool_k_q.shape[1]

    @property
    def max_pages(self) -> int:
        return self.page_table.shape[1]

    @property
    def batch(self) -> int:
        return self.page_table.shape[0]

    @property
    def max_len(self) -> int:
        return self.max_pages * self.page_size


def init_paged_quant_cache(
    n_layers: int,
    batch: int,
    n_kv_heads: int,
    max_len: int,
    head_dim: int,
    *,
    n_pages: int,
    page_size: int = 128,
    dtype=jnp.int8,
) -> PagedQuantKVCache:
    if page_size < 16 or page_size & (page_size - 1):
        raise ValueError(
            f"page_size={page_size} must be a power of two >= 16 (the "
            "paged kernel reads one page per KV block)"
        )
    if max_len % page_size:
        raise ValueError(f"max_len={max_len} must be a multiple of page_size")
    shape = (n_layers, n_pages, n_kv_heads, page_size, head_dim)
    sshape = shape[:-1]
    return PagedQuantKVCache(
        pool_k_q=jnp.zeros(shape, dtype),
        pool_v_q=jnp.zeros(shape, dtype),
        pool_k_scale=jnp.zeros(sshape, jnp.float32),
        pool_v_scale=jnp.zeros(sshape, jnp.float32),
        page_table=jnp.zeros((batch, max_len // page_size), jnp.int32),
        lengths=jnp.zeros((batch,), jnp.int32),
    )


def append_tokens_paged_quant(
    cache: PagedQuantKVCache,
    layer: int,
    k_new: jax.Array,
    v_new: jax.Array,
) -> PagedQuantKVCache:
    """Quantize + scatter ``[B, H_kv, T, D]`` keys/values through the
    page table (same write-head semantics as ``append_tokens_paged``)."""

    qdtype = cache.pool_k_q.dtype
    quant = functools.partial(quantize_tokens, dtype=qdtype)

    kq_new, ks_new = quant(k_new)
    vq_new, vs_new = quant(v_new)

    t_new = k_new.shape[2]
    ps = cache.page_size
    pos = cache.lengths[:, None] + jnp.arange(t_new)[None, :]  # [B, T]
    logical = jnp.clip(pos // ps, 0, cache.max_pages - 1)
    row = pos % ps
    phys = jnp.take_along_axis(cache.page_table, logical, axis=1)  # [B, T]

    def scatter(pool_l, new):  # pool_l [P, H, ps, D], new [B, H, T, D]
        vals = new.transpose(0, 2, 1, 3)  # [B, T, H, D]
        return pool_l.at[phys, :, row, :].set(vals)

    def scatter_s(pool_l, new):  # pool_l [P, H, ps], new [B, H, T]
        vals = new.transpose(0, 2, 1)  # [B, T, H]
        return pool_l.at[phys, :, row].set(vals)

    return dataclasses.replace(
        cache,
        pool_k_q=cache.pool_k_q.at[layer].set(
            scatter(cache.pool_k_q[layer], kq_new)
        ),
        pool_v_q=cache.pool_v_q.at[layer].set(
            scatter(cache.pool_v_q[layer], vq_new)
        ),
        pool_k_scale=cache.pool_k_scale.at[layer].set(
            scatter_s(cache.pool_k_scale[layer], ks_new)
        ),
        pool_v_scale=cache.pool_v_scale.at[layer].set(
            scatter_s(cache.pool_v_scale[layer], vs_new)
        ),
    )
