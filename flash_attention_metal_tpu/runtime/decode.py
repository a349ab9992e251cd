"""Prefill + single-step decode against the KV cache.

Decode attention is the SAME flash kernel as training: a decode step with
per-slot valid lengths is causal flash attention with the per-batch
offset ``q_offset[b] = length[b] - T_new`` (``flash_fwd.py``), so stale
cache entries beyond each slot's write head are masked exactly like
future tokens.  No dynamic shapes, no second kernel to validate.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..models.transformer import (
    ModelConfig,
    Params,
    _maybe_rope,
    _merge_heads,
    _split_heads,
    alibi_slopes,
    mlp_block,
    rms_norm,
    weight,
)
from ..kernels.quant import QuantizedKV, flash_attention_quant
from ..kernels.paged import flash_attention_paged, flash_attention_paged_quant
from ..ops.attention import (
    flash_attention,
    fold_gqa_rows,
    gqa_decode_attention,
    note_end,
    unfold_gqa_rows,
)
from .paged_kv import (
    PagedKVCache,
    PagedQuantKVCache,
    append_tokens_paged,
    append_tokens_paged_quant,
)
from .kv_cache import (
    KVCache,
    QuantKVCache,
    RollingKVCache,
    RollingQuantKVCache,
    append_tokens,
    append_tokens_quant,
    append_tokens_rolling,
    append_tokens_rolling_quant,
    bump_lengths,
    bump_rolling_positions,
    rolling_slots,
)


def _effective_positions(cache, t_new: int) -> jax.Array:
    """Position map including the tokens being appended this step.

    The cache's own map advances once per step (after all layers); the
    attention calls inside the step need the in-flight tokens visible.
    """
    idx = rolling_slots(
        cache.lengths[:, None] + jnp.arange(t_new)[None, :],
        cache.capacity,
        cache.sinks,
    )
    return jax.vmap(lambda row, i, st: row.at[i].set(
        st + jnp.arange(t_new)
    ))(cache.positions, idx, cache.lengths)


def _layer_qkv(cache, layer_idx: int) -> QuantizedKV:
    """One layer's view of an 8-bit dense or rolling cache."""
    return QuantizedKV(
        k_q=cache.k_q[layer_idx],
        v_q=cache.v_q[layer_idx],
        k_scale=cache.k_scale[layer_idx],
        v_scale=cache.v_scale[layer_idx],
    )


def _attn_with_cache(
    layer: Params,
    x: jax.Array,
    cfg: ModelConfig,
    cache: KVCache,
    layer_idx: int,
    positions: jax.Array,
) -> Tuple[jax.Array, KVCache]:
    """One attention block reading/writing the cache (T new tokens)."""
    dt = cfg.dtype
    t_new = x.shape[1]
    h = rms_norm(x, layer["attn_norm"])
    q = _split_heads(h @ weight(layer["wq"], dt), cfg.n_heads, cfg.head_dim)
    k = _split_heads(h @ weight(layer["wk"], dt), cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(h @ weight(layer["wv"], dt), cfg.n_kv_heads, cfg.head_dim)
    q = _maybe_rope(q, positions, cfg)
    k = _maybe_rope(k, positions, cfg)

    # Score transforms: softcap/ALiBi ride every cache type — the dense,
    # rolling, quantized, and paged kernels all take the same transform
    # args, and all mask (and measure ALiBi distance) in position space,
    # so wrapped slots and physical page placement never enter the scores.
    _slopes = alibi_slopes(cfg.n_heads) if cfg.attn_alibi else None
    _transforms = dict(softcap=cfg.attn_softcap, alibi_slopes=_slopes)

    # GQA decode head-fold (ops.gqa_decode_attention): fold the group
    # q-heads sharing a KV head into query rows so the cache is read once
    # per KV head, not once per q-head.  Applies to the dense, quant, and
    # paged branches (position-indexed rolling caches and ALiBi need the
    # unfolded path); long prefill chunks keep one program per q-head.
    group = cfg.n_heads // max(cfg.n_kv_heads, 1)
    fold = group > 1 and t_new * group <= 128 and _slopes is None
    # The 8-bit and paged branches call their kernels directly (no
    # ``impl`` choice); record that for ``ops.attention.traced_ends``.
    step = "decode" if t_new == 1 else "prefill"

    # Valid cache length for masking is the OLD length + t_new; query row r
    # (0-based within the new tokens) sits at global position length + r,
    # so the causal offset is exactly the old length.
    if isinstance(cache, RollingKVCache):
        # Rolling (wrapped) window cache: O(window) memory; masking runs
        # in position space via the slots' position map.  The positions
        # of the tokens being appended THIS step are made visible to the
        # attention call; the cache's own map advances once per step.
        if cfg.attn_window is None:
            raise ValueError("RollingKVCache requires cfg.attn_window")
        cache = append_tokens_rolling(cache, layer_idx, k, v)
        pos_eff = _effective_positions(cache, t_new)
        o = flash_attention(
            q,
            cache.k[layer_idx],
            cache.v[layer_idx],
            q_offset=cache.lengths,
            kv_positions=pos_eff,
            causal=True,
            window=cfg.attn_window,
            sinks=cfg.attn_sinks,
            block_sizes=cfg.block_sizes,
            **_transforms,
        )
    elif isinstance(cache, RollingQuantKVCache):
        # 8-bit rolling window cache: quantize at append, mask in
        # position space.
        if cfg.attn_window is None:
            raise ValueError("RollingQuantKVCache requires cfg.attn_window")
        note_end(f"{step}, rolling 8-bit cache", "pallas")
        cache = append_tokens_rolling_quant(cache, layer_idx, k, v)
        pos_eff = _effective_positions(cache, t_new)
        o = flash_attention_quant(
            q,
            _layer_qkv(cache, layer_idx),
            cache.lengths,
            pos_eff,
            causal=True,
            window=cfg.attn_window,
            sinks=cfg.attn_sinks,
            **_transforms,
        )
    elif isinstance(cache, PagedKVCache):
        # Paged pool: append scatters through the page table; attention
        # reads KV through the same table inside the kernel's index maps
        # (kernels/paged.py).  All pages covering lengths + t_new tokens
        # must already be granted (the engine's PageAllocator runs ahead
        # of every step).
        note_end(f"{step}, paged cache", "pallas")
        cache = append_tokens_paged(cache, layer_idx, k, v)
        qq = fold_gqa_rows(q, cfg.n_kv_heads) if fold else q
        o = flash_attention_paged(
            qq,
            cache.pool_k[layer_idx],
            cache.pool_v[layer_idx],
            cache.page_table,
            cache.lengths,
            window=cfg.attn_window,
            sinks=cfg.attn_sinks,
            softcap=cfg.attn_softcap,
            alibi_slopes=None if fold else _slopes,
            pos_div=group if fold else 1,
        )
        if fold:
            o = unfold_gqa_rows(o, cfg.n_heads, t_new)
    elif isinstance(cache, PagedQuantKVCache):
        # 8-bit paged pool: quantize at append, page-table indirection +
        # dequant in registers inside the kernel (kernels/paged.py).
        note_end(f"{step}, paged 8-bit cache", "pallas")
        cache = append_tokens_paged_quant(cache, layer_idx, k, v)
        qq = fold_gqa_rows(q, cfg.n_kv_heads) if fold else q
        o = flash_attention_paged_quant(
            qq,
            cache.pool_k_q[layer_idx],
            cache.pool_v_q[layer_idx],
            cache.pool_k_scale[layer_idx],
            cache.pool_v_scale[layer_idx],
            cache.page_table,
            cache.lengths,
            window=cfg.attn_window,
            sinks=cfg.attn_sinks,
            softcap=cfg.attn_softcap,
            alibi_slopes=None if fold else _slopes,
            pos_div=group if fold else 1,
        )
        if fold:
            o = unfold_gqa_rows(o, cfg.n_heads, t_new)
    elif isinstance(cache, QuantKVCache):
        # 8-bit cache path: tokens were quantized at append; attention
        # reads 8-bit KV + per-token scales (``kernels/quant.py``).
        note_end(f"{step}, 8-bit cache", "pallas")
        cache = append_tokens_quant(cache, layer_idx, k, v)
        qkv_q = _layer_qkv(cache, layer_idx)
        if fold:
            o = flash_attention_quant(
                fold_gqa_rows(q, cfg.n_kv_heads),
                qkv_q,
                cache.lengths,
                causal=True,
                window=cfg.attn_window,
                sinks=cfg.attn_sinks,
                softcap=cfg.attn_softcap,
                pos_div=group,
            )
            o = unfold_gqa_rows(o, cfg.n_heads, t_new)
        else:
            o = flash_attention_quant(
                q,
                qkv_q,
                cache.lengths,
                causal=True,
                window=cfg.attn_window,
                sinks=cfg.attn_sinks,
                **_transforms,
            )
    else:
        cache = append_tokens(cache, layer_idx, k, v)
        if fold and cfg.attn_impl != "xla":
            # GQA decode head-fold: one program streams each KV head's
            # cache once for the whole group.
            o = gqa_decode_attention(
                q,
                cache.k[layer_idx],
                cache.v[layer_idx],
                cache.lengths,
                window=cfg.attn_window,
                sinks=cfg.attn_sinks,
                softcap=cfg.attn_softcap,
                block_sizes=cfg.block_sizes,
            )
        else:
            o = flash_attention(
                q,
                cache.k[layer_idx],
                cache.v[layer_idx],
                q_offset=cache.lengths,
                causal=True,
                window=cfg.attn_window,
                sinks=cfg.attn_sinks,
                block_sizes=cfg.block_sizes,
                impl=cfg.attn_impl,
                **_transforms,
            )
    out = _merge_heads(o) @ weight(layer["wo"], dt)
    return x + out, cache


@functools.partial(
    jax.jit, static_argnames=("cfg",), donate_argnames=("cache",)
)
def decode_step(
    params: Params,
    cfg: ModelConfig,
    cache: KVCache,
    tokens: jax.Array,
    active: jax.Array,
) -> Tuple[jax.Array, KVCache]:
    """One token per active slot: ``tokens [B]`` -> logits ``[B, V]``.

    ``active``: bool ``[B]`` — inactive slots run but their cache length
    does not advance, so their output is discarded for free.
    """
    positions = cache.lengths[:, None]  # [B, 1]
    x = params["embed"][tokens[:, None]].astype(cfg.dtype)
    for i, layer in enumerate(params["layers"]):
        x, cache = _attn_with_cache(layer, x, cfg, cache, i, positions)
        x = mlp_block(layer, x, cfg)
    x = rms_norm(x, params["final_norm"])
    logits = (x @ weight(params["lm_head"], cfg.dtype)).astype(jnp.float32)
    if isinstance(cache, (RollingKVCache, RollingQuantKVCache)):
        cache = bump_rolling_positions(cache, 1, active)
    else:
        cache = bump_lengths(cache, 1, active)
    return logits[:, 0], cache


@functools.partial(
    jax.jit, static_argnames=("cfg",), donate_argnames=("cache",)
)
def prefill_chunk(
    params: Params,
    cfg: ModelConfig,
    cache: KVCache,
    tokens: jax.Array,
    start_len: jax.Array,
    prompt_len: jax.Array,
    slot: jax.Array,
) -> Tuple[jax.Array, KVCache]:
    """Prefill one chunk ``[n_chunk]`` of a slot's prompt.

    ``start_len``: tokens already prefilled (0 for the first chunk; the
    slot's cache length must equal it).  ``prompt_len``: the FULL true
    prompt length; positions past it inside this chunk are padding.
    Returns (logits of the prompt's last true token if it falls in this
    chunk, else of the chunk's last row; updated cache).

    ``slot`` is a TRACED int32 scalar (dynamic slices below), so one
    compilation serves every slot — admission of a fresh request costs
    zero recompiles regardless of which slot it lands in.
    """
    slot = jnp.asarray(slot, jnp.int32)
    n_chunk = tokens.shape[0]
    positions = (start_len + jnp.arange(n_chunk))[None, :]
    x = params["embed"][tokens[None, :]].astype(cfg.dtype)

    # Slot view / write-back work generically over the cache classes:
    # rank-1 leaves are the per-slot lengths, rank-2 the rolling position
    # map / page table, everything else is [n_layers, B, ...] — except a
    # paged cache's pools, which are shared (no batch dim) and pass
    # through whole: prefill only touches the slot's own physical pages.
    paged = isinstance(cache, (PagedKVCache, PagedQuantKVCache))

    def view(leaf):
        if leaf.ndim == 1:  # lengths [B]: fresh slot starts at start_len
            return jnp.full((1,), start_len, jnp.int32)
        if leaf.ndim == 2:  # rolling positions / page table [B, C]
            return jax.lax.dynamic_slice_in_dim(leaf, slot, 1, axis=0)
        if paged:  # pool [L, P, H, ps, D]
            return leaf
        return jax.lax.dynamic_slice_in_dim(leaf, slot, 1, axis=1)

    slot_cache = jax.tree_util.tree_map(view, cache)
    for i, layer in enumerate(params["layers"]):
        x, slot_cache = _attn_with_cache(
            layer, x, cfg, slot_cache, i, positions
        )
        x = mlp_block(layer, x, cfg)
    x = rms_norm(x, params["final_norm"])
    logits = (x @ weight(params["lm_head"], cfg.dtype)).astype(jnp.float32)
    new_len = jnp.minimum(prompt_len, start_len + n_chunk).astype(jnp.int32)
    if isinstance(slot_cache, (RollingKVCache, RollingQuantKVCache)):
        # Record only the true prompt tokens' positions (padded rows past
        # prompt_len stay invisible: their positions stay untouched/-1).
        import dataclasses as _dc

        cap = slot_cache.capacity
        pos_written = start_len + jnp.arange(n_chunk)
        idx = rolling_slots(pos_written, cap, slot_cache.sinks)
        vals = jnp.where(pos_written < prompt_len, pos_written, -1)
        slot_cache = _dc.replace(
            slot_cache,
            positions=slot_cache.positions.at[0, idx].set(
                vals.astype(jnp.int32)
            ),
        )

    def write(buf, new):
        if buf.ndim == 1:
            return buf.at[slot].set(new_len)
        if buf.ndim == 2:
            return jax.lax.dynamic_update_slice_in_dim(buf, new, slot, 0)
        if paged:
            return new
        return jax.lax.dynamic_update_slice_in_dim(buf, new, slot, 1)

    new_cache = jax.tree_util.tree_map(write, cache, slot_cache)
    last_idx = jnp.clip(prompt_len - start_len - 1, 0, n_chunk - 1)
    last = logits[0, last_idx]
    return last, new_cache


def prefill_slot(
    params: Params,
    cfg: ModelConfig,
    cache: KVCache,
    tokens: jax.Array,
    prompt_len: jax.Array,
    slot: int,
    chunk: Optional[int] = None,
) -> Tuple[jax.Array, KVCache]:
    """Prefill one slot with a (padded) prompt ``[N_pad]``.

    ``prompt_len``: true prompt length (<= N_pad, N_pad % 128 == 0).
    ``chunk``: process the prompt in chunks of this many tokens (bounds
    per-dispatch latency and lets long prompts fit a rolling cache);
    None = one chunk.  The slot's cache must be fresh (length 0).
    Returns the next-token logits for the prompt's last true token.
    """
    n_pad = tokens.shape[0]
    if isinstance(cache, (RollingKVCache, RollingQuantKVCache)):
        # Rolling-cache correctness bound: every chunk row's window (and
        # the sink region) must still be resident when that chunk's
        # attention runs, i.e. capacity >= window + sinks + chunk.  A
        # too-large chunk would evict in-window KV *before* the chunk's
        # earlier rows attend to it — silently, so validate here.
        safe = cache.capacity - (cfg.attn_window or 0) - cache.sinks
        eff_chunk = n_pad if (chunk is None or chunk >= n_pad) else chunk
        if eff_chunk > safe:
            raise ValueError(
                f"rolling prefill chunk {eff_chunk} exceeds capacity "
                f"{cache.capacity} - window {cfg.attn_window} - sinks "
                f"{cache.sinks} = {safe}; pass a smaller chunk="
            )
    if chunk is None or chunk >= n_pad:
        return prefill_chunk(
            params, cfg, cache, tokens, jnp.int32(0), prompt_len, slot
        )
    if chunk % 128:
        raise ValueError(f"chunk={chunk} must be a multiple of 128")
    last = None
    for start in range(0, n_pad, chunk):
        piece = tokens[start : start + chunk]
        logits, cache = prefill_chunk(
            params, cfg, cache, piece, jnp.int32(start), prompt_len, slot
        )
        # Keep the chunk that contains the prompt's final true token.
        if last is None or start < int(prompt_len):
            last = logits
    return last, cache


def _filter_top_kp(
    scaled: jax.Array,  # [B, V] temperature-scaled logits
    top_k: jax.Array,  # [B] int32, <= 0 disables
    top_p: jax.Array,  # [B] float, >= 1 disables
) -> jax.Array:
    """Mask all but the top-k / nucleus-p candidates to -inf.

    Sort-once formulation: rank thresholding gives top-k; the cumulative
    probability EXCLUDING the candidate itself under ``top_p`` gives the
    smallest prefix whose mass reaches p (rank 0 always survives, so the
    distribution can never go empty).  Both filters compose per slot and
    are disabled by their sentinel values, keeping the serving loop at
    one executable for any mix of request sampling settings.
    """
    vocab = scaled.shape[-1]
    sort_idx = jnp.argsort(scaled, axis=-1)[:, ::-1]
    s = jnp.take_along_axis(scaled, sort_idx, axis=-1)
    rank = jnp.arange(vocab)[None, :]
    keep = (top_k[:, None] <= 0) | (rank < top_k[:, None])
    probs = jax.nn.softmax(jnp.where(keep, s, -jnp.inf), axis=-1)
    cum = jnp.cumsum(probs, axis=-1)
    keep &= (top_p[:, None] >= 1.0) | ((cum - probs) < top_p[:, None])
    s = jnp.where(keep, s, -jnp.inf)
    # Un-sort back to vocab order.
    inv = jnp.argsort(sort_idx, axis=-1)
    return jnp.take_along_axis(s, inv, axis=-1)


def filter_scaled_logits(
    scaled: jax.Array,  # [B, V] temperature-scaled logits
    top_ks: Optional[jax.Array] = None,  # [B] int32, <= 0 disables
    top_ps: Optional[jax.Array] = None,  # [B] float, >= 1 disables
    min_ps: Optional[jax.Array] = None,  # [B] float, <= 0 disables
) -> jax.Array:
    """Per-slot min-p + top-k/top-p filtering on temperature-scaled
    logits (shared by ``sample_batch`` and the speculative paths — the
    draft proposal, acceptance ``q``/``p``, and residual distributions
    must all see the SAME filter for the speculative-sampling rule to
    preserve the filtered target distribution).

    min-p runs ungated (row-max only); the [B, V]-sort top-k/top-p
    filter is ``lax.cond``-gated at runtime so traffic without those
    settings never pays the multi-ms vocab-wide argsort.
    """
    if min_ps is not None:
        row_max = jnp.max(scaled, axis=-1, keepdims=True)
        thresh = row_max + jnp.log(jnp.maximum(min_ps, 1e-30))[:, None]
        keep = (scaled >= thresh) | (min_ps[:, None] <= 0.0)
        scaled = jnp.where(keep, scaled, -jnp.inf)
    if top_ks is not None or top_ps is not None:
        batch = scaled.shape[0]
        if top_ks is None:
            top_ks = jnp.zeros((batch,), jnp.int32)
        if top_ps is None:
            top_ps = jnp.ones((batch,), jnp.float32)
        need = jnp.any(top_ks > 0) | jnp.any(top_ps < 1.0)
        scaled = jax.lax.cond(
            need,
            lambda s: _filter_top_kp(s, top_ks, top_ps),
            lambda s: s,
            scaled,
        )
    return scaled


def sample(
    logits: jax.Array,
    key: Optional[jax.Array] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    min_p: float = 0.0,
) -> jax.Array:
    """Greedy (t=0) / temperature / top-k / nucleus / min-p sampling over
    ``[..., V]`` logits."""
    if temperature <= 0.0 or key is None:
        return jnp.argmax(logits, axis=-1).astype(jnp.int32)
    scaled = (logits / temperature).reshape(1, -1)
    if min_p > 0.0:
        # Before the top-k/p filter — same order as sample_batch (the
        # min-p keep set only depends on the row max, but top-p's
        # cumulative set depends on what min-p already removed).
        thresh = jnp.max(scaled, axis=-1, keepdims=True) + jnp.log(min_p)
        scaled = jnp.where(scaled >= thresh, scaled, -jnp.inf)
    if top_k > 0 or top_p < 1.0:
        scaled = _filter_top_kp(
            scaled,
            jnp.asarray([top_k], jnp.int32),
            jnp.asarray([top_p], jnp.float32),
        )
    return jax.random.categorical(key, scaled[0]).astype(jnp.int32)


@jax.jit
def sample_batch(
    logits: jax.Array,
    key: jax.Array,
    temperatures: jax.Array,
    top_ks: Optional[jax.Array] = None,
    top_ps: Optional[jax.Array] = None,
    pen_counts: Optional[jax.Array] = None,
    presences: Optional[jax.Array] = None,
    frequencies: Optional[jax.Array] = None,
    min_ps: Optional[jax.Array] = None,
) -> jax.Array:
    """Per-slot greedy/temperature/top-k/top-p/min-p sampling in ONE
    device program.

    ``logits [B, V]``, ``temperatures [B]`` (0 = greedy), ``top_ks [B]``
    int32 (<=0 = off), ``top_ps [B]`` (>=1 = off).  Keeps the serving
    loop at a single host<->device round trip per decode step —
    per-slot host-side sampling costs one transfer each, which dominates
    end-to-end latency on dispatch-bound links.

    ``pen_counts [B, V]`` int32 (per-slot counts of previously generated
    tokens) enables OpenAI-style repetition control:
    ``logits -= presences * (counts > 0) + frequencies * counts``.
    Elementwise on [B, V] — cheap enough to run unconditionally (no
    sort, unlike the lax.cond-gated top-k/top-p filter); zero penalties
    are an exact no-op, greedy decoding is penalized too.
    """
    if pen_counts is not None:
        pen = presences[:, None] * (pen_counts > 0).astype(
            logits.dtype
        ) + frequencies[:, None] * pen_counts.astype(logits.dtype)
        logits = logits - pen
    greedy = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    temps = jnp.maximum(temperatures, 1e-6)[:, None]
    # min-p (Nguyen et al.) then top-k/top-p, via the shared cond-gated
    # filter (filter_scaled_logits) — all-greedy/plain-temperature
    # traffic never pays the [B, V] sort, and the serving loop keeps a
    # single compiled executable for any mix of request settings.
    scaled = filter_scaled_logits(logits / temps, top_ks, top_ps, min_ps)
    keys = jax.random.split(key, logits.shape[0])
    sampled = jax.vmap(
        lambda k, l: jax.random.categorical(k, l).astype(jnp.int32)
    )(keys, scaled)
    return jnp.where(temperatures <= 0.0, greedy, sampled)


@functools.partial(
    jax.jit, static_argnames=("cfg",), donate_argnames=("cache",)
)
def decode_and_sample(
    params: Params,
    cfg: ModelConfig,
    cache: KVCache,
    tokens: jax.Array,
    active: jax.Array,
    key: jax.Array,
    temperatures: jax.Array,
    top_ks: Optional[jax.Array] = None,
    top_ps: Optional[jax.Array] = None,
    pen_counts: Optional[jax.Array] = None,
    presences: Optional[jax.Array] = None,
    frequencies: Optional[jax.Array] = None,
    min_ps: Optional[jax.Array] = None,
) -> Tuple[jax.Array, KVCache]:
    """One fused device program per serving step: decode + batched sample.

    The KV cache is donated (updated in place -- no per-step copy of the
    whole cache) and the sampled tokens stay on device, so the serving
    loop costs exactly one dispatch plus one result fetch per step.

    With ``pen_counts`` (presence/frequency penalties, see
    ``sample_batch``) the emitted token is counted device-side and the
    updated counts are returned as an extra output.

    Returns ``(toks, logprobs, cache[, pen_counts])`` — ``logprobs [B]``
    is each emitted token's log-probability under the model's raw
    softmax (pre-temperature, pre-penalty: the standard serving-API
    convention), computed in the same fused program.
    """
    logits, cache = decode_step.__wrapped__(params, cfg, cache, tokens, active)
    toks = sample_batch.__wrapped__(
        logits, key, temperatures, top_ks, top_ps,
        pen_counts, presences, frequencies, min_ps,
    )
    # Inactive slots keep feeding token 0; their cache does not advance.
    toks = jnp.where(active, toks, 0)
    b = toks.shape[0]
    logp = jax.nn.log_softmax(logits, axis=-1)[jnp.arange(b), toks]
    if pen_counts is not None:
        pen_counts = pen_counts.at[jnp.arange(b), toks].add(
            active.astype(jnp.int32)
        )
        return toks, logp, cache, pen_counts
    return toks, logp, cache


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "n_steps"),
    donate_argnames=("cache",),
)
def decode_and_sample_multi(
    params: Params,
    cfg: ModelConfig,
    cache: KVCache,
    tokens: jax.Array,
    active: jax.Array,
    key: jax.Array,
    temperatures: jax.Array,
    top_ks: Optional[jax.Array] = None,
    top_ps: Optional[jax.Array] = None,
    pen_counts: Optional[jax.Array] = None,
    presences: Optional[jax.Array] = None,
    frequencies: Optional[jax.Array] = None,
    min_ps: Optional[jax.Array] = None,
    *,
    n_steps: int,
) -> Tuple[jax.Array, KVCache]:
    """``n_steps`` fused decode+sample steps in ONE device dispatch.

    A ``lax.scan`` chains the sampled token of step i into step i+1
    entirely on device, so the per-dispatch host cost is amortized over
    ``n_steps`` tokens.  Returns
    ``[n_steps, B]`` tokens.  EOS/max-new bookkeeping is already
    harvest-lagged in the engine, so the only behavioral change is
    admission/retirement granularity (a slot may decode up to
    ``n_steps - 1`` extra tokens past its stop point; they are
    discarded at harvest and masked by the next occupant's lengths).
    """

    def body(carry, k_i):
        tok, c, counts = carry
        logits, c = decode_step.__wrapped__(params, cfg, c, tok, active)
        toks = sample_batch.__wrapped__(
            logits, k_i, temperatures, top_ks, top_ps,
            counts, presences, frequencies, min_ps,
        )
        toks = jnp.where(active, toks, 0)
        b = toks.shape[0]
        logp = jax.nn.log_softmax(logits, axis=-1)[jnp.arange(b), toks]
        if counts is not None:
            counts = counts.at[jnp.arange(b), toks].add(
                active.astype(jnp.int32)
            )
        return (toks, c, counts), (toks, logp)

    keys = jax.random.split(key, n_steps)
    (_, cache, pen_counts), (all_toks, all_logps) = jax.lax.scan(
        body, (tokens, cache, pen_counts), keys
    )
    if pen_counts is not None:
        return all_toks, all_logps, cache, pen_counts
    return all_toks, all_logps, cache


@functools.partial(jax.jit, donate_argnames=("pen_counts",))
def admit_update(
    logits: jax.Array,  # [V] last-prompt-token logits from the prefill
    key: jax.Array,
    slot: jax.Array,  # traced int32 — one compilation for every slot
    temp: jax.Array,
    top_k: jax.Array,
    top_p: jax.Array,
    min_p: jax.Array,
    presence: jax.Array,
    frequency: jax.Array,
    next_token: jax.Array,
    temps: jax.Array,
    top_ks: jax.Array,
    top_ps: jax.Array,
    presences: jax.Array,
    frequencies: jax.Array,
    min_ps: jax.Array,
    pen_counts: jax.Array,
):
    """One fused device program for request admission.

    Samples the admission token from the prefill logits (same math as
    ``sample_batch`` — penalties are skipped because the new occupant's
    counts are zero, an exact no-op), computes its raw-softmax logprob,
    and installs every per-slot sampling parameter + the reset penalty
    counts in the same program.  The serving loop's admission used to
    issue ~8 eager state updates plus two synchronous fetches per
    request; this is one dispatch plus one (tok, logprob) fetch.
    """
    slot = jnp.asarray(slot, jnp.int32)
    tok = sample_batch.__wrapped__(
        logits[None], key, temp[None], top_k[None], top_p[None],
        None, None, None, min_p[None],
    )[0]
    logp = jax.nn.log_softmax(logits.astype(jnp.float32))[tok]
    next_token = next_token.at[slot].set(tok)
    temps = temps.at[slot].set(temp)
    top_ks = top_ks.at[slot].set(top_k)
    top_ps = top_ps.at[slot].set(top_p)
    presences = presences.at[slot].set(presence)
    frequencies = frequencies.at[slot].set(frequency)
    min_ps = min_ps.at[slot].set(min_p)
    # Fresh counts for the new occupant; the admission token is already
    # emitted, so it counts toward the penalties.
    b = pen_counts.shape[0]
    row = jnp.zeros((pen_counts.shape[1],), pen_counts.dtype).at[tok].set(1)
    pen_counts = jnp.where(
        (jnp.arange(b) == slot)[:, None], row[None, :], pen_counts
    )
    return (
        tok, logp, next_token, temps, top_ks, top_ps, presences,
        frequencies, min_ps, pen_counts,
    )
