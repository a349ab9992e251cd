"""Speculative decoding: draft-model proposals, target-model verification.

The reference is a single-model kernel study; this is the serving-side
composite its LSE/online-softmax machinery enables (the same design seed
as the KV cache: ``/root/reference/kernels.metal:861-864``): a cheap
draft model proposes ``gamma`` tokens autoregressively, the target model
scores all of them in ONE chunked decode (causal flash attention with
``q_offset`` — the identical kernel/masking path as chunked prefill,
``runtime/decode.py:1-8``), and a device-side acceptance rule keeps the
longest prefix consistent with the target distribution.

Static-shape discipline:

* One jitted program per round (draft loop unrolled over static
  ``gamma``, verify chunk padded to a multiple of 8 rows) — no dynamic
  shapes, one host round-trip per round for the emit count.
* Cache "rollback" after rejection is O(1): appends past a slot's
  ``lengths`` are invisible to the causal-offset masking and are simply
  overwritten by the next round, so restoring ``lengths`` IS the
  rollback (no copies, no page juggling).
* Greedy (temperature 0) acceptance emits EXACTLY the target model's
  greedy sequence — verified token-for-token in ``tests``.  For
  temperature > 0 the standard speculative-sampling rule (accept with
  ``min(1, p/q)``, resample the first rejection from ``max(p - q, 0)``)
  preserves the target distribution.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.transformer import (
    ModelConfig,
    Params,
    mlp_block,
    rms_norm,
    weight,
)
from .decode import _attn_with_cache, decode_step, prefill_slot, sample
from .kv_cache import KVCache, init_cache


def _forward_chunk(
    params: Params,
    cfg: ModelConfig,
    cache: KVCache,
    tokens: jax.Array,  # [B, T]
) -> Tuple[jax.Array, KVCache]:
    """Multi-token decode: logits ``[B, T, V]``; does NOT bump lengths.

    Row ``t`` of slot ``b`` sits at global position ``lengths[b] + t``;
    the cache's causal offset masks everything at/after each row, so
    trailing padding rows are harmless (their KV writes land past the
    final accepted length and are overwritten by later rounds).
    """
    t_new = tokens.shape[1]
    positions = cache.lengths[:, None] + jnp.arange(t_new)[None, :]
    x = params["embed"][tokens].astype(cfg.dtype)
    for i, layer in enumerate(params["layers"]):
        x, cache = _attn_with_cache(layer, x, cfg, cache, i, positions)
        x = mlp_block(layer, x, cfg)
    x = rms_norm(x, params["final_norm"])
    logits = (x @ weight(params["lm_head"], cfg.dtype)).astype(jnp.float32)
    return logits, cache


def acceptance_rule(
    d: jax.Array,  # [B, gamma] draft proposals
    q_logits: jax.Array,  # [B, gamma, V] draft logits per proposal
    logits_t: jax.Array,  # [B, gamma+1, V] target logits over [tok, d...]
    greedy_slot: jax.Array,  # [B] bool
    tau: jax.Array,  # [B, 1] clamped temperatures
    key_u: jax.Array,
    key_resid: jax.Array,
    top_ks: Optional[jax.Array] = None,  # [B] int32, <= 0 disables
    top_ps: Optional[jax.Array] = None,  # [B] float, >= 1 disables
    min_ps: Optional[jax.Array] = None,  # [B] float, <= 0 disables
    pen_counts: Optional[jax.Array] = None,  # [B, V] int32
    presences: Optional[jax.Array] = None,  # [B]
    frequencies: Optional[jax.Array] = None,  # [B]
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Device-side speculative acceptance (shared by the dense and the
    sp/tp-sharded serving paths — ``runtime/sp_decode.py``).

    Greedy slots accept by exact token match (output == the target's own
    greedy decode); sampling slots use the standard speculative-sampling
    rule (accept w.p. ``min(1, p/q)``, resample the first rejection from
    the normalized residual ``max(p - q, 0)``), which preserves the
    target distribution.  With per-slot ``top_ks``/``top_ps``/``min_ps``
    the SAME filter is applied to both the target and draft scaled
    logits (matching the draft's filtered proposal sampling in
    ``speculative_step``), so the rule preserves the *filtered* target
    distribution — exactly what the non-speculative ``sample_batch``
    serves.

    Presence/frequency penalties compose the same way (round 5): window
    row ``t`` is penalized with ``pen_counts`` plus the one-hots of the
    PRECEDING window tokens ``d_0..d_{t-1}`` — exactly the counts the
    sequential engine would hold when emitting that token, because row t
    is only reached when the whole prefix was accepted.  The draft loop
    applies the same running counts to its proposal distribution.
    Returns ``(out [B, gamma+1], n_acc [B], bonus [B])`` with
    ``out[:, n_acc] == bonus``.
    """
    from .decode import filter_scaled_logits

    batch, gamma = d.shape
    vocab = logits_t.shape[-1]

    if pen_counts is not None:
        # counts at window row t: base + one-hots of d_0..d_{t-1}.
        # Only the TARGET logits are penalized here — ``q_logits`` must
        # arrive exactly as the draft sampled from them, and the draft
        # loop already applied the same running-count penalties.
        d_hot = jax.nn.one_hot(d, vocab, dtype=jnp.int32)  # [B, gamma, V]
        cum = jnp.cumsum(d_hot, axis=1)
        counts_t = pen_counts[:, None, :] + jnp.concatenate(
            [jnp.zeros_like(cum[:, :1]), cum], axis=1
        )  # [B, gamma+1, V]
        pen_t = presences[:, None, None] * (counts_t > 0) + (
            frequencies[:, None, None] * counts_t
        )
        logits_t = logits_t - pen_t

    t_pred = jnp.argmax(logits_t, -1).astype(jnp.int32)  # [B, gamma+1]
    greedy_match = d == t_pred[:, :gamma]

    def _probs(scaled):
        # [B, T, V] scaled logits -> filtered softmax, sharing the slots'
        # filter params across the T window rows.
        t = scaled.shape[1]
        if top_ks is None and top_ps is None and min_ps is None:
            return jax.nn.softmax(scaled, axis=-1)
        rep = lambda x: (
            None if x is None else jnp.repeat(x, t, axis=0)
        )
        flat = filter_scaled_logits(
            scaled.reshape(batch * t, vocab),
            rep(top_ks), rep(top_ps), rep(min_ps),
        )
        return jax.nn.softmax(flat, axis=-1).reshape(batch, t, vocab)

    p = _probs(logits_t / tau[..., None])
    q = _probs(q_logits / tau[..., None])
    p_tok = jnp.take_along_axis(p[:, :gamma], d[..., None], -1)[..., 0]
    q_tok = jnp.take_along_axis(q, d[..., None], -1)[..., 0]
    u = jax.random.uniform(key_u, (batch, gamma))
    samp_accept = u < jnp.minimum(1.0, p_tok / jnp.maximum(q_tok, 1e-20))
    accept = jnp.where(greedy_slot[:, None], greedy_match, samp_accept)
    acc = jnp.cumprod(accept.astype(jnp.int32), axis=1)
    n_acc = jnp.sum(acc, axis=1)  # [B] in [0, gamma]

    # Bonus token at the first rejected position: greedy slots take the
    # target argmax; sampling slots resample from the residual
    # max(p - q, 0) (q = 0 past gamma, so the all-accept bonus reduces
    # to the target's own distribution).
    bonus_g = jnp.take_along_axis(t_pred, n_acc[:, None], axis=1)[:, 0]
    p_n = jnp.take_along_axis(
        p, n_acc[:, None, None].repeat(p.shape[-1], -1), axis=1
    )[:, 0]  # [B, V]
    q_pad = jnp.concatenate([q, jnp.zeros_like(q[:, :1])], axis=1)
    q_n = jnp.take_along_axis(
        q_pad, n_acc[:, None, None].repeat(q.shape[-1], -1), axis=1
    )[:, 0]
    resid = jnp.maximum(p_n - q_n, 0.0)
    norm = jnp.sum(resid, axis=-1, keepdims=True)
    resid = jnp.where(norm > 0, resid / jnp.maximum(norm, 1e-20), p_n)
    bonus_s = jax.random.categorical(
        key_resid, jnp.log(jnp.maximum(resid, 1e-30))
    ).astype(jnp.int32)
    bonus = jnp.where(greedy_slot, bonus_g, bonus_s)

    # Assemble the emitted window: accepted prefix, then the bonus.
    idx = jnp.arange(gamma + 1)[None, :]
    d_ext = jnp.concatenate([d, d[:, -1:]], axis=1)
    out = jnp.where(
        idx < n_acc[:, None],
        d_ext,
        jnp.where(idx == n_acc[:, None], bonus[:, None], 0),
    )
    return out, n_acc, bonus


@functools.partial(
    jax.jit,
    static_argnames=("cfg_t", "cfg_d", "gamma"),
    donate_argnames=("cache_t", "cache_d"),
)
def speculative_step(
    params_t: Params,
    cfg_t: ModelConfig,
    cache_t: KVCache,
    params_d: Params,
    cfg_d: ModelConfig,
    cache_d: KVCache,
    tok: jax.Array,  # [B] the last emitted token per slot
    active: jax.Array,  # [B] bool
    key: jax.Array,
    temps: jax.Array,  # [B] per-slot temperature; <= 0 = greedy
    top_ks: Optional[jax.Array] = None,  # [B] int32, <= 0 disables
    top_ps: Optional[jax.Array] = None,  # [B] float, >= 1 disables
    min_ps: Optional[jax.Array] = None,  # [B] float, <= 0 disables
    pen_counts: Optional[jax.Array] = None,  # [B, V] int32
    presences: Optional[jax.Array] = None,  # [B]
    frequencies: Optional[jax.Array] = None,  # [B]
    *,
    gamma: int,
) -> Tuple[jax.Array, ...]:
    """One speculative round; emits 1..gamma+1 tokens per active slot.

    Invariant in/out: both caches hold KV for all positions < lengths[b]
    and ``tok[b]`` is the token AT position lengths[b] (not yet in any
    cache).  Returns ``(out [B, gamma+1], n_emit [B], new_tok [B],
    cache_t, cache_d, pen_counts')`` — per slot, ``out[:n_emit]`` are
    the emitted tokens, ``new_tok == out[n_emit - 1]`` seeds the next
    round, and ``pen_counts'`` is the penalty-count state advanced by
    every emitted token (``None`` when ``pen_counts`` is ``None``).

    ``temps`` mixes modes per slot in one executable: greedy slots use
    exact token-match acceptance (output identical to the target's
    greedy decode); sampling slots use the speculative-sampling rule
    (accept with ``min(1, p/q)``, resample the first rejection from the
    normalized residual ``max(p - q, 0)``), which preserves the target
    distribution at that temperature.  Per-slot ``top_ks``/``top_ps``/
    ``min_ps`` compose: the draft proposes from its FILTERED
    distribution and the acceptance computes p/q under the same filter,
    so the emitted stream follows the filtered target distribution
    (identical semantics to ``sample_batch`` without a draft).
    """
    from .decode import filter_scaled_logits

    l0_t, l0_d = cache_t.lengths, cache_d.lengths
    keys = jax.random.split(key, gamma + 2)
    greedy_slot = temps <= 0.0  # [B]
    tau = jnp.maximum(temps, 1e-6)[:, None]

    # --- draft: gamma proposals + one extra ingest step so the draft
    # cache covers its own last proposal (needed when all are accepted).
    # Penalties apply with RUNNING counts (base + the window's own
    # earlier proposals), matching acceptance_rule's per-row counts.
    draft_toks, draft_logits = [], []
    cur = tok
    counts_run = pen_counts
    for i in range(gamma):
        logits_d, cache_d = decode_step.__wrapped__(
            params_d, cfg_d, cache_d, cur, active
        )
        if pen_counts is not None:
            logits_d = logits_d - (
                presences[:, None] * (counts_run > 0)
                + frequencies[:, None] * counts_run
            )
        g = jnp.argmax(logits_d, -1).astype(jnp.int32)
        s = jax.random.categorical(
            keys[i],
            filter_scaled_logits(logits_d / tau, top_ks, top_ps, min_ps),
        ).astype(jnp.int32)
        cur = jnp.where(greedy_slot, g, s)
        if pen_counts is not None:
            counts_run = counts_run + jax.nn.one_hot(
                cur, counts_run.shape[-1], dtype=jnp.int32
            )
        draft_toks.append(cur)
        draft_logits.append(logits_d)
    _, cache_d = decode_step.__wrapped__(params_d, cfg_d, cache_d, cur, active)
    d = jnp.stack(draft_toks, 1)  # [B, gamma]

    # --- target verify: one chunked decode over [tok, d_0..d_{gamma-1}],
    # padded to a multiple-of-8 row count for the kernel's q tiling.
    t_rows = gamma + 1
    t_pad = -(-t_rows // 8) * 8
    seq = jnp.concatenate([tok[:, None], d], axis=1)
    seq = jnp.pad(seq, ((0, 0), (0, t_pad - t_rows)))
    logits_t, cache_t = _forward_chunk(params_t, cfg_t, cache_t, seq)
    logits_t = logits_t[:, :t_rows]  # [B, gamma+1, V]

    # --- acceptance (shared rule) + restore the length invariant.
    out, n_acc, bonus = acceptance_rule(
        d, jnp.stack(draft_logits, 1), logits_t, greedy_slot, tau,
        keys[gamma], keys[gamma + 1], top_ks, top_ps, min_ps,
        pen_counts, presences, frequencies,
    )
    n_emit = jnp.where(active, n_acc + 1, 0).astype(jnp.int32)
    cache_t = dataclasses.replace(
        cache_t, lengths=(l0_t + n_emit).astype(jnp.int32)
    )
    cache_d = dataclasses.replace(
        cache_d, lengths=(l0_d + n_emit).astype(jnp.int32)
    )
    new_counts = pen_counts
    if pen_counts is not None:
        # Advance the penalty state by every EMITTED token this round.
        emitted = jnp.arange(gamma + 1)[None, :] < n_emit[:, None]
        out_hot = jax.nn.one_hot(
            out, pen_counts.shape[-1], dtype=jnp.int32
        )
        new_counts = pen_counts + jnp.sum(
            out_hot * emitted[..., None], axis=1
        )
    return out, n_emit, bonus, cache_t, cache_d, new_counts


def speculative_generate(
    params_t: Params,
    cfg_t: ModelConfig,
    params_d: Params,
    cfg_d: ModelConfig,
    prompts: List[List[int]],
    max_new: int,
    *,
    gamma: int = 4,
    temperature: float = 0.0,
    seed: int = 0,
    max_len: Optional[int] = None,
) -> List[List[int]]:
    """Generate ``max_new`` tokens per prompt via speculative decoding.

    At temperature 0 the result is token-for-token identical to the
    target model's plain greedy decode (the draft only changes HOW MANY
    target forwards it takes, never the output).
    """
    batch = len(prompts)
    max_prompt = max(len(p) for p in prompts)
    pad = lambda n: -(-n // 128) * 128
    n_pad = pad(max_prompt)
    if max_len is None:
        max_len = pad(n_pad + max_new + gamma + 9)
    cache_t = init_cache(
        cfg_t.n_layers, batch, cfg_t.n_kv_heads, max_len,
        cfg_t.head_dim, cfg_t.dtype,
    )
    cache_d = init_cache(
        cfg_d.n_layers, batch, cfg_d.n_kv_heads, max_len,
        cfg_d.head_dim, cfg_d.dtype,
    )

    key = jax.random.PRNGKey(seed)
    first = []
    for b, prompt in enumerate(prompts):
        toks = jnp.asarray(
            list(prompt) + [0] * (n_pad - len(prompt)), jnp.int32
        )
        plen = jnp.int32(len(prompt))
        logits_b, cache_t = prefill_slot(
            params_t, cfg_t, cache_t, toks, plen, b
        )
        _, cache_d = prefill_slot(params_d, cfg_d, cache_d, toks, plen, b)
        key, sub = jax.random.split(key)
        first.append(int(sample(logits_b, sub, temperature)))

    emitted: List[List[int]] = [[t] for t in first]
    tok = jnp.asarray(first, jnp.int32)
    while True:
        active_h = np.array([len(e) < max_new for e in emitted])
        if not active_h.any():
            break
        key, sub = jax.random.split(key)
        out, n_emit, tok, cache_t, cache_d, _ = speculative_step(
            params_t, cfg_t, cache_t, params_d, cfg_d, cache_d,
            tok, jnp.asarray(active_h), sub,
            jnp.full((batch,), temperature, jnp.float32),
            gamma=gamma,
        )
        out_h = np.asarray(out)
        n_h = np.asarray(n_emit)
        for b in range(batch):
            if active_h[b]:
                room = max_new - len(emitted[b])
                emitted[b].extend(out_h[b, : min(int(n_h[b]), room)].tolist())
    return emitted
