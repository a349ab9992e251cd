"""Beam-search decoding on the slot-cache primitives.

The continuous-batching engine covers sampling/greedy serving; this
module adds the classic highest-probability search for quality-first
decoding (translation-style workloads).  Beams live in the batch
dimension of the decode state — one fused step per round scores all
beams at once, and beam reordering is a single gather on the
state's slot axis (cheap: [L, B, Hk, N, D] with B = beam_width).

Finished beams (EOS) are frozen with the standard mask trick: their row
proposes exactly one zero-logprob continuation, so they survive the
top-k unchanged and fixed shapes are preserved under jit.

Two entry points share the generic :func:`beam_search_loop`:

* :func:`beam_search_generate` — FlashLM over a dense ``KVCache``.
* ``models.seq2seq.beam_generate`` — the encoder-decoder family (self
  KV cache + fixed cross-attention memory per beam).
"""

from __future__ import annotations

import functools
from typing import Callable, List, Tuple

import jax
import jax.numpy as jnp

from ..models.transformer import ModelConfig, Params
from .decode import decode_step, prefill_slot
from .kv_cache import KVCache, init_cache


def reorder_beam_state(state, parents: jax.Array):
    """Gather beam-state leaves by parent index.

    Convention (dense cache layout): rank-1 leaves are per-beam scalars
    (lengths) gathered on axis 0; everything else is ``[L, B, ...]``,
    gathered on axis 1.
    """

    def pick(leaf):
        if leaf.ndim == 1:
            return leaf[parents]
        return leaf[:, parents]

    return jax.tree_util.tree_map(pick, state)


def beam_search_loop(
    step_fn: Callable,
    state,
    logits0: jax.Array,
    *,
    beam_width: int,
    max_new_tokens: int,
    eos_id: int = -1,
    length_penalty: float = 0.0,
    return_all: bool = False,
    reorder_fn: Callable = reorder_beam_state,
):
    """Generic beam search over a batched decode step.

    ``step_fn(state, tokens, finished) -> (logits [B, V], state)`` must
    advance live beams only (frozen beams' state must stay inert);
    ``logits0`` is the prompt's next-token distribution (``[V]``-like)
    that seeds the first expansion; ``state`` must already hold
    ``beam_width`` identical beams.
    """
    if beam_width < 1:
        raise ValueError(f"beam_width must be >= 1, got {beam_width}")

    @functools.partial(jax.jit, static_argnames=())
    def beam_step(state, tokens, cum_logp, finished, out_tokens, step):
        logits, state = step_fn(state, tokens, finished)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        v = logp.shape[-1]
        # Finished beams propose a single frozen continuation (token 0
        # at logprob 0); live beams propose the full vocab.
        frozen = jnp.full_like(logp, -jnp.inf).at[:, 0].set(0.0)
        logp = jnp.where(finished[:, None], frozen, logp)
        total = cum_logp[:, None] + logp  # [B, V]
        top, idx = jax.lax.top_k(total.reshape(-1), beam_width)
        parents = idx // v
        toks = (idx % v).astype(jnp.int32)

        state = reorder_fn(state, parents)
        was_finished = finished[parents]
        # Frozen beams' dummy continuation must not pollute history.
        write = jnp.where(was_finished, jnp.int32(-1), toks)
        out_tokens = out_tokens[parents].at[:, step].set(write)
        now_finished = was_finished | (toks == eos_id)
        return state, toks, top, now_finished, out_tokens

    logp0 = jax.nn.log_softmax(
        logits0.astype(jnp.float32).reshape(-1)
    )
    cum_logp, first = jax.lax.top_k(logp0, beam_width)
    first = first.astype(jnp.int32)
    out_tokens = jnp.full((beam_width, max_new_tokens), -1, jnp.int32)
    out_tokens = out_tokens.at[:, 0].set(first)
    finished = first == eos_id
    tokens = first

    for step in range(1, max_new_tokens):
        if bool(jnp.all(finished)):
            break
        state, tokens, cum_logp, finished, out_tokens = beam_step(
            state, tokens, cum_logp, finished, out_tokens, jnp.int32(step)
        )

    outs = []
    for b in range(beam_width):
        seq = [int(t) for t in out_tokens[b] if int(t) >= 0]
        # Trim at EOS (inclusive end — EOS itself is not returned).
        if eos_id >= 0 and eos_id in seq:
            seq = seq[: seq.index(eos_id)]
        n = max(len(seq), 1)
        score = float(cum_logp[b]) / (
            n**length_penalty if length_penalty else 1.0
        )
        outs.append((seq, score))
    outs.sort(key=lambda t: -t[1])
    if return_all:
        return outs
    return outs[0]


def broadcast_slot0(state):
    """Copy beam 0's state to every beam (post-prefill seeding)."""

    def bcast(leaf):
        if leaf.ndim == 1:
            return jnp.broadcast_to(leaf[:1], leaf.shape)
        return jnp.broadcast_to(leaf[:, :1], leaf.shape)

    return jax.tree_util.tree_map(bcast, state)


def beam_search_generate(
    params: Params,
    cfg: ModelConfig,
    prompt: List[int],
    *,
    beam_width: int = 4,
    max_new_tokens: int = 32,
    max_len: int = 1024,
    eos_id: int = -1,
    length_penalty: float = 0.0,
    return_all: bool = False,
) -> Tuple[List[int], float]:
    """Highest-probability FlashLM continuation of ``prompt``.

    Returns ``(tokens, score)`` where score is the total log-probability
    normalized by ``len ** length_penalty`` (0.0 = raw sum).  With
    ``return_all=True`` returns the full beam lists instead.
    Dense KV caches only (beam reordering gathers slot axes).
    """
    cache = init_cache(
        cfg.n_layers, beam_width, cfg.n_kv_heads, max_len, cfg.head_dim,
        dtype=cfg.dtype,
    )
    n_pad = max(((len(prompt) + 127) // 128) * 128, 128)
    padded = jnp.zeros((n_pad,), jnp.int32).at[: len(prompt)].set(
        jnp.asarray(prompt, jnp.int32)
    )
    logits0, cache = prefill_slot(
        params, cfg, cache, padded, jnp.int32(len(prompt)), slot=0
    )
    cache = broadcast_slot0(cache)

    def step_fn(cache, tokens, finished):
        # decode_step bumps lengths only for active slots; frozen beams
        # stay put so their KV history stays exactly their sequence.
        return decode_step(
            params, cfg, cache, tokens, jnp.logical_not(finished)
        )

    return beam_search_loop(
        step_fn,
        cache,
        logits0,
        beam_width=beam_width,
        max_new_tokens=max_new_tokens,
        eos_id=eos_id,
        length_penalty=length_penalty,
        return_all=return_all,
    )
