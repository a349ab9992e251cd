"""Memory-efficient losses: blockwise (chunked-vocab) cross-entropy.

The plain ``transformer.loss_fn`` materializes ``[B, N, V]`` fp32 logits
— at V=32K, N=2048, B=8 that is 2 GB for the forward alone and the same
again for the cotangent, which caps trainable batch/sequence well below
what the matmuls could sustain.  This module computes the identical
next-token loss with the vocabulary processed in chunks under a
``lax.scan`` whose body is ``jax.checkpoint``-rematerialized: peak logit
memory drops from O(B*N*V) to O(B*N*chunk) (64x at the default chunk),
and the backward recomputes each chunk's logits instead of storing them
— the same FLOPs-for-HBM trade the attention kernels make with remat.

Numerics: an online logsumexp (running max + rescaled sum, the softmax
analog of the flash kernels' (m, l) carry) keeps the reduction exact in
fp32; an optional ``z_loss`` (Chowdhery et al., PaLM) regularizes the
partition function.  Matches ``transformer.loss_fn`` to fp32 roundoff.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from .transformer import ModelConfig, Params, forward_hidden


def blockwise_softmax_xent(
    hidden: jax.Array,
    lm_head: jax.Array,
    targets: jax.Array,
    *,
    vocab_chunk: int = 4096,
    z_loss: float = 0.0,
) -> jax.Array:
    """Mean cross-entropy of ``softmax(hidden @ lm_head)`` vs targets.

    ``hidden``: [B, T, d] activations (any float dtype; logits are fp32).
    ``lm_head``: [d, V] full-precision projection.
    ``targets``: [B, T] int32 class ids.

    Scans vocab chunks with an online logsumexp; the body is
    rematerialized so no [B, T, chunk] logit block survives to the
    backward pass.  ``vocab_chunk`` is an upper bound: the chunk is its
    largest divisor of the vocabulary (Llama-3's 128256 takes 4008).
    """
    d, v = lm_head.shape
    vocab_chunk = max(c for c in range(1, min(vocab_chunk, v) + 1)
                      if v % c == 0)
    n_chunks = v // vocab_chunk
    b, t = targets.shape
    hf = hidden.astype(lm_head.dtype)

    def body(carry, idx):
        m, l, tgt = carry
        wc = jax.lax.dynamic_slice(
            lm_head, (0, idx * vocab_chunk), (d, vocab_chunk)
        )
        logits = (hf @ wc).astype(jnp.float32)  # [B, T, chunk]
        m_c = jnp.max(logits, axis=-1)
        m_new = jnp.maximum(m, m_c)
        l = l * jnp.exp(m - m_new) + jnp.sum(
            jnp.exp(logits - m_new[..., None]), axis=-1
        )
        # Gather this chunk's target logit where the target falls inside.
        local = targets - idx * vocab_chunk
        in_chunk = (local >= 0) & (local < vocab_chunk)
        picked = jnp.take_along_axis(
            logits, jnp.clip(local, 0, vocab_chunk - 1)[..., None], axis=-1
        )[..., 0]
        tgt = jnp.where(in_chunk, picked, tgt)
        return (m_new, l, tgt), None

    init = (
        jnp.full((b, t), -jnp.inf, jnp.float32),
        jnp.zeros((b, t), jnp.float32),
        jnp.zeros((b, t), jnp.float32),
    )
    (m, l, tgt), _ = jax.lax.scan(
        jax.checkpoint(body), init, jnp.arange(n_chunks)
    )
    lse = m + jnp.log(l)
    nll = lse - tgt
    if z_loss:
        # Penalize log Z drifting from 0 (keeps logits calibrated and the
        # fp32 softmax well-conditioned on long runs).
        nll = nll + z_loss * lse**2
    return jnp.mean(nll)


def perplexity(
    params: Params,
    batches,
    cfg: ModelConfig,
    *,
    n_batches: int,
    vocab_chunk: int = 4096,
) -> float:
    """Token-weighted eval perplexity over ``n_batches`` from an
    iterator of ``[B, N]`` token batches.

    Uses the blockwise loss (no [B, N, V] logits), jitted once; batches
    may vary in B/N (each shape compiles once).  Deterministic — no
    dropout at eval.
    """
    import functools

    eval_loss = jax.jit(
        functools.partial(loss_fn_blockwise, vocab_chunk=vocab_chunk),
        static_argnames=("cfg",),
    )
    total_nll = 0.0
    total_tok = 0
    for _ in range(n_batches):
        tokens = next(batches)
        n_tok = tokens.shape[0] * (tokens.shape[1] - 1)
        total_nll += float(eval_loss(params, tokens, cfg)) * n_tok
        total_tok += n_tok
    import math

    return math.exp(total_nll / max(total_tok, 1))


def loss_fn_blockwise(
    params: Params,
    tokens: jax.Array,
    cfg: ModelConfig,
    dropout_key: Optional[jax.Array] = None,
    *,
    vocab_chunk: int = 4096,
    z_loss: float = 0.0,
) -> jax.Array:
    """Next-token CE == ``transformer.loss_fn`` without [B, N, V] logits.

    Requires a full-precision ``lm_head`` (training keeps fp32 masters;
    the weight-only int8 serving tree is not a training input).
    """
    lm_head = params["lm_head"]
    if isinstance(lm_head, dict):
        raise ValueError(
            "loss_fn_blockwise trains against full-precision masters; got "
            "a weight-quantized lm_head (models/wquant.py is serving-only)"
        )
    hidden = forward_hidden(params, tokens, cfg, dropout_key=dropout_key)
    return blockwise_softmax_xent(
        hidden[:, :-1],
        lm_head.astype(cfg.dtype),
        tokens[:, 1:],
        vocab_chunk=min(vocab_chunk, cfg.vocab_size),
        z_loss=z_loss,
    )
