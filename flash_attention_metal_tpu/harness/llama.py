"""The Llama-3.1-8B configuration the GPU smoke run and the timing of
each attention end use, with seeded weights and requests.

Source: ``meta-llama/Llama-3.1-8B`` ``config.json`` (hidden 4096, 32
layers, 32 heads, 8 KV heads, head dim 128, intermediate 14336, vocab
128256, rope_theta 500000).  Not modelled: the ``llama3`` RoPE scaling,
and ``rms_norm_eps`` (FlashLM uses 1e-6, the config 1e-5).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..models import ModelConfig, init_params

LLAMA_8B = dict(
    vocab_size=128256, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
    head_dim=128, d_ff=14336, rope_theta=500000.0,
)
# Rehearsal widths for runs without a GPU.
TINY = dict(
    vocab_size=512, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=64, d_ff=512, rope_theta=500000.0,
)


def model_config(widths: dict, **over) -> ModelConfig:
    return ModelConfig(**{**widths, "max_seq_len": 8192,
                          "dtype": jnp.bfloat16, **over})


def bf16_params(cfg: ModelConfig, seed: int = 0):
    """Seeded ``init_params`` weights in bf16, built one layer at a time
    so the fp32 masters of a full-depth model never exist at once."""
    one = dataclasses.replace(cfg, n_layers=1)

    def cast(tree):
        return jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), tree)

    base = jax.jit(lambda k: cast(init_params(k, one)))(
        jax.random.PRNGKey(seed))
    layer = jax.jit(lambda k: cast(init_params(k, one)["layers"][0]))
    layers = [layer(jax.random.fold_in(jax.random.PRNGKey(seed), i + 1))
              for i in range(cfg.n_layers)]
    return {**base, "layers": layers}


def make_requests(vocab: int, n: int = 8, new: int = 32,
                  buckets=(384, 1024, 2048), seed: int = 0):
    """Seeded ``(uid, prompt, max_new)`` requests; prompt lengths fall in
    the top 100 tokens of each padding bucket, so each bucket is one
    prefill compilation."""
    rng = np.random.default_rng(seed)
    out = []
    for uid in range(n):
        length = int(buckets[uid % len(buckets)] - rng.integers(0, 100))
        out.append((uid, rng.integers(1, vocab, length).tolist(), new))
    return out
