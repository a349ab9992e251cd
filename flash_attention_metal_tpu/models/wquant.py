"""Weight-only int8 quantization for serving.

Completes the 8-bit serving story next to the int8 KV cache
(``runtime/kv_cache.py``): decode-time matmuls on small batches are
HBM-bound on the *weights*, so halving weight bytes is the same class of
win the reference chased by halving activation bytes with fp16
(``kernels.metal:600-883``) — applied to the model side the reference
never had.

Scheme: symmetric per-output-channel int8.  Each targeted 2-D weight
``W[din, dout]`` becomes ``{"qw": int8, "scale": f32[1, dout]}`` with
``scale_j = max_i |W_ij| / 127``; consumers rebuild ``qw * scale`` via
:func:`flash_attention_metal_tpu.models.transformer.weight` (XLA fuses
the dequant into the matmul operand load, so HBM sees int8).
The quantized tree is a drop-in FlashLM param tree for ``forward`` and
the whole dense/dp serving stack (prefill, decode, ``DecodeEngine``,
composes with int8/paged KV and speculative decoding).  Training and
the sharded (tp/sp) paths keep full-precision masters.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp

Params = Dict[str, Any]

# Dense per-layer matmul weights (MoE expert stacks are 3-D and skipped;
# norms and the embedding gather are byte-trivial and stay fp32).
WEIGHT_QUANT_TARGETS: Tuple[str, ...] = (
    "wq",
    "wk",
    "wv",
    "wo",
    "w_gate",
    "w_up",
    "w_down",
)


def quantize_weight(w: jax.Array) -> Dict[str, jax.Array]:
    """Symmetric per-output-channel int8: ``w ~= qw * scale``."""
    if w.ndim != 2:
        raise ValueError(f"expected a 2-D weight, got shape {w.shape}")
    scale = jnp.max(jnp.abs(w.astype(jnp.float32)), axis=0, keepdims=True)
    scale = jnp.maximum(scale, 1e-8) / 127.0
    qw = jnp.clip(jnp.round(w / scale), -127, 127).astype(jnp.int8)
    return {"qw": qw, "scale": scale.astype(jnp.float32)}


def quantize_weights(
    params: Params,
    targets: Tuple[str, ...] = WEIGHT_QUANT_TARGETS,
    lm_head: bool = True,
) -> Params:
    """FlashLM params -> weight-only int8 serving tree.

    Only 2-D layer weights named in ``targets`` (plus optionally
    ``lm_head`` — the largest decode matmul) are converted; everything
    else (norms, embedding, MoE expert stacks, router) is untouched.
    """
    layers = []
    for layer in params["layers"]:
        new = dict(layer)
        for name in targets:
            w = layer.get(name)
            if w is not None and not isinstance(w, dict) and w.ndim == 2:
                new[name] = quantize_weight(w)
        layers.append(new)
    out = dict(params)
    out["layers"] = layers
    if lm_head and not isinstance(params["lm_head"], dict):
        out["lm_head"] = quantize_weight(params["lm_head"])
    return out


def weight_bytes(params: Params) -> int:
    """Total bytes of every leaf (for before/after memory accounting)."""
    return sum(x.nbytes for x in jax.tree_util.tree_leaves(params))
