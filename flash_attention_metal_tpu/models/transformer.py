"""FlashLM — the flagship decoder-only transformer driving the kernels.

The reference is a kernel study with no model layer (SURVEY.md §2); this
module is the production context those kernels exist for: a GQA
decoder-only LM whose every attention call is the framework's flash
attention op.  Design choices:

* functional pytree params + pure functions (jit/pjit/shard_map friendly)
* RMSNorm + SwiGLU + RoPE (all fuse into XLA-friendly elementwise chains)
* GQA with head counts chosen to co-locate Q heads with their KV head
  under tensor-parallel sharding (boom guide §14)
* bf16 activations / fp32 softmax stats (the V4 numerics policy,
  ``kernels.metal:633-638``) with an fp32 master-weight training step
* ``jax.checkpoint`` on each block so long-sequence training trades
  FLOPs for HBM (remat instead of activation storage)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import BlockSizes
from ..ops.attention import flash_attention


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32768
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 2
    head_dim: int = 64
    d_ff: int = 1408  # ~8/3 * d_model rounded to 128
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    dtype: Any = jnp.bfloat16
    # Attention kernel configuration.
    block_sizes: Optional[BlockSizes] = None
    attn_impl: str = "auto"
    # Sliding-window (local) attention; None = full causal.
    attn_window: Optional[int] = None
    # Attention sinks: first N positions stay visible beyond the window.
    attn_sinks: int = 0
    # Tanh logit soft-cap on attention scores (Gemma-2 style); None = off.
    attn_softcap: Optional[float] = None
    # ALiBi linear position bias instead of RoPE ("Train Short, Test
    # Long"): per-head slopes 2^(-8i/n_heads), RoPE disabled.
    attn_alibi: bool = False
    # Attention-probability dropout rate (training only; applied when a
    # dropout key is passed to ``forward``/``loss_fn``).  In-kernel
    # deterministic mask — see ``ops.attention.flash_attention``.
    attn_dropout: float = 0.0

    def __post_init__(self):
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        if self.d_ff % 128 or self.d_model % 128:
            raise ValueError("d_model and d_ff must be multiples of 128")


Params = Dict[str, Any]


def init_params(key: jax.Array, cfg: ModelConfig) -> Params:
    """fp32 master parameters (cast to cfg.dtype at use sites)."""
    keys = jax.random.split(key, cfg.n_layers + 2)

    def dense(k, fan_in, shape):
        return jax.random.normal(k, shape, jnp.float32) * (fan_in**-0.5)

    d, h, hk, hd, f = (
        cfg.d_model,
        cfg.n_heads,
        cfg.n_kv_heads,
        cfg.head_dim,
        cfg.d_ff,
    )
    layers = []
    for i in range(cfg.n_layers):
        lk = jax.random.split(keys[i], 8)
        layers.append(
            {
                "attn_norm": jnp.ones((d,), jnp.float32),
                "wq": dense(lk[0], d, (d, h * hd)),
                "wk": dense(lk[1], d, (d, hk * hd)),
                "wv": dense(lk[2], d, (d, hk * hd)),
                "wo": dense(lk[3], h * hd, (h * hd, d)),
                "mlp_norm": jnp.ones((d,), jnp.float32),
                "w_gate": dense(lk[4], d, (d, f)),
                "w_up": dense(lk[5], d, (d, f)),
                "w_down": dense(lk[6], f, (f, d)),
            }
        )
    return {
        "embed": jax.random.normal(keys[-2], (cfg.vocab_size, d), jnp.float32)
        * 0.02,
        "layers": layers,
        "final_norm": jnp.ones((d,), jnp.float32),
        "lm_head": dense(keys[-1], d, (d, cfg.vocab_size)),
    }


def weight(w, dt) -> jax.Array:
    """Fetch a dense weight in compute dtype.

    Accepts either a plain fp32 master array or a weight-only int8 dict
    ``{"qw", "scale"}`` from ``models.wquant.quantize_weights``; the
    dequant multiply fuses into the consuming matmul's operand load, so
    HBM traffic for quantized weights is int8.
    """
    if isinstance(w, dict):
        return w["qw"].astype(dt) * w["scale"].astype(dt)
    return w.astype(dt)


def rms_norm(x: jax.Array, w: jax.Array, eps: float = 1e-6) -> jax.Array:
    xf = x.astype(jnp.float32)
    var = jnp.mean(xf * xf, axis=-1, keepdims=True)
    return (xf * jax.lax.rsqrt(var + eps) * w).astype(x.dtype)


def rope(x: jax.Array, positions: jax.Array, theta: float) -> jax.Array:
    """Rotary embedding over ``[B, H, N, D]`` with positions ``[B, N]``."""
    hd = x.shape[-1]
    freqs = theta ** (-jnp.arange(0, hd, 2, dtype=jnp.float32) / hd)
    angles = positions[:, None, :, None].astype(jnp.float32) * freqs  # B1NF
    cos, sin = jnp.cos(angles), jnp.sin(angles)
    x1, x2 = x[..., 0::2].astype(jnp.float32), x[..., 1::2].astype(jnp.float32)
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    out = jnp.stack([r1, r2], axis=-1).reshape(x.shape)
    return out.astype(x.dtype)


def alibi_slopes(n_heads: int) -> jax.Array:
    """Standard ALiBi slope schedule: ``2^(-8i/n)`` for head i=1..n."""
    return jnp.asarray(
        [2.0 ** (-8.0 * (i + 1) / n_heads) for i in range(n_heads)],
        jnp.float32,
    )


def _maybe_rope(x, positions, cfg):
    """RoPE unless the config uses ALiBi for position (mutually exclusive
    position schemes — ALiBi models are trained without rotary)."""
    if cfg.attn_alibi:
        return x
    return rope(x, positions, cfg.rope_theta)


def _split_heads(x: jax.Array, n_heads: int, head_dim: int) -> jax.Array:
    b, n, _ = x.shape
    return x.reshape(b, n, n_heads, head_dim).transpose(0, 2, 1, 3)


def _merge_heads(x: jax.Array) -> jax.Array:
    b, h, n, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b, n, h * d)


def attention_block(
    layer: Params,
    x: jax.Array,
    cfg: ModelConfig,
    positions: jax.Array,
    kv_cache: Optional[Tuple[jax.Array, jax.Array]] = None,
    q_offset: Optional[jax.Array] = None,
    dropout_seed: Optional[jax.Array] = None,
) -> Tuple[jax.Array, Optional[Tuple[jax.Array, jax.Array]]]:
    """Self-attention with optional external KV (decode).

    Training: ``kv_cache=None`` -> causal self-attention over x.
    Decode: ``kv_cache=(k_cache, v_cache)`` already containing this step's
    keys/values; ``q_offset`` carries per-sequence lengths.
    ``dropout_seed``: int32 scalar enabling ``cfg.attn_dropout`` for this
    call (training passes one per layer per step; serving passes None).
    """
    dt = cfg.dtype
    h = rms_norm(x, layer["attn_norm"])
    q = _split_heads(h @ weight(layer["wq"], dt), cfg.n_heads, cfg.head_dim)
    k = _split_heads(h @ weight(layer["wk"], dt), cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(h @ weight(layer["wv"], dt), cfg.n_kv_heads, cfg.head_dim)
    q = _maybe_rope(q, positions, cfg)
    k = _maybe_rope(k, positions, cfg)

    new_kv = (k, v)
    if kv_cache is not None:
        k, v = kv_cache
    use_dropout = cfg.attn_dropout > 0.0 and dropout_seed is not None
    o = flash_attention(
        q,
        k,
        v,
        q_offset=q_offset,
        causal=True,
        window=cfg.attn_window,
        sinks=cfg.attn_sinks,
        softcap=cfg.attn_softcap,
        alibi_slopes=alibi_slopes(cfg.n_heads) if cfg.attn_alibi else None,
        block_sizes=cfg.block_sizes,
        dropout_rate=cfg.attn_dropout if use_dropout else 0.0,
        dropout_seed=dropout_seed if use_dropout else None,
        impl=cfg.attn_impl,
    )
    out = _merge_heads(o) @ weight(layer["wo"], dt)
    return x + out, new_kv


def mlp_block(layer: Params, x: jax.Array, cfg: ModelConfig) -> jax.Array:
    if "w_router" in layer:
        # MoE layer (models/moe.py params): drop-free routed MLP, so the
        # whole serving stack (forward / prefill / decode) serves MoE
        # models through this one hook.  Late import breaks the cycle.
        from .moe import moe_mlp_dense

        return moe_mlp_dense(layer, x, cfg)
    dt = cfg.dtype
    h = rms_norm(x, layer["mlp_norm"])
    gate = jax.nn.silu(h @ weight(layer["w_gate"], dt))
    up = h @ weight(layer["w_up"], dt)
    return x + (gate * up) @ weight(layer["w_down"], dt)


def forward_hidden(
    params: Params,
    tokens: jax.Array,
    cfg: ModelConfig,
    *,
    positions: Optional[jax.Array] = None,
    remat: bool = True,
    dropout_key: Optional[jax.Array] = None,
) -> jax.Array:
    """Transformer stack up to the final norm: ``[B, N, d]`` hidden.

    The pre-``lm_head`` activations — consumed by :func:`forward` and by
    the blockwise cross-entropy (``models/losses.py``), which never
    materializes full logits.
    """
    if positions is None:
        positions = jnp.broadcast_to(
            jnp.arange(tokens.shape[1]), tokens.shape
        )
    x = params["embed"][tokens].astype(cfg.dtype)

    seeds = None
    if dropout_key is not None and cfg.attn_dropout > 0.0:
        # One traced int32 seed per layer per step; the kernel hash does
        # the per-(head, position) diversification.
        seeds = jax.random.randint(
            dropout_key, (cfg.n_layers,), 0, jnp.iinfo(jnp.int32).max,
            dtype=jnp.int32,
        )

    def block(x, layer, seed):
        x, _ = attention_block(layer, x, cfg, positions, dropout_seed=seed)
        return mlp_block(layer, x, cfg)

    if remat:
        block = jax.checkpoint(block)
    for i, layer in enumerate(params["layers"]):
        x = block(x, layer, None if seeds is None else seeds[i])
    return rms_norm(x, params["final_norm"])


def forward(
    params: Params,
    tokens: jax.Array,
    cfg: ModelConfig,
    *,
    positions: Optional[jax.Array] = None,
    remat: bool = True,
    dropout_key: Optional[jax.Array] = None,
) -> jax.Array:
    """Training/prefill forward: ``[B, N]`` tokens -> ``[B, N, V]`` logits.

    ``dropout_key``: PRNG key enabling ``cfg.attn_dropout`` for this call
    (train mode); None (the default) runs deterministically (eval/serve).
    """
    x = forward_hidden(
        params,
        tokens,
        cfg,
        positions=positions,
        remat=remat,
        dropout_key=dropout_key,
    )
    return (x @ weight(params["lm_head"], cfg.dtype)).astype(jnp.float32)


def loss_fn(
    params: Params,
    tokens: jax.Array,
    cfg: ModelConfig,
    dropout_key: Optional[jax.Array] = None,
) -> jax.Array:
    """Next-token cross entropy over ``[B, N]`` tokens."""
    logits = forward(params, tokens, cfg, dropout_key=dropout_key)
    targets = tokens[:, 1:]
    logits = logits[:, :-1]
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
    return jnp.mean(nll)


def sgd_train_step(
    params: Params, tokens: jax.Array, cfg: ModelConfig, lr: float = 1e-3
) -> Tuple[Params, jax.Array]:
    """One SGD step (optax-free core; the trainer wraps optax around this)."""
    loss, grads = jax.value_and_grad(loss_fn)(params, tokens, cfg)
    params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
    return params, loss


# ---------------------------------------------------------------------------
# Sharding rules (tensor-parallel over heads/ffn, data-parallel over batch).
# ---------------------------------------------------------------------------


def param_shardings(mesh: Mesh, cfg: ModelConfig) -> Params:
    """NamedShardings: TP shards attention heads and the FFN width."""
    tp = "tp"

    def s(*spec):
        return NamedSharding(mesh, P(*spec))

    layer = {
        "attn_norm": s(None),
        "wq": s(None, tp),
        "wk": s(None, tp),
        "wv": s(None, tp),
        "wo": s(tp, None),
        "mlp_norm": s(None),
        "w_gate": s(None, tp),
        "w_up": s(None, tp),
        "w_down": s(tp, None),
    }
    return {
        "embed": s(None, None),
        "layers": [dict(layer) for _ in range(cfg.n_layers)],
        "final_norm": s(None),
        "lm_head": s(None, tp),
    }


def data_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("dp", None))
