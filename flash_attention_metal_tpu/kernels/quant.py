"""Quantized-KV flash attention (int8 / fp8 KV cache).

The reference's lowest-precision path is fp16 storage with fp32 statistics
(V4, ``kernels.metal:597-883``); BASELINE.json's quant scheme extends that
one step further: **fp8/int8 KV cache with per-token scales**, halving
(vs bf16) the bytes that bandwidth-bound decode reads, while the dots run
in the query's dtype with fp32 softmax statistics.

Scheme (symmetric, per-token, absmax):

* ``k_q[t] = round(k[t] / s_k[t])`` with ``s_k[t] = absmax(k[t]) / QMAX``
* scales fold back in *outside* the dots, inside the forward kernel
  (``flash_fwd._fwd_kernel``): ``S[:, t] = (q . k_q[t]) * s_k[t]`` on the
  score columns and ``O += (P * s_v)[., t] v_q[t]`` on the probabilities,
  so the 8-bit tiles are converted in registers after the load and
  never rescaled.
* scales are stored per token, ``[B, H, N]`` fp32.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp

from ..config import BlockSizes
from .flash_fwd import attention_fwd


_QMAX = {
    jnp.int8.dtype: 127.0,
    jnp.float8_e4m3fn.dtype: 448.0,
    jnp.float8_e5m2.dtype: 57344.0,
}


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class QuantizedKV:
    """A quantized KV pair with per-token scales."""

    k_q: jax.Array  # [B, H, N, D] int8/fp8
    v_q: jax.Array  # [B, H, N, D] int8/fp8
    k_scale: jax.Array  # [B, H, N] fp32
    v_scale: jax.Array  # [B, H, N] fp32

    def tree_flatten(self):
        return (self.k_q, self.v_q, self.k_scale, self.v_scale), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def seq_len(self) -> int:
        return self.k_q.shape[2]


def quantize_tokens(x: jax.Array, dtype) -> Tuple[jax.Array, jax.Array]:
    """Symmetric per-token absmax quantization of ``[..., D]`` rows.

    Returns the 8-bit values and the fp32 scales ``[...]``.
    """
    qmax = _QMAX[jnp.dtype(dtype)]
    xf = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
    scale = jnp.maximum(amax, 1e-12) / qmax
    if jnp.dtype(dtype) == jnp.int8.dtype:
        xq = jnp.clip(jnp.round(xf / scale), -qmax, qmax).astype(dtype)
    else:
        xq = (xf / scale).astype(dtype)
    return xq, scale[..., 0]


@functools.partial(jax.jit, static_argnames=("dtype",))
def quantize_kv(k: jax.Array, v: jax.Array, dtype=jnp.int8) -> QuantizedKV:
    """Symmetric per-token absmax quantization of a KV pair."""
    k_q, k_scale = quantize_tokens(k, dtype)
    v_q, v_scale = quantize_tokens(v, dtype)
    return QuantizedKV(k_q, v_q, k_scale, v_scale)


def dequantize_kv(qkv: QuantizedKV, dtype=jnp.bfloat16):
    """Reference dequantization (for testing)."""

    def dq(xq, scales):
        return (xq.astype(jnp.float32) * scales[..., None]).astype(dtype)

    return dq(qkv.k_q, qkv.k_scale), dq(qkv.v_q, qkv.v_scale)


@functools.partial(
    jax.jit,
    static_argnames=(
        "sm_scale",
        "causal",
        "window",
        "sinks",
        "block_sizes",
        "save_lse",
        "softcap",
        "pos_div",
    ),
)
def flash_attention_quant(
    q: jax.Array,
    qkv: QuantizedKV,
    q_offset=None,
    kv_positions: Optional[jax.Array] = None,
    *,
    sm_scale: Optional[float] = None,
    causal: bool = False,
    window: Optional[int] = None,
    sinks: int = 0,
    block_sizes: Optional[BlockSizes] = None,
    save_lse: bool = False,
    softcap: Optional[float] = None,
    alibi_slopes: Optional[jax.Array] = None,
    pos_div: int = 1,
) -> Union[jax.Array, Tuple[jax.Array, jax.Array]]:
    """Flash attention against an int8/fp8 KV cache.

    ``q``: ``[B, H, N_q, D]`` bf16/fp16/fp32; returns ``o`` (and the
    ``[B, H, N_q]`` LSE when requested), with ``flash_attention_fwd``'s
    semantics for ``q_offset``, ``kv_positions``, ``window``/``sinks``,
    ``softcap``, ``alibi_slopes`` and ``pos_div`` (the GQA decode
    head-fold).  GQA is native: the cache keeps its KV head count.
    """
    return attention_fwd(
        q, qkv.k_q, qkv.v_q, q_offset,
        k_scale=qkv.k_scale, v_scale=qkv.v_scale,
        kv_positions=kv_positions, sm_scale=sm_scale, causal=causal,
        window=window, sinks=sinks, block_sizes=block_sizes,
        save_lse=save_lse, softcap=softcap, alibi_slopes=alibi_slopes,
        pos_div=pos_div,
    )
