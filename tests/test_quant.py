"""Quantized-KV kernel vs the fp32 oracle (BASELINE.json quant scheme)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_metal_tpu.kernels.quant import (
    QuantizedKV,
    dequantize_kv,
    flash_attention_quant,
    quantize_kv,
)
from flash_attention_metal_tpu.reference import attention_reference, make_qkv



def max_abs_diff(a, b):
    return float(jnp.max(jnp.abs(a.astype(jnp.float32) - b.astype(jnp.float32))))


@pytest.mark.parametrize("dtype", [jnp.int8, jnp.float8_e4m3fn])
def test_quantize_roundtrip(rng_key, dtype):
    _, k, v = make_qkv(rng_key, (1, 2, 256, 64))
    qkv = quantize_kv(k, v, dtype=dtype)
    assert qkv.k_q.dtype == jnp.dtype(dtype)
    assert qkv.k_scale.shape == (1, 2, 256)
    k2, v2 = dequantize_kv(qkv, jnp.float32)
    # int8: error <= scale/2 ~ 1/254 per element for uniform(-1,1) inputs.
    # fp8 e4m3: 3 mantissa bits -> ~6% relative error near the scale max.
    tol = 0.02 if dtype == jnp.int8 else 0.08
    assert max_abs_diff(k, k2) < tol
    assert max_abs_diff(v, v2) < tol


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [jnp.int8, jnp.float8_e4m3fn])
def test_quant_attention_vs_oracle(rng_key, causal, dtype):
    q, k, v = make_qkv(rng_key, (1, 2, 256, 64), dtype=jnp.bfloat16)
    qkv = quantize_kv(k, v, dtype=dtype)
    got = flash_attention_quant(q, qkv, causal=causal)
    want = attention_reference(q, k, v, causal=causal)
    # Reference half-precision forward tolerance class (main.mm:452): int8
    # per-token quant of uniform(-1,1) keys lands within ~2e-2; fp8 e4m3's
    # 3-bit mantissa roughly doubles that.
    assert max_abs_diff(got, want) < (3e-2 if dtype == jnp.int8 else 8e-2)
    assert not bool(jnp.any(jnp.isnan(got)))


def test_quant_attention_matches_dequant_path(rng_key):
    """Fused-scale kernel == dequantize-then-flash (tight, same rounding)."""
    q, k, v = make_qkv(rng_key, (1, 2, 256, 64), dtype=jnp.bfloat16)
    qkv = quantize_kv(k, v, dtype=jnp.int8)
    got = flash_attention_quant(q, qkv)
    k2, v2 = dequantize_kv(qkv, jnp.float32)
    want = attention_reference(q, k2, v2)
    assert max_abs_diff(got, want) < 1e-2


def test_quant_lse(rng_key):
    q, k, v = make_qkv(rng_key, (1, 1, 256, 64), dtype=jnp.bfloat16)
    qkv = quantize_kv(k, v, dtype=jnp.int8)
    o, lse = flash_attention_quant(q, qkv, causal=True, save_lse=True)
    assert lse.shape == (1, 1, 256)
    from flash_attention_metal_tpu.reference import attention_reference_with_lse

    _, want_lse = attention_reference_with_lse(q, k, v, causal=True)
    np.testing.assert_allclose(
        np.asarray(lse), np.asarray(want_lse), atol=5e-2
    )


def test_quantized_kv_is_pytree(rng_key):
    _, k, v = make_qkv(rng_key, (1, 1, 128, 64))
    qkv = quantize_kv(k, v)
    leaves = jax.tree_util.tree_leaves(qkv)
    assert len(leaves) == 4
    qkv2 = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(qkv), leaves
    )
    assert isinstance(qkv2, QuantizedKV)


def test_quant_ragged_offsets(rng_key):
    """Per-batch traced q_offset against a quantized cache (decode path)."""
    kq, kk, kv_ = jax.random.split(rng_key, 3)
    n_q, n_kv = 128, 512
    q = jax.random.uniform(kq, (2, 2, n_q, 64), jnp.float32, -1, 1).astype(
        jnp.bfloat16
    )
    k = jax.random.uniform(kk, (2, 2, n_kv, 64), jnp.float32, -1, 1).astype(
        jnp.bfloat16
    )
    v = jax.random.uniform(kv_, (2, 2, n_kv, 64), jnp.float32, -1, 1).astype(
        jnp.bfloat16
    )
    offsets = jnp.asarray([64, 200], jnp.int32)
    qkv = quantize_kv(k, v, dtype=jnp.int8)
    got = flash_attention_quant(
        q, qkv, offsets, causal=True
    )
    kd, vd = dequantize_kv(qkv, jnp.float32)
    want = attention_reference(
        q.astype(jnp.float32), kd, vd, causal=True,
        q_offset=offsets[:, None, None, None],
    )
    assert (
        float(jnp.max(jnp.abs(got.astype(jnp.float32) - want))) < 1e-2
    )


def test_quant_softcap_alibi_vs_dequant_oracle(rng_key):
    """Score transforms on the 8-bit path: kernel == oracle on the
    dequantized KV (same quant rounding both sides, so the tolerance is
    bf16-class, not int8-class)."""
    q, k, v = make_qkv(rng_key, (2, 4, 256, 64), dtype=jnp.bfloat16)
    H = q.shape[1]
    slopes = jnp.asarray(
        [2.0 ** (-8.0 * (i + 1) / H) for i in range(H)], jnp.float32
    )
    qkv = quantize_kv(k, v, dtype=jnp.int8)
    kd, vd = dequantize_kv(qkv, jnp.float32)
    got = flash_attention_quant(
        q, qkv, causal=True, softcap=15.0, alibi_slopes=slopes,
    )
    want = attention_reference(
        q.astype(jnp.float32), kd, vd, causal=True, softcap=15.0,
        alibi_slopes=slopes,
    )
    assert max_abs_diff(got, want) < 2e-2
    assert not bool(jnp.any(jnp.isnan(got)))


@pytest.mark.parametrize("causal", [False, True])
def test_quant_alibi_requires_causal(rng_key, causal):
    """ALiBi on the 8-bit cache matches the oracle on the dequantized
    cache, causal or not (the bias needs no causal structure)."""
    q, k, v = make_qkv(rng_key, (1, 2, 128, 64), dtype=jnp.bfloat16)
    qkv = quantize_kv(k, v)
    slopes = jnp.asarray([0.5, 0.125], jnp.float32)
    got = flash_attention_quant(q, qkv, causal=causal, alibi_slopes=slopes)
    k2, v2 = dequantize_kv(qkv, jnp.float32)
    want = attention_reference(q, k2, v2, causal=causal, alibi_slopes=slopes)
    assert max_abs_diff(got, want) < 1e-2
