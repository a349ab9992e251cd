"""GQA decode head-fold tests (``ops.gqa_decode_attention``).

The fold packs each KV head's ``group`` query heads into adjacent rows
(kernel ``pos_div``), reading the KV cache once per KV head instead of
once per q-head.  These tests pin exactness vs the unfolded kernel
across mask variants.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_metal_tpu.config import BlockSizes
from flash_attention_metal_tpu.kernels.paged import (
    flash_attention_paged,
    flash_attention_paged_quant,
)
from flash_attention_metal_tpu.kernels.quant import (
    flash_attention_quant,
    quantize_kv,
)
from flash_attention_metal_tpu.ops.attention import (
    flash_attention,
    fold_gqa_rows,
    gqa_decode_attention,
    unfold_gqa_rows,
)
from flash_attention_metal_tpu.reference import make_qkv


def _fixtures(hq, hkv, t, n=1024, b=2):
    q, _, _ = make_qkv(jax.random.PRNGKey(0), (b, hq, t, 64))
    _, k, v = make_qkv(jax.random.PRNGKey(1), (b, hkv, n, 64))
    lengths = jnp.asarray([n // 2 - 3, n - 1][:b], jnp.int32)
    return q, k, v, lengths


@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("hq,hkv", [(8, 2), (8, 1), (4, 4)])
def test_fold_matches_unfolded(hq, hkv, t):
    q, k, v, lengths = _fixtures(hq, hkv, t)
    ref = flash_attention(q, k, v, q_offset=lengths, causal=True)
    got = gqa_decode_attention(q, k, v, lengths)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5)


def test_fold_window_sinks_softcap():
    q, k, v, lengths = _fixtures(8, 2, 4)
    kw = dict(window=256, sinks=4, softcap=20.0)
    ref = flash_attention(q, k, v, q_offset=lengths, causal=True, **kw)
    got = gqa_decode_attention(q, k, v, lengths, **kw)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5)


def test_fold_save_lse():
    q, k, v, lengths = _fixtures(8, 2, 2)
    r_o, r_l = flash_attention(
        q, k, v, q_offset=lengths, causal=True, save_lse=True
    )
    g_o, g_l = gqa_decode_attention(q, k, v, lengths, save_lse=True)
    np.testing.assert_allclose(np.asarray(g_o), np.asarray(r_o), atol=1e-5)
    np.testing.assert_allclose(np.asarray(g_l), np.asarray(r_l), atol=1e-5)


# ---------------------------------------------------------------------------
# Fold on the quantized and paged kernels (runtime/decode.py wires these)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize(
    "kw", [dict(), dict(window=256, sinks=4, softcap=20.0)]
)
def test_fold_quant_matches_unfolded(t, kw):
    hq, hkv = 8, 2
    group = hq // hkv
    q, k, v, lengths = _fixtures(hq, hkv, t, n=512)
    qkv = quantize_kv(k, v, dtype=jnp.int8)
    ref = flash_attention_quant(
        q, qkv, lengths, causal=True, **kw
    )
    got = flash_attention_quant(
        fold_gqa_rows(q, hkv), qkv, lengths, causal=True,
        pos_div=group, **kw,
    )
    got = unfold_gqa_rows(got, hq, t)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5)


def _contiguous_pool(k, v, ps=128):
    """[B, Hkv, N, D] dense KV -> pool + page table (page 0 reserved)."""
    b, hkv, n, d = k.shape
    pages_per = n // ps
    pool_k = jnp.concatenate(
        [jnp.zeros((1, hkv, ps, d), k.dtype)]
        + [
            k[i, :, p * ps : (p + 1) * ps][None]
            for i in range(b)
            for p in range(pages_per)
        ]
    )
    pool_v = jnp.concatenate(
        [jnp.zeros((1, hkv, ps, d), v.dtype)]
        + [
            v[i, :, p * ps : (p + 1) * ps][None]
            for i in range(b)
            for p in range(pages_per)
        ]
    )
    table = 1 + jnp.arange(b * pages_per, dtype=jnp.int32).reshape(
        b, pages_per
    )
    return pool_k, pool_v, table


@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("kw", [dict(), dict(window=256)])
def test_fold_paged_matches_unfolded(t, kw):
    hq, hkv = 8, 2
    group = hq // hkv
    q, k, v, lengths = _fixtures(hq, hkv, t, n=512)
    pool_k, pool_v, table = _contiguous_pool(k, v)
    ref = flash_attention_paged(
        q, pool_k, pool_v, table, lengths, **kw
    )
    got = flash_attention_paged(
        fold_gqa_rows(q, hkv), pool_k, pool_v, table, lengths,
        pos_div=group, **kw,
    )
    got = unfold_gqa_rows(got, hq, t)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5)


def test_fold_paged_quant_matches_unfolded():
    hq, hkv, t, ps = 8, 2, 2, 128
    group = hq // hkv
    q, k, v, lengths = _fixtures(hq, hkv, t, n=512)
    qkv = quantize_kv(k, v, dtype=jnp.int8)
    b, _, n, d = k.shape
    pool_kq, pool_vq, table = _contiguous_pool(qkv.k_q, qkv.v_q, ps)
    ks = qkv.k_scale.reshape(b, hkv, n)
    vs = qkv.v_scale.reshape(b, hkv, n)
    pool_ks = jnp.concatenate(
        [jnp.zeros((1, hkv, ps), jnp.float32)]
        + [
            ks[i, :, p * ps : (p + 1) * ps][None]
            for i in range(b)
            for p in range(n // ps)
        ]
    )
    pool_vs = jnp.concatenate(
        [jnp.zeros((1, hkv, ps), jnp.float32)]
        + [
            vs[i, :, p * ps : (p + 1) * ps][None]
            for i in range(b)
            for p in range(n // ps)
        ]
    )
    ref = flash_attention_paged_quant(
        q, pool_kq, pool_vq, pool_ks, pool_vs, table, lengths,
    )
    got = flash_attention_paged_quant(
        fold_gqa_rows(q, hkv), pool_kq, pool_vq, pool_ks, pool_vs, table,
        lengths, pos_div=group,
    )
    got = unfold_gqa_rows(got, hq, t)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=2e-5)


def test_fold_rejects_bad_compositions():
    q, k, v, lengths = _fixtures(8, 2, 1)
    from flash_attention_metal_tpu.kernels.flash_fwd import (
        flash_attention_fwd,
    )

    with pytest.raises((ValueError, NotImplementedError)):
        flash_attention_fwd(
            q.reshape(2, 2, 4, 64), k, v, lengths, causal=False, pos_div=4
        )
    with pytest.raises((ValueError, NotImplementedError)):
        flash_attention_fwd(
            q.reshape(2, 2, 4, 64), k, v, lengths, causal=True, pos_div=4,
            dropout_rate=0.1, dropout_seed=jnp.int32(0),
        )
