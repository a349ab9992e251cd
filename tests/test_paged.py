"""Paged KV cache (vLLM-style pooled pages) — kernel, allocator, engine.

Verification model: physical placement must be invisible.  A slot's
attention output through a scrambled page table must match the dense
contiguous computation on the same logical tokens, and the paged engine
must generate the same tokens as the dense-cache engine.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_metal_tpu.config import BlockSizes
from flash_attention_metal_tpu.kernels.flash_fwd import flash_attention_fwd
from flash_attention_metal_tpu.kernels.paged import flash_attention_paged
from flash_attention_metal_tpu.models import ModelConfig, init_params
from flash_attention_metal_tpu.runtime import DecodeEngine, Request
from flash_attention_metal_tpu.runtime.paged_kv import (
    PageAllocator,
    append_tokens_paged,
    gather_slot_kv,
    init_paged_cache,
)

PS = 128  # page size


def _scrambled_pool(key, batch, kv_heads, n_kv, head_dim, dtype):
    """Dense K/V plus a pool holding the same tokens at scrambled
    physical pages (page 0 reserved)."""
    kk, kv_, kp = jax.random.split(key, 3)
    k = jax.random.normal(kk, (batch, kv_heads, n_kv, head_dim), dtype)
    v = jax.random.normal(kv_, (batch, kv_heads, n_kv, head_dim), dtype)
    pages_per = n_kv // PS
    n_pages = 1 + batch * pages_per
    perm = np.asarray(
        jax.random.permutation(kp, np.arange(1, n_pages))
    ).reshape(batch, pages_per)
    pool_k = jnp.zeros((n_pages, kv_heads, PS, head_dim), dtype)
    pool_v = jnp.zeros_like(pool_k)
    for b in range(batch):
        for lp in range(pages_per):
            blk_k = k[b, :, lp * PS : (lp + 1) * PS]
            blk_v = v[b, :, lp * PS : (lp + 1) * PS]
            pool_k = pool_k.at[perm[b, lp]].set(blk_k)
            pool_v = pool_v.at[perm[b, lp]].set(blk_v)
    return k, v, pool_k, pool_v, jnp.asarray(perm, jnp.int32)


@pytest.mark.parametrize("t_new", [1, 128])
def test_paged_kernel_matches_dense(t_new):
    """Attention through a scrambled page table == dense contiguous."""
    batch, heads, kv_heads, n_kv, d = 2, 4, 2, 512, 64
    key = jax.random.PRNGKey(0)
    k, v, pool_k, pool_v, table = _scrambled_pool(
        key, batch, kv_heads, n_kv, d, jnp.float32
    )
    q = jax.random.normal(
        jax.random.PRNGKey(1), (batch, heads, t_new, d), jnp.float32
    )
    lengths = jnp.asarray([n_kv - t_new, 3 * PS - t_new], jnp.int32)

    got = flash_attention_paged(
        q, pool_k, pool_v, table, lengths
    )
    want = flash_attention_fwd(
        q,
        k,
        v,
        q_offset=lengths,
        causal=True,
        block_sizes=BlockSizes(block_q=128, block_k=PS),
    )
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def test_paged_append_roundtrip():
    """append_tokens_paged lands tokens at the right logical positions."""
    cache = init_paged_cache(
        2, 2, 2, 4 * PS, 64, n_pages=9, page_size=PS, dtype=jnp.float32
    )
    alloc = PageAllocator(9, 2)
    cache = alloc.grow(cache, 0, 2 * PS)
    cache = alloc.grow(cache, 1, PS)
    # Slot 0 starts at length 100 (mid-page), slot 1 at 0.
    cache = dataclasses.replace(
        cache, lengths=jnp.asarray([100, 0], jnp.int32)
    )
    k_new = jax.random.normal(jax.random.PRNGKey(2), (2, 2, 7, 64))
    v_new = jax.random.normal(jax.random.PRNGKey(3), (2, 2, 7, 64))
    for layer in range(2):
        cache = append_tokens_paged(cache, layer, k_new, v_new)
    dk, dv = gather_slot_kv(cache, 1, 0)  # layer 1, slot 0
    np.testing.assert_allclose(dk[:, 100:107], k_new[0], atol=0)
    np.testing.assert_allclose(dv[:, 100:107], v_new[0], atol=0)
    dk1, _ = gather_slot_kv(cache, 0, 1)
    np.testing.assert_allclose(dk1[:, 0:7], k_new[1], atol=0)


def test_allocator_bookkeeping():
    alloc = PageAllocator(8, 2)  # 7 usable pages
    assert alloc.free_pages == 7
    assert alloc.can_reserve(7) and not alloc.can_reserve(8)
    alloc.reserve(0, 4)
    assert alloc.can_reserve(3) and not alloc.can_reserve(4)
    cache = init_paged_cache(
        1, 2, 2, 8 * PS, 64, n_pages=8, page_size=PS
    )
    cache = alloc.grow(cache, 0, 4 * PS)
    assert alloc.pages_of(0) == 4 and alloc.free_pages == 3
    assert int(cache.page_table[0, 0]) != 0  # page 0 never granted
    granted = set(np.asarray(cache.page_table[0, :4]))
    cache = alloc.release(cache, 0)
    assert alloc.free_pages == 7 and alloc.can_reserve(7)
    assert not np.any(np.asarray(cache.page_table[0]))
    assert int(cache.lengths[0]) == 0
    # Released pages are re-grantable.
    alloc.reserve(1, 7)
    cache = alloc.grow(cache, 1, 7 * PS)
    assert granted <= set(np.asarray(cache.page_table[1, :7]))


CFG = ModelConfig(
    vocab_size=256,
    d_model=128,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    head_dim=64,
    d_ff=256,
    max_seq_len=256,
    dtype=jnp.float32,
)


@pytest.fixture(scope="module")
def params():
    return init_params(jax.random.PRNGKey(0), CFG)


def _run(params, **engine_kw):
    eng = DecodeEngine(params, CFG, max_batch=2, max_len=256, **engine_kw)
    for uid in range(4):  # more requests than slots -> release + reuse
        eng.submit(
            Request(uid=uid, prompt=[1 + uid, 2, 3], max_new_tokens=5)
        )
    return eng.run()


def test_paged_engine_matches_dense(params):
    out_p = _run(params, paged=True)
    out_d = _run(params)
    assert sorted(out_p.keys()) == [0, 1, 2, 3]
    for uid in out_d:
        assert len(out_p[uid]) == 5
        # fp32 greedy decode: paged (pallas) vs dense (auto impl) may
        # differ only by accumulation order; tokens should agree.
        same = sum(a == b for a, b in zip(out_p[uid], out_d[uid]))
        assert same >= 4, (uid, out_p[uid], out_d[uid])


def test_paged_engine_deterministic(params):
    assert _run(params, paged=True) == _run(params, paged=True)


def test_paged_oversubscribed_pool(params):
    """A pool far smaller than max_batch*max_len still serves correctly:
    admission waits for pages instead of failing."""
    # Each request needs ceil(max(128, 3+5+lag+1)/128) = 1 page with
    # lag=0; a 1-usable-page pool forces fully serial admission.
    out_small = _run(params, paged=True, n_pages=2, harvest_lag=0)
    out_big = _run(params, paged=True, harvest_lag=0)
    assert out_small == out_big


def test_paged_snapshot_restore(params):
    """Crash-restart mid-flight resumes the exact paged generation
    (allocator free-list/ownership round-trips with the cache)."""

    def submit_all(eng):
        for uid in range(3):
            eng.submit(
                Request(uid=uid, prompt=[1 + uid, 2, 3], max_new_tokens=6)
            )

    ref = DecodeEngine(params, CFG, max_batch=2, max_len=256, paged=True)
    submit_all(ref)
    want = ref.run()

    eng = DecodeEngine(params, CFG, max_batch=2, max_len=256, paged=True)
    submit_all(eng)
    for _ in range(4):
        eng.step()
    snap = eng.snapshot()
    finished_before = {uid: r.generated for uid, r in eng.finished.items()}
    del eng

    eng2 = DecodeEngine(params, CFG, max_batch=2, max_len=256, paged=True)
    eng2.restore(snap)
    eng2.finished = {}
    got = eng2.run()
    got.update(finished_before)
    assert got == want


def test_paged_rejects_bad_combos(params):
    cfg_w = dataclasses.replace(CFG, attn_window=32)
    with pytest.raises(ValueError):
        DecodeEngine(
            params, cfg_w, max_batch=2, max_len=256, paged=True, rolling=True
        )
    with pytest.raises(ValueError):
        DecodeEngine(
            params, CFG, max_batch=2, max_len=256, prefix_share=True
        )


# ---------------------------------------------------------------------------
# Prefix sharing (copy-free shared prompt pages + retained registry)
# ---------------------------------------------------------------------------

PREFIX = [7 + (i * 5) % 200 for i in range(150)]  # > 1 full page


def _run_prefix(params, *, share, n_pages=None, max_len=512):
    eng = DecodeEngine(
        params,
        CFG,
        max_batch=2,
        max_len=max_len,
        paged=True,
        prefix_share=share,
        n_pages=n_pages,
    )
    for uid in range(4):
        eng.submit(
            Request(uid=uid, prompt=PREFIX + [uid + 1], max_new_tokens=5)
        )
    return eng, eng.run()


def test_prefix_share_matches_unshared(params):
    """Adopted prefix pages must be generation-invisible."""
    _, out_s = _run_prefix(params, share=True)
    _, out_u = _run_prefix(params, share=False)
    assert out_s == out_u


def test_prefix_share_reuses_physical_pages(params):
    """Co-resident same-prefix slots point at the same physical page,
    and the registry survives slot turnover (retained prefix cache)."""
    eng = DecodeEngine(
        params,
        CFG,
        max_batch=2,
        max_len=512,
        paged=True,
        prefix_share=True,
    )
    eng.submit(Request(uid=0, prompt=PREFIX + [1], max_new_tokens=4))
    eng.submit(Request(uid=1, prompt=PREFIX + [2], max_new_tokens=4))
    eng.step()  # admits both
    table = np.asarray(eng.cache.page_table)
    assert table[0, 0] == table[1, 0] != 0  # shared first page
    assert len(eng._prefix_registry) == 1
    shared_phys = int(table[0, 0])
    eng.run()
    # Both occupants retired; the registry pin keeps the page resident.
    assert len(eng._prefix_registry) == 1
    assert eng._allocator._refs[shared_phys] == 1
    # A later same-prefix request adopts the retained page.
    eng.submit(Request(uid=2, prompt=PREFIX + [3], max_new_tokens=4))
    eng.step()
    table = np.asarray(eng.cache.page_table)
    assert shared_phys in table[:, 0]


def test_prefix_share_eviction_under_pressure(params):
    """A pool too small to retain prefixes evicts the registry instead
    of refusing admission, and stays correct."""
    # 3 usable pages; each request reserves 2 (prompt 151 tokens + tail).
    eng, out_small = _run_prefix(params, share=True, n_pages=4, max_len=256)
    _, out_big = _run_prefix(params, share=True, max_len=256)
    assert out_small == out_big


def test_prefix_share_snapshot_roundtrip(params):
    """Registry + refcounts survive snapshot/restore."""

    def submit_all(eng):
        eng.submit(Request(uid=0, prompt=PREFIX + [1], max_new_tokens=6))
        eng.submit(Request(uid=1, prompt=PREFIX + [2], max_new_tokens=6))

    def fresh():
        return DecodeEngine(
            params,
            CFG,
            max_batch=2,
            max_len=512,
            paged=True,
            prefix_share=True,
        )

    ref = fresh()
    submit_all(ref)
    want = ref.run()

    eng = fresh()
    submit_all(eng)
    for _ in range(3):
        eng.step()
    snap = eng.snapshot()
    finished_before = {uid: r.generated for uid, r in eng.finished.items()}
    del eng

    eng2 = fresh()
    eng2.restore(snap)
    eng2.finished = {}
    got = eng2.run()
    got.update(finished_before)
    assert got == want
    assert len(eng2._prefix_registry) == 1


# ---------------------------------------------------------------------------
# Paged + 8-bit quantized pool (BASELINE config 5 composite)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t_new", [1, 128])
def test_paged_quant_kernel_matches_dense_quant(t_new):
    """8-bit attention through a scrambled page table == dense 8-bit."""
    from flash_attention_metal_tpu.kernels.paged import (
        flash_attention_paged_quant,
    )
    from flash_attention_metal_tpu.kernels.quant import (
        flash_attention_quant,
        quantize_kv,
    )

    batch, heads, kv_heads, n_kv, d = 2, 4, 2, 512, 64
    key = jax.random.PRNGKey(7)
    k, v, _, _, table = _scrambled_pool(
        key, batch, kv_heads, n_kv, d, jnp.float32
    )
    qkv = quantize_kv(k, v, dtype=jnp.int8)
    pages_per = n_kv // PS
    n_pages = 1 + batch * pages_per
    pool_kq = jnp.zeros((n_pages, kv_heads, PS, d), jnp.int8)
    pool_vq = jnp.zeros_like(pool_kq)
    pool_ks = jnp.zeros((n_pages, kv_heads, PS), jnp.float32)
    pool_vs = jnp.zeros_like(pool_ks)
    ks_flat = qkv.k_scale.reshape(batch, kv_heads, n_kv)
    vs_flat = qkv.v_scale.reshape(batch, kv_heads, n_kv)
    for b in range(batch):
        for lp in range(pages_per):
            phys = int(table[b, lp])
            sl = slice(lp * PS, (lp + 1) * PS)
            pool_kq = pool_kq.at[phys].set(qkv.k_q[b, :, sl])
            pool_vq = pool_vq.at[phys].set(qkv.v_q[b, :, sl])
            pool_ks = pool_ks.at[phys].set(ks_flat[b, :, sl])
            pool_vs = pool_vs.at[phys].set(vs_flat[b, :, sl])

    q = jax.random.normal(
        jax.random.PRNGKey(8), (batch, heads, t_new, d), jnp.float32
    )
    lengths = jnp.asarray([n_kv - t_new, 3 * PS - t_new], jnp.int32)
    got = flash_attention_paged_quant(
        q, pool_kq, pool_vq, pool_ks, pool_vs, table, lengths,
    )
    want = flash_attention_quant(
        q, qkv, lengths, causal=True,
        block_sizes=BlockSizes(block_q=128, block_k=PS),
    )
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def test_paged_quant_append_matches_dense_quant_append():
    """Per-token quant at the paged write head == the dense quant cache's
    (same math, different storage)."""
    from flash_attention_metal_tpu.runtime.kv_cache import (
        append_tokens_quant,
        init_quant_cache,
    )
    from flash_attention_metal_tpu.runtime.paged_kv import (
        append_tokens_paged_quant,
        init_paged_quant_cache,
    )

    B, H, D, T = 2, 2, 64, 7
    dense = init_quant_cache(1, B, H, 2 * PS, D, dtype=jnp.int8)
    paged = init_paged_quant_cache(
        1, B, H, 2 * PS, D, n_pages=5, page_size=PS, dtype=jnp.int8
    )
    alloc = PageAllocator(5, B)
    for b in range(B):
        paged = alloc.grow(paged, b, 2 * PS)
    lengths = jnp.asarray([100, 0], jnp.int32)
    dense = dataclasses.replace(dense, lengths=lengths)
    paged = dataclasses.replace(paged, lengths=lengths)
    k_new = jax.random.normal(jax.random.PRNGKey(2), (B, H, T, D))
    v_new = jax.random.normal(jax.random.PRNGKey(3), (B, H, T, D))
    dense = append_tokens_quant(dense, 0, k_new, v_new)
    paged = append_tokens_paged_quant(paged, 0, k_new, v_new)
    for b in range(B):
        start = int(lengths[b])
        table = paged.page_table[b]
        kq = paged.pool_k_q[0][table].transpose(1, 0, 2, 3).reshape(H, -1, D)
        ks = paged.pool_k_scale[0][table].transpose(1, 0, 2).reshape(H, -1)
        sl = slice(start, start + T)
        np.testing.assert_array_equal(
            np.asarray(kq[:, sl]), np.asarray(dense.k_q[0, b, :, sl])
        )
        np.testing.assert_allclose(
            np.asarray(ks[:, sl]), np.asarray(dense.k_scale[0, b, :, sl])
        )


def test_paged_quant_engine_matches_dense_quant(params):
    out_p = _run(params, paged=True, kv_quant="int8")
    out_d = _run(params, kv_quant="int8")
    assert sorted(out_p.keys()) == [0, 1, 2, 3]
    for uid in out_d:
        assert len(out_p[uid]) == 5
        same = sum(a == b for a, b in zip(out_p[uid], out_d[uid]))
        assert same >= 4, (uid, out_p[uid], out_d[uid])


def test_paged_quant_engine_with_prefix_share(params):
    """Prefix sharing composes with the 8-bit pool (shared pages hold
    quantized KV + scales; adoption shares both)."""
    long_prompt = list(range(1, 129)) + [7, 8, 9]

    def run(**kw):
        eng = DecodeEngine(
            params, CFG, max_batch=2, max_len=512, paged=True,
            kv_quant="int8", **kw,
        )
        for uid in range(3):
            eng.submit(
                Request(
                    uid=uid, prompt=long_prompt + [uid], max_new_tokens=4
                )
            )
        return eng.run()

    assert run(prefix_share=True) == run(prefix_share=False)


# ---------------------------------------------------------------------------
# Multi-token dispatch (decode_and_sample_multi)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multi", [2, 4])
def test_multi_step_matches_single_step(params, multi):
    """K decode steps per dispatch: greedy generations identical to the
    one-step engine (same kernels, same chain, coarser dispatch)."""
    out_m = _run(params, multi_step=multi)
    out_1 = _run(params)
    assert out_m == out_1


def test_multi_step_paged_compose(params):
    out = _run(params, paged=True, multi_step=4)
    assert _run(params) == out


def test_multi_step_quant_paged_compose(params):
    out = _run(params, paged=True, kv_quant="int8", multi_step=3)
    want = _run(params, kv_quant="int8")
    for uid in want:
        same = sum(a == b for a, b in zip(out[uid], want[uid]))
        assert same >= 4, (uid, out[uid], want[uid])


def test_multi_step_eos_and_overshoot(params):
    """EOS mid-window: overshoot tokens are discarded, generation stops
    at the same place as the single-step engine."""

    def run(multi):
        eng = DecodeEngine(
            params, CFG, max_batch=2, max_len=256,
            eos_id=7, multi_step=multi, harvest_lag=2,
        )
        for uid in range(3):
            eng.submit(
                Request(uid=uid, prompt=[1 + uid, 2, 3], max_new_tokens=40)
            )
        return eng.run()

    assert run(4) == run(1)


# ---------------------------------------------------------------------------
# Score transforms (softcap / ALiBi) through the page-table indirection
# ---------------------------------------------------------------------------


def test_paged_kernel_transforms_match_dense():
    """softcap+ALiBi through a scrambled page table == dense kernel:
    ALiBi distance is logical-position distance, so physical placement
    must never enter the scores."""
    batch, heads, kv_heads, n_kv, d = 2, 4, 2, 512, 64
    k, v, pool_k, pool_v, table = _scrambled_pool(
        jax.random.PRNGKey(11), batch, kv_heads, n_kv, d, jnp.float32
    )
    q = jax.random.normal(
        jax.random.PRNGKey(12), (batch, heads, 128, d), jnp.float32
    )
    slopes = jnp.asarray(
        [2.0 ** (-8.0 * (i + 1) / heads) for i in range(heads)], jnp.float32
    )
    lengths = jnp.asarray([n_kv - 128, 3 * PS - 128], jnp.int32)
    got = flash_attention_paged(
        q, pool_k, pool_v, table, lengths, softcap=20.0,
        alibi_slopes=slopes,
    )
    want = flash_attention_fwd(
        q, k, v, q_offset=lengths, causal=True, softcap=20.0,
        alibi_slopes=slopes,
        block_sizes=BlockSizes(block_q=128, block_k=PS),
    )
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def test_paged_quant_kernel_transforms_match_dense_quant():
    """softcap+ALiBi on the 8-bit paged pool == dense 8-bit kernel."""
    from flash_attention_metal_tpu.kernels.paged import (
        flash_attention_paged_quant,
    )
    from flash_attention_metal_tpu.kernels.quant import (
        flash_attention_quant,
        quantize_kv,
    )

    batch, heads, kv_heads, n_kv, d = 2, 4, 2, 512, 64
    k, v, _, _, table = _scrambled_pool(
        jax.random.PRNGKey(13), batch, kv_heads, n_kv, d, jnp.float32
    )
    qkv = quantize_kv(k, v, dtype=jnp.int8)
    pages_per = n_kv // PS
    n_pages = 1 + batch * pages_per
    pool_kq = jnp.zeros((n_pages, kv_heads, PS, d), jnp.int8)
    pool_vq = jnp.zeros_like(pool_kq)
    pool_ks = jnp.zeros((n_pages, kv_heads, PS), jnp.float32)
    pool_vs = jnp.zeros_like(pool_ks)
    ks_flat = qkv.k_scale.reshape(batch, kv_heads, n_kv)
    vs_flat = qkv.v_scale.reshape(batch, kv_heads, n_kv)
    for b in range(batch):
        for lp in range(pages_per):
            phys = int(table[b, lp])
            sl = slice(lp * PS, (lp + 1) * PS)
            pool_kq = pool_kq.at[phys].set(qkv.k_q[b, :, sl])
            pool_vq = pool_vq.at[phys].set(qkv.v_q[b, :, sl])
            pool_ks = pool_ks.at[phys].set(ks_flat[b, :, sl])
            pool_vs = pool_vs.at[phys].set(vs_flat[b, :, sl])
    q = jax.random.normal(
        jax.random.PRNGKey(14), (batch, heads, 1, d), jnp.float32
    )
    slopes = jnp.asarray(
        [2.0 ** (-8.0 * (i + 1) / heads) for i in range(heads)], jnp.float32
    )
    lengths = jnp.asarray([n_kv - 1, 3 * PS - 1], jnp.int32)
    got = flash_attention_paged_quant(
        q, pool_kq, pool_vq, pool_ks, pool_vs, table, lengths,
        softcap=20.0, alibi_slopes=slopes,
    )
    want = flash_attention_quant(
        q, qkv, lengths, causal=True, softcap=20.0, alibi_slopes=slopes,
        block_sizes=BlockSizes(block_q=128, block_k=PS),
    )
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


CFG_TRANSFORM_SERVE = dataclasses.replace(
    CFG, attn_softcap=30.0, attn_alibi=True
)


@pytest.fixture(scope="module")
def params_transform():
    return init_params(jax.random.PRNGKey(0), CFG_TRANSFORM_SERVE)


def _run_transform(params, **engine_kw):
    eng = DecodeEngine(
        params, CFG_TRANSFORM_SERVE, max_batch=2, max_len=256, **engine_kw
    )
    for uid in range(3):
        eng.submit(Request(uid=uid, prompt=[1 + uid, 2, 3], max_new_tokens=5))
    return eng.run()


@pytest.mark.parametrize(
    "kw_x, kw_ref",
    [
        (dict(paged=True), dict()),
        (dict(paged=True, kv_quant="int8"), dict(kv_quant="int8")),
    ],
    ids=["paged-vs-dense", "paged-int8-vs-dense-int8"],
)
def test_transform_engine_matches_dense(params_transform, kw_x, kw_ref):
    """A softcap+ALiBi model serves identically through the page-table
    indirection (vs the same-precision dense engine, token-for-token
    modulo the usual accumulation-order flips).  Same-precision pairs
    only: int8-vs-fp32 greedy decode on a random model flips argmax on
    near-uniform logits and diverges by construction."""
    out_x = _run_transform(params_transform, **kw_x)
    out_d = _run_transform(params_transform, **kw_ref)
    assert sorted(out_x.keys()) == [0, 1, 2]
    for uid in out_d:
        assert len(out_x[uid]) == 5
        same = sum(a == b for a, b in zip(out_x[uid], out_d[uid]))
        assert same >= 4, (uid, out_x[uid], out_d[uid])


def test_transform_engine_int8_deterministic(params_transform):
    """The 8-bit transform path itself is deterministic slot-to-slot."""
    assert _run_transform(params_transform, kv_quant="int8") == _run_transform(
        params_transform, kv_quant="int8"
    )
