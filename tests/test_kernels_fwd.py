"""Forward kernel vs the golden oracle.

Mirrors the reference's verification ladder and tolerances (SURVEY.md §2
H4): fp32 at 1e-3 (main.mm:239,253,292), half precision at 1e-2
(main.mm:452,591).  The Triton-route kernel runs in Pallas interpret mode
on the CPU backend; the same code compiles for the GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_metal_tpu.config import BlockSizes
from flash_attention_metal_tpu.kernels import flash_attention_fwd
from flash_attention_metal_tpu.reference import (
    attention_reference,
    attention_reference_with_lse,
    make_qkv,
)

# Reference tolerance ladder.
TOL_FP32 = 1e-3
TOL_HALF = 1e-2


def max_abs_diff(a, b):
    return float(jnp.max(jnp.abs(a.astype(jnp.float32) - b.astype(jnp.float32))))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize(
    "blocks",
    [
        BlockSizes(block_q=16, block_k=16),
        BlockSizes(block_q=64, block_k=32),
        BlockSizes(block_q=32, block_k=128),
        BlockSizes(block_q=256, block_k=256),
    ],
)
def test_block_size_sweep(rng_key, causal, blocks):
    """Any power-of-two tile pair gives the oracle's answer (one query
    block per program, a loop over KV blocks)."""
    q, k, v = make_qkv(rng_key, (1, 2, 256, 64))
    got = flash_attention_fwd(q, k, v, causal=causal, block_sizes=blocks)
    want = attention_reference(q, k, v, causal=causal)
    assert max_abs_diff(got, want) < TOL_FP32
    assert not bool(jnp.any(jnp.isnan(got)))


@pytest.mark.parametrize("shape", [(1, 2, 100, 40), (2, 3, 77, 24), (1, 1, 1, 8)])
@pytest.mark.parametrize("causal", [False, True])
def test_unaligned_shapes_padded(rng_key, shape, causal):
    """Sequence lengths that are not a multiple of the tile, and head
    dims that are not a power of two, are padded and masked."""
    q, k, v = make_qkv(rng_key, shape)
    o, lse = flash_attention_fwd(q, k, v, causal=causal, save_lse=True)
    want_o, want_lse = attention_reference_with_lse(q, k, v, causal=causal)
    assert o.shape == q.shape and lse.shape == q.shape[:3]
    assert max_abs_diff(o, want_o) < TOL_FP32
    assert max_abs_diff(lse, want_lse) < TOL_FP32


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_mxu_half_precision(rng_key, dtype, causal):
    """Half-precision inputs compute natively (no fp32 upcast) with fp32
    softmax statistics and output in the input dtype."""
    q, k, v = make_qkv(rng_key, (2, 4, 256, 64), dtype=dtype)
    got = flash_attention_fwd(q, k, v, causal=causal)
    want = attention_reference(q, k, v, causal=causal)
    assert got.dtype == dtype
    assert max_abs_diff(got, want) < TOL_HALF


def test_flash_mxu_lse(rng_key):
    q, k, v = make_qkv(rng_key, (1, 2, 256, 64))
    o, lse = flash_attention_fwd(q, k, v, save_lse=True)
    _, want_lse = attention_reference_with_lse(q, k, v)
    assert lse.shape == (1, 2, 256) and lse.dtype == jnp.float32
    np.testing.assert_allclose(
        np.asarray(lse), np.asarray(want_lse), atol=1e-3
    )


def test_flash_mxu_causal_lse(rng_key):
    q, k, v = make_qkv(rng_key, (1, 1, 256, 64))
    o, lse = flash_attention_fwd(q, k, v, causal=True, save_lse=True)
    want_o, want_lse = attention_reference_with_lse(q, k, v, causal=True)
    assert max_abs_diff(o, want_o) < TOL_FP32
    np.testing.assert_allclose(
        np.asarray(lse), np.asarray(want_lse), atol=1e-3
    )


def test_head_dim_128(rng_key):
    q, k, v = make_qkv(rng_key, (1, 2, 256, 128))
    got = flash_attention_fwd(q, k, v)
    want = attention_reference(q, k, v)
    assert max_abs_diff(got, want) < TOL_FP32


def test_cross_attention_lengths(rng_key):
    kq, kk, kv2 = jax.random.split(rng_key, 3)
    q = jax.random.uniform(kq, (1, 2, 128, 64), jnp.float32, -1, 1)
    k = jax.random.uniform(kk, (1, 2, 512, 64), jnp.float32, -1, 1)
    v = jax.random.uniform(kv2, (1, 2, 512, 64), jnp.float32, -1, 1)
    got = flash_attention_fwd(q, k, v)
    want = attention_reference(q, k, v)
    assert max_abs_diff(got, want) < TOL_FP32


def test_eager_softmax_extreme_magnitudes(rng_key):
    """The online softmax is exact for arbitrary score magnitudes: scores
    here jump ~+700 nats between KV blocks."""
    n, bq = 512, 128
    q, k, v = make_qkv(rng_key, (1, 1, n, 64))
    k = k.at[:, :, 384:, :].multiply(60.0)
    bs = BlockSizes(block_q=bq, block_k=bq)
    got = flash_attention_fwd(q, k, v, block_sizes=bs)
    want = attention_reference(q, k, v)
    assert max_abs_diff(got, want) < TOL_FP32


def test_eager_softmax_all_negative_extreme(rng_key):
    """Rows whose max score sits far below zero (~-750 nats) stay exact."""
    n, bq = 512, 128
    q, k, v = make_qkv(rng_key, (1, 1, n, 64))
    q = q - 8.0  # scores ~ -750..-550 nats: outside the lazy envelope
    k = k + 8.0
    bs = BlockSizes(block_q=bq, block_k=bq)
    got = flash_attention_fwd(q, k, v, block_sizes=bs)
    want = attention_reference(q, k, v)
    assert max_abs_diff(got, want) < TOL_FP32


@pytest.mark.parametrize("window", [64, 200, 512])
def test_sliding_window_vs_oracle(rng_key, window):
    n = 512
    q, k, v = make_qkv(rng_key, (1, 2, n, 64))
    bs = BlockSizes(block_q=64, block_k=64)
    got = flash_attention_fwd(
        q, k, v, causal=True, window=window, block_sizes=bs,
    )
    want = attention_reference(q, k, v, causal=True, window=window)
    assert max_abs_diff(got, want) < TOL_FP32


def test_sliding_window_with_offset(rng_key):
    """Decode shape: short q against a long cache, windowed."""
    kq, kk, kv2 = jax.random.split(rng_key, 3)
    q = jax.random.uniform(kq, (2, 2, 128, 64), jnp.float32, -1, 1)
    k = jax.random.uniform(kk, (2, 2, 512, 64), jnp.float32, -1, 1)
    v = jax.random.uniform(kv2, (2, 2, 512, 64), jnp.float32, -1, 1)
    offsets = jnp.asarray([256, 380], jnp.int32)
    bs = BlockSizes(block_q=64, block_k=64)
    got = flash_attention_fwd(
        q, k, v, offsets, causal=True, window=100, block_sizes=bs,
    )
    want = attention_reference(
        q, k, v, causal=True, window=100,
        q_offset=offsets[:, None, None, None],
    )
    assert max_abs_diff(got, want) < TOL_FP32


def _packed_segments(n):
    """Three packed docs of uneven lengths."""
    a, b = int(n * 0.4), int(n * 0.4)
    seg = jnp.concatenate(
        [jnp.zeros(a), jnp.ones(b), jnp.full(n - a - b, 2)]
    ).astype(jnp.int32)
    return jnp.stack([seg, seg + 10])


@pytest.mark.parametrize("causal", [False, True])
def test_segment_ids_vs_oracle(rng_key, causal):
    from flash_attention_metal_tpu.config import SegmentIds

    n = 512
    q, k, v = make_qkv(rng_key, (2, 2, n, 64))
    seg = _packed_segments(n)
    sids = SegmentIds(q=seg, kv=seg)
    bs = BlockSizes(block_q=64, block_k=64)
    got = flash_attention_fwd(
        q, k, v, causal=causal, segment_ids=sids, block_sizes=bs,
    )
    want = attention_reference(q, k, v, causal=causal, segment_ids=sids)
    assert max_abs_diff(got, want) < TOL_FP32


def test_kv_positions_rolling_cache_mask(rng_key):
    """Position-space masking over a WRAPPED cache == linear oracle.

    Simulates a rolling cache (capacity 256) holding the last 256 of 300
    positions, queried by the final 128 rows with a 120-token window —
    eviction, wrapping, and -1 slots all in play.
    """
    C, cur, W = 256, 300, 120
    kq, kk, kv2 = jax.random.split(rng_key, 3)
    q = jax.random.uniform(kq, (1, 2, 128, 64), jnp.float32, -1, 1)
    hist_k = jax.random.uniform(kk, (1, 2, cur, 64), jnp.float32, -1, 1)
    hist_v = jax.random.uniform(kv2, (1, 2, cur, 64), jnp.float32, -1, 1)

    slots = np.arange(cur) % C
    kcache = np.zeros((1, 2, C, 64), np.float32)
    vcache = np.zeros((1, 2, C, 64), np.float32)
    pos = -np.ones((1, C), np.int32)
    kcache[:, :, slots] = np.asarray(hist_k)
    vcache[:, :, slots] = np.asarray(hist_v)
    pos[:, slots] = np.arange(cur)

    offs = jnp.asarray([cur - 128], jnp.int32)
    bs = BlockSizes(block_q=64, block_k=64)
    got = flash_attention_fwd(
        q, jnp.asarray(kcache), jnp.asarray(vcache), offs,
        causal=True, window=W, kv_positions=jnp.asarray(pos),
        block_sizes=bs,
    )
    want = attention_reference(
        q, hist_k, hist_v, causal=True, window=W,
        q_offset=offs[:, None, None, None],
    )
    assert max_abs_diff(got, want) < TOL_FP32


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_feature_combination_fuzz(seed):
    """Random combinations of GQA, window, segments, offsets vs oracle."""
    import numpy as onp

    from flash_attention_metal_tpu.config import SegmentIds
    from flash_attention_metal_tpu.ops.attention import flash_attention

    rng = onp.random.default_rng(seed)
    n = int(rng.choice([256, 512]))
    heads = int(rng.choice([2, 4]))
    kv_heads = int(rng.choice([h for h in (1, 2, heads) if heads % h == 0]))
    causal = True
    window = int(rng.choice([0, n // 4, n]))
    use_seg = bool(rng.choice([False, True]))

    key = jax.random.PRNGKey(seed)
    kq, kk, kv2 = jax.random.split(key, 3)
    q = jax.random.uniform(kq, (2, heads, n, 64), jnp.float32, -1, 1)
    k = jax.random.uniform(kk, (2, kv_heads, n, 64), jnp.float32, -1, 1)
    v = jax.random.uniform(kv2, (2, kv_heads, n, 64), jnp.float32, -1, 1)

    sids = None
    if use_seg:
        cut = n // 3
        seg = jnp.concatenate(
            [jnp.zeros(cut), jnp.ones(n - cut)]
        ).astype(jnp.int32)
        seg = jnp.stack([seg, seg + 5])
        sids = SegmentIds(q=seg, kv=seg)

    kwargs = dict(
        causal=causal,
        window=window or None,
        segment_ids=sids,
    )
    got = flash_attention(q, k, v, **kwargs)
    reps = heads // kv_heads
    kr = jnp.repeat(k, reps, axis=1)
    vr = jnp.repeat(v, reps, axis=1)
    want = attention_reference(
        q, kr, vr, causal=causal, window=window or None, segment_ids=sids
    )
    assert max_abs_diff(got, want) < TOL_FP32, (
        n, heads, kv_heads, window, use_seg,
    )


def test_sinks_beyond_window(rng_key):
    """Attention sinks stay visible past the sliding window (fwd)."""
    n = 512
    q, k, v = make_qkv(rng_key, (1, 2, n, 64))
    bs = BlockSizes(block_q=64, block_k=64)
    got = flash_attention_fwd(
        q, k, v, causal=True, window=100, sinks=4, block_sizes=bs,
    )
    want = attention_reference(q, k, v, causal=True, window=100, sinks=4)
    assert max_abs_diff(got, want) < TOL_FP32
    # Sanity: differs from the no-sink result.
    nosink = flash_attention_fwd(
        q, k, v, causal=True, window=100, block_sizes=bs
    )
    assert max_abs_diff(got, nosink) > 1e-3


def test_sinks_rolling_cache_positions(rng_key):
    """Sink-pinned slots + wrapped window slots vs the linear oracle."""
    from flash_attention_metal_tpu.runtime.kv_cache import rolling_slots

    C, cur, W, S = 256, 400, 120, 8
    kq, kk, kv2 = jax.random.split(rng_key, 3)
    q = jax.random.uniform(kq, (1, 2, 128, 64), jnp.float32, -1, 1)
    hist_k = jax.random.uniform(kk, (1, 2, cur, 64), jnp.float32, -1, 1)
    hist_v = jax.random.uniform(kv2, (1, 2, cur, 64), jnp.float32, -1, 1)

    slots = np.asarray(rolling_slots(jnp.arange(cur), C, S))
    kcache = np.zeros((1, 2, C, 64), np.float32)
    vcache = np.zeros((1, 2, C, 64), np.float32)
    pos = -np.ones((1, C), np.int32)
    kcache[:, :, slots] = np.asarray(hist_k)
    vcache[:, :, slots] = np.asarray(hist_v)
    pos[:, slots] = np.arange(cur)

    offs = jnp.asarray([cur - 128], jnp.int32)
    bs = BlockSizes(block_q=64, block_k=64)
    got = flash_attention_fwd(
        q, jnp.asarray(kcache), jnp.asarray(vcache), offs,
        causal=True, window=W, sinks=S, kv_positions=jnp.asarray(pos),
        block_sizes=bs,
    )
    want = attention_reference(
        q, hist_k, hist_v, causal=True, window=W, sinks=S,
        q_offset=offs[:, None, None, None],
    )
    assert max_abs_diff(got, want) < TOL_FP32


# ---------------------------------------------------------------------------
# Score transforms: tanh softcap (Gemma-2) and ALiBi linear position bias —
# capabilities the reference scoped out (project_narrative.md:50-53), built
# here as in-kernel transforms between QK^T and masking.
# ---------------------------------------------------------------------------


def _alibi_test_slopes(h):
    return jnp.asarray([2.0 ** -(i + 1) for i in range(h)], jnp.float32)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("softcap", [30.0, 8.0])
def test_softcap_vs_oracle(rng_key, causal, softcap):
    q, k, v = make_qkv(rng_key, (1, 2, 256, 64))
    bs = BlockSizes(block_q=64, block_k=64)
    got = flash_attention_fwd(
        q, k, v, causal=causal, softcap=softcap, block_sizes=bs,
    )
    want = attention_reference(q, k, v, causal=causal, softcap=softcap)
    assert max_abs_diff(got, want) < TOL_FP32


@pytest.mark.parametrize("causal", [False, True])
def test_alibi_vs_oracle(rng_key, causal):
    q, k, v = make_qkv(rng_key, (2, 4, 256, 64))
    slopes = _alibi_test_slopes(4)
    bs = BlockSizes(block_q=64, block_k=64)
    got = flash_attention_fwd(
        q, k, v, causal=causal, alibi_slopes=slopes, block_sizes=bs,
    )
    want = attention_reference(q, k, v, causal=causal, alibi_slopes=slopes)
    assert max_abs_diff(got, want) < TOL_FP32


def test_alibi_softcap_window_gqa_combination(rng_key):
    """softcap + ALiBi + sliding window + GQA all compose vs the oracle."""
    from flash_attention_metal_tpu.ops.attention import flash_attention

    q, _, _ = make_qkv(rng_key, (2, 4, 512, 64))
    k2, v2 = (
        jax.random.uniform(key, (2, 2, 512, 64), jnp.float32, -1, 1)
        for key in jax.random.split(rng_key, 2)
    )
    slopes = _alibi_test_slopes(4)
    got = flash_attention(
        q, k2, v2, causal=True, window=192, softcap=20.0,
        alibi_slopes=slopes,
    )
    kr, vr = jnp.repeat(k2, 2, axis=1), jnp.repeat(v2, 2, axis=1)
    want = attention_reference(
        q, kr, vr, causal=True, window=192, softcap=20.0,
        alibi_slopes=slopes,
    )
    assert max_abs_diff(got, want) < TOL_FP32


def test_alibi_rolling_cache_positions(rng_key):
    """ALiBi distance rides kv_positions (position space) on wrapped caches."""
    C, cur = 256, 300
    kq, kk, kv2 = jax.random.split(rng_key, 3)
    q = jax.random.uniform(kq, (1, 2, 128, 64), jnp.float32, -1, 1)
    hist_k = jax.random.uniform(kk, (1, 2, cur, 64), jnp.float32, -1, 1)
    hist_v = jax.random.uniform(kv2, (1, 2, cur, 64), jnp.float32, -1, 1)
    slopes = _alibi_test_slopes(2)

    slots = np.arange(cur) % C
    kcache = np.zeros((1, 2, C, 64), np.float32)
    vcache = np.zeros((1, 2, C, 64), np.float32)
    pos = -np.ones((1, C), np.int32)
    kcache[:, :, slots] = np.asarray(hist_k)
    vcache[:, :, slots] = np.asarray(hist_v)
    pos[:, slots] = np.arange(cur)

    offs = jnp.asarray([cur - 128], jnp.int32)
    bs = BlockSizes(block_q=64, block_k=64)
    got = flash_attention_fwd(
        q, jnp.asarray(kcache), jnp.asarray(vcache), offs,
        causal=True, window=120, kv_positions=jnp.asarray(pos),
        alibi_slopes=slopes, block_sizes=bs,
    )
    want = attention_reference(
        q, hist_k, hist_v, causal=True, window=120,
        alibi_slopes=slopes, q_offset=offs[0],
    )
    assert max_abs_diff(got, want) < TOL_FP32


def test_softcap_alibi_grads_match_oracle(rng_key):
    """Pallas fwd + oracle-VJP bwd == end-to-end oracle autodiff."""
    from flash_attention_metal_tpu.ops.attention import flash_attention

    q, k, v = make_qkv(rng_key, (1, 2, 256, 64))
    slopes = _alibi_test_slopes(2)

    def loss(fn, *args):
        return jnp.sum(fn(*args) ** 2)

    g = jax.grad(
        lambda a, b, c, s: loss(
            lambda *x: flash_attention(
                x[0], x[1], x[2], causal=True, softcap=20.0,
                alibi_slopes=x[3],
            ),
            a, b, c, s,
        ),
        argnums=(0, 1, 2, 3),
    )(q, k, v, slopes)
    gr = jax.grad(
        lambda a, b, c, s: loss(
            lambda *x: attention_reference(
                x[0], x[1], x[2], causal=True, softcap=20.0,
                alibi_slopes=x[3],
            ),
            a, b, c, s,
        ),
        argnums=(0, 1, 2, 3),
    )(q, k, v, slopes)
    for name, a, b in zip("dq dk dv dslopes".split(), g, gr):
        assert max_abs_diff(a, b) < 1e-2, name
