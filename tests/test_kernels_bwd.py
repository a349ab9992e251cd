"""Backward kernels vs the closed-form oracle gradient.

The reference verifies dQ against a CPU gradient at 1e-1 (main.mm:1191;
loose because of its float-atomic accumulation).  The FA-2 dK/dV and dQ
kernels accumulate deterministically in fp32 with no atomics, so we hold
the fp32 path to a much tighter 1e-3 and keep the reference's 1e-1 only
for the half-precision path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_metal_tpu.config import BlockSizes
from flash_attention_metal_tpu.kernels import (
    flash_attention_bwd,
    flash_attention_fwd,
)
from flash_attention_metal_tpu.ops import flash_attention
from flash_attention_metal_tpu.reference import (
    attention_reference,
    attention_reference_bwd,
    make_qkv,
)


def max_abs_diff(a, b):
    return float(jnp.max(jnp.abs(a.astype(jnp.float32) - b.astype(jnp.float32))))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [128, 256])
def test_bwd_fp32_vs_oracle(rng_key, n, causal):
    q, k, v = make_qkv(rng_key, (1, 2, n, 64))
    do = jax.random.normal(jax.random.PRNGKey(3), q.shape, jnp.float32) * 0.1
    o, lse = flash_attention_fwd(
        q, k, v, causal=causal, save_lse=True
    )
    dq, dk, dv = flash_attention_bwd(
        q, k, v, o, do, lse, causal=causal
    )
    dq_r, dk_r, dv_r = attention_reference_bwd(q, k, v, do, causal=causal)
    assert max_abs_diff(dq, dq_r) < 1e-3
    assert max_abs_diff(dk, dk_r) < 1e-3
    assert max_abs_diff(dv, dv_r) < 1e-3


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_half_vs_oracle(rng_key, causal):
    # 0.01 input downscale to avoid half-precision overflow mirrors the
    # reference's big-batch fixture (main.mm:951-954).
    q, k, v = make_qkv(rng_key, (2, 4, 256, 64), dtype=jnp.bfloat16)
    do = (
        jax.random.normal(jax.random.PRNGKey(3), q.shape, jnp.float32) * 0.01
    ).astype(jnp.bfloat16)
    o, lse = flash_attention_fwd(
        q, k, v, causal=causal, save_lse=True
    )
    dq, dk, dv = flash_attention_bwd(
        q, k, v, o, do, lse, causal=causal
    )
    dq_r, dk_r, dv_r = attention_reference_bwd(q, k, v, do, causal=causal)
    assert max_abs_diff(dq, dq_r) < 1e-1  # reference backward tolerance
    assert max_abs_diff(dk, dk_r) < 1e-1
    assert max_abs_diff(dv, dv_r) < 1e-1


@pytest.mark.parametrize("causal", [False, True])
def test_custom_vjp_grad(rng_key, causal):
    """jax.grad through the public op matches grad through the oracle."""
    q, k, v = make_qkv(rng_key, (1, 2, 256, 64))

    def loss_flash(q, k, v):
        return jnp.sum(flash_attention(q, k, v, causal=causal) ** 2)

    def loss_ref(q, k, v):
        return jnp.sum(attention_reference(q, k, v, causal=causal) ** 2)

    g_flash = jax.grad(loss_flash, argnums=(0, 1, 2))(q, k, v)
    g_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    for gf, gr in zip(g_flash, g_ref):
        assert max_abs_diff(gf, gr) < 1e-2


def test_bwd_block_sweep(rng_key):
    q, k, v = make_qkv(rng_key, (1, 1, 512, 64))
    do = jax.random.normal(jax.random.PRNGKey(5), q.shape, jnp.float32) * 0.1
    o, lse = flash_attention_fwd(q, k, v, save_lse=True)
    dq_r, dk_r, dv_r = attention_reference_bwd(q, k, v, do)
    for bs in [
        BlockSizes(block_q_bwd=16, block_k_bwd=32),
        BlockSizes(block_q_bwd=64, block_k_bwd=128),
        BlockSizes(block_q_bwd=128, block_k_bwd=64),
    ]:
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, do, lse, block_sizes=bs
        )
        assert max_abs_diff(dq, dq_r) < 1e-3
        assert max_abs_diff(dk, dk_r) < 1e-3
        assert max_abs_diff(dv, dv_r) < 1e-3


def test_gqa_forward_and_grad(rng_key):
    kq, kk, kv2 = jax.random.split(rng_key, 3)
    q = jax.random.uniform(kq, (1, 8, 256, 64), jnp.float32, -1, 1)
    k = jax.random.uniform(kk, (1, 2, 256, 64), jnp.float32, -1, 1)
    v = jax.random.uniform(kv2, (1, 2, 256, 64), jnp.float32, -1, 1)
    o = flash_attention(q, k, v, causal=True)
    want = attention_reference(q, jnp.repeat(k, 4, 1), jnp.repeat(v, 4, 1), causal=True)
    assert max_abs_diff(o, want) < 1e-3

    g = jax.grad(lambda k_: jnp.sum(flash_attention(q, k_, v, causal=True)))(k)
    assert g.shape == k.shape
    assert not bool(jnp.any(jnp.isnan(g)))


def test_sliding_window_grads(rng_key):
    """Windowed-attention grads through the public op match the oracle."""
    from flash_attention_metal_tpu.ops.attention import flash_attention
    from flash_attention_metal_tpu.reference import attention_reference

    n, w = 512, 160
    q, k, v = make_qkv(rng_key, (1, 2, n, 64))
    bs = BlockSizes(block_q=64, block_k=64)

    def loss(q_, k_, v_):
        return jnp.sum(
            flash_attention(
                q_, k_, v_, causal=True, window=w, block_sizes=bs,
            )
            ** 2
        )

    def loss_ref(q_, k_, v_):
        return jnp.sum(
            attention_reference(q_, k_, v_, causal=True, window=w) ** 2
        )

    got = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    want = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    for name, a, b in zip("qkv", got, want):
        assert max_abs_diff(a, b) < 5e-3, name


def test_segment_ids_grads(rng_key):
    """Packed-sequence grads through the public op match the oracle."""
    from flash_attention_metal_tpu.config import SegmentIds
    from flash_attention_metal_tpu.ops.attention import flash_attention
    from flash_attention_metal_tpu.reference import attention_reference

    n = 512
    q, k, v = make_qkv(rng_key, (1, 2, n, 64))
    seg = jnp.concatenate(
        [jnp.zeros(192), jnp.ones(192), jnp.full(128, 2)]
    ).astype(jnp.int32)[None]
    sids = SegmentIds(q=seg, kv=seg)
    bs = BlockSizes(block_q=64, block_k=64)

    def loss(q_, k_, v_):
        return jnp.sum(
            flash_attention(
                q_, k_, v_, segment_ids=sids, causal=True,
                block_sizes=bs,
            )
            ** 2
        )

    def loss_ref(q_, k_, v_):
        return jnp.sum(
            attention_reference(
                q_, k_, v_, causal=True, segment_ids=sids
            )
            ** 2
        )

    got = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    want = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    for name, a, b in zip("qkv", got, want):
        assert max_abs_diff(a, b) < 5e-3, name


def test_save_lse_grads_match_oracle(rng_key):
    """(o, lse) are BOTH differentiable; lse cotangent folds into delta
    (save_lse=True must go through the custom VJP, not around it)."""
    from flash_attention_metal_tpu.reference.oracle import (
        attention_reference_with_lse,
    )

    q, k, v = make_qkv(rng_key, (1, 2, 256, 64))
    co = jax.random.normal(jax.random.PRNGKey(2), q.shape) * 0.1
    cl = jax.random.normal(jax.random.PRNGKey(3), q.shape[:3]) * 0.1

    def loss_flash(q_, k_, v_):
        o, lse = flash_attention(
            q_, k_, v_, causal=True, save_lse=True
        )
        return jnp.sum(o * co) + jnp.sum(lse * cl)

    def loss_oracle(q_, k_, v_):
        o, lse = attention_reference_with_lse(q_, k_, v_, causal=True)
        return jnp.sum(o * co) + jnp.sum(lse * cl)

    got = jax.grad(loss_flash, argnums=(0, 1, 2))(q, k, v)
    want = jax.grad(loss_oracle, argnums=(0, 1, 2))(q, k, v)
    for name, a, b in zip("qkv", got, want):
        assert max_abs_diff(a, b) < 1e-3, name


def test_bwd_neg_inf_lse_rows_give_zero_grads(rng_key):
    """-inf lse rows (the fully-masked sentinel) must produce p == 0 in
    the backward, not inf or NaN."""
    q, k, v = make_qkv(rng_key, (1, 1, 512, 64))
    o, lse = flash_attention_fwd(
        q, k, v, causal=True, save_lse=True
    )
    lse = lse.at[0, 0, 7].set(-jnp.inf)
    do = q * 0.1
    dq, dk, dv = flash_attention_bwd(
        q, k, v, o, do, lse, causal=True
    )
    for g in (dq, dk, dv):
        assert bool(jnp.all(jnp.isfinite(g)))
    assert float(jnp.max(jnp.abs(dq[0, 0, 7]))) == 0.0


def test_bwd_rejects_head_mismatch(rng_key):
    """KV heads must divide the query heads: a silently clamped KV head
    index would corrupt the gradients."""
    q, _, _ = make_qkv(rng_key, (1, 3, 128, 64))
    _, k, v = make_qkv(jax.random.PRNGKey(9), (1, 2, 128, 64))
    o = q
    lse = jnp.zeros(q.shape[:3], jnp.float32)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash_attention_bwd(q, k, v, o, q * 0.1, lse, causal=True)


# ---------------------------------------------------------------------------
# In-kernel softcap/ALiBi backward + native-GQA backward (the dS-transform
# site of the reference backward, kernels.metal:1160-1169, extended with
# the transforms its forward never had).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
def test_softcap_bwd_in_kernel(rng_key, causal):
    """softcap grads ride the FA-2 kernels (no O(N^2) oracle recompute)."""
    q, k, v = make_qkv(rng_key, (1, 2, 256, 64))
    do = jax.random.normal(jax.random.PRNGKey(3), q.shape, jnp.float32) * 0.1

    def loss(q_, k_, v_):
        return jnp.sum(
            flash_attention(q_, k_, v_, causal=causal, softcap=8.0) * do
        )

    def loss_ref(q_, k_, v_):
        return jnp.sum(
            attention_reference(q_, k_, v_, causal=causal, softcap=8.0) * do
        )

    g = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    gr = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(g, gr):
        assert max_abs_diff(a, b) < 1e-3


@pytest.mark.parametrize("causal", [False, True])
def test_alibi_bwd_in_kernel_with_dslopes(rng_key, causal):
    """ALiBi grads incl. d/d(slopes) (in-kernel dS*distance reduce)."""
    q, k, v = make_qkv(rng_key, (1, 2, 256, 64))
    do = jax.random.normal(jax.random.PRNGKey(3), q.shape, jnp.float32) * 0.1
    slopes = jnp.array([0.25, 0.0625], jnp.float32)

    def loss(q_, k_, v_, s_):
        return jnp.sum(
            flash_attention(q_, k_, v_, causal=causal, alibi_slopes=s_) * do
        )

    def loss_ref(q_, k_, v_, s_):
        return jnp.sum(
            attention_reference(q_, k_, v_, causal=causal, alibi_slopes=s_)
            * do
        )

    g = jax.grad(loss, argnums=(0, 1, 2, 3))(q, k, v, slopes)
    gr = jax.grad(loss_ref, argnums=(0, 1, 2, 3))(q, k, v, slopes)
    for a, b in zip(g[:3], gr[:3]):
        assert max_abs_diff(a, b) < 1e-3
    np.testing.assert_allclose(
        np.asarray(g[3]), np.asarray(gr[3]), rtol=1e-3, atol=1e-3
    )


@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("causal", [False, True])
def test_gqa_fold_bwd_vs_oracle(rng_key, causal, window):
    """Native-GQA backward == broadcast oracle.

    dK/dV come out group-summed straight from the dK/dV kernel's register
    accumulators — no jnp.repeat broadcast, no group-reduce pass."""
    if window is not None and not causal:
        pytest.skip("window requires causal")
    # Group 4: the dK/dV program loops over four query heads.
    q, _, _ = make_qkv(rng_key, (2, 8, 256, 64))
    _, k, v = make_qkv(jax.random.PRNGKey(9), (2, 2, 256, 64))
    do = jax.random.normal(jax.random.PRNGKey(3), q.shape, jnp.float32) * 0.1

    def loss(q_, k_, v_):
        return jnp.sum(
            flash_attention(q_, k_, v_, causal=causal, window=window) * do
        )

    def loss_ref(q_, k_, v_):
        kb = jnp.broadcast_to(k_[:, :, None], (2, 2, 4, 256, 64)).reshape(
            2, 8, 256, 64
        )
        vb = jnp.broadcast_to(v_[:, :, None], (2, 2, 4, 256, 64)).reshape(
            2, 8, 256, 64
        )
        return jnp.sum(
            attention_reference(q_, kb, vb, causal=causal, window=window)
            * do
        )

    g = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    gr = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(g, gr):
        assert max_abs_diff(a, b) < 1e-3


def test_gqa_fold_bwd_with_save_lse_and_segments(rng_key):
    """Native GQA composes with segment ids and a differentiable lse
    output."""
    from flash_attention_metal_tpu.config import SegmentIds

    q, _, _ = make_qkv(rng_key, (2, 8, 256, 64))
    _, k, v = make_qkv(jax.random.PRNGKey(9), (2, 2, 256, 64))
    do = jax.random.normal(jax.random.PRNGKey(3), q.shape, jnp.float32) * 0.1
    ids = (jnp.arange(256)[None, :] // 128).astype(jnp.int32).repeat(2, 0)
    seg = SegmentIds(q=ids, kv=ids)

    def loss(q_, k_, v_):
        o, lse = flash_attention(
            q_, k_, v_, segment_ids=seg, causal=True, save_lse=True
        )
        return jnp.sum(o * do) + 0.01 * jnp.sum(lse)

    def loss_ref(q_, k_, v_):
        from flash_attention_metal_tpu.reference.oracle import (
            attention_reference_with_lse,
        )

        kb = jnp.repeat(k_, 4, axis=1)
        vb = jnp.repeat(v_, 4, axis=1)
        o, lse = attention_reference_with_lse(
            q_, kb, vb, causal=True, segment_ids=seg
        )
        return jnp.sum(o * do) + 0.01 * jnp.sum(lse)

    g = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    gr = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(g, gr):
        assert max_abs_diff(a, b) < 1e-3


def test_dropout_softcap_alibi_bwd_composition(rng_key):
    """Dropout composes with softcap + ALiBi on the Pallas path,
    gradients matching the oracle bit-for-mask."""
    q, k, v = make_qkv(rng_key, (1, 2, 256, 64))
    do = jax.random.normal(jax.random.PRNGKey(3), q.shape, jnp.float32) * 0.1
    slopes = jnp.array([0.25, 0.0625], jnp.float32)
    seed = jnp.int32(11)

    def loss(q_, k_, v_, s_):
        return jnp.sum(
            flash_attention(
                q_, k_, v_, causal=True, softcap=8.0, alibi_slopes=s_,
                dropout_rate=0.2, dropout_seed=seed,
            )
            * do
        )

    def loss_ref(q_, k_, v_, s_):
        return jnp.sum(
            attention_reference(
                q_, k_, v_, causal=True, softcap=8.0, alibi_slopes=s_,
                dropout_rate=0.2, dropout_seed=seed,
            )
            * do
        )

    g = jax.grad(loss, argnums=(0, 1, 2, 3))(q, k, v, slopes)
    gr = jax.grad(loss_ref, argnums=(0, 1, 2, 3))(q, k, v, slopes)
    for a, b in zip(g[:3], gr[:3]):
        assert max_abs_diff(a, b) < 1e-3
    np.testing.assert_allclose(
        np.asarray(g[3]), np.asarray(gr[3]), rtol=1e-3, atol=1e-3
    )


def test_no_oracle_vjp_in_ext_bwd(rng_key):
    """The softcap backward must not materialize the O(N^2) score tensor:
    check the jaxpr of the VJP for any (N, N)-shaped fp32 intermediate
    bigger than the kernel's own block tiles."""
    n = 512
    q, k, v = make_qkv(rng_key, (1, 1, n, 64))

    def loss(q_):
        return jnp.sum(
            flash_attention(q_, k, v, causal=True, softcap=8.0) ** 2
        )

    jaxpr = jax.make_jaxpr(jax.grad(loss))(q)

    def check(jx):
        for eqn in jx.eqns:
            if "pallas" in str(eqn.primitive):
                # The kernel's own score tile is (block_q, block_k) by
                # design; only HBM-level intermediates are the smell.
                continue
            for var in eqn.outvars:
                shape = getattr(var.aval, "shape", ())
                # A dense [*, N, N] score tensor would betray an oracle VJP.
                assert not (
                    len(shape) >= 2 and shape[-1] == n and shape[-2] == n
                ), f"O(N^2) intermediate {shape} in {eqn.primitive}"
            for sub in jax.core.jaxprs_in_params(eqn.params):
                check(sub)

    check(jaxpr.jaxpr)
