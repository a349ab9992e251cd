"""Attention-dropout tests.

The dropout mask is a stateless hash of (seed, batch*head, row, col), so
the Pallas kernels and the jnp oracle produce the IDENTICAL mask — the
tests verify dropout exactly (fp tolerance), not just statistically.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from flash_attention_metal_tpu.config import BlockSizes
from flash_attention_metal_tpu.kernels._common import dropout_keep
from flash_attention_metal_tpu.ops import flash_attention
from flash_attention_metal_tpu.reference import (
    attention_reference,
    make_qkv,
)

RATE = 0.2
SEED = jnp.int32(1234)
# Multi-block tiles so the streaming (online-softmax) path is exercised.
BS = BlockSizes(block_q=64, block_k=64, block_q_bwd=64, block_k_bwd=64)


@pytest.mark.parametrize("causal", [False, True])
def test_dropout_fwd_matches_oracle(causal):
    q, k, v = make_qkv(jax.random.PRNGKey(0), (2, 3, 256, 64))
    o = flash_attention(
        q, k, v, causal=causal, dropout_rate=RATE, dropout_seed=SEED,
        block_sizes=BS,
    )
    o_ref = attention_reference(
        q, k, v, causal=causal, dropout_rate=RATE, dropout_seed=SEED
    )
    np.testing.assert_allclose(np.asarray(o), np.asarray(o_ref), atol=5e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_dropout_grads_match_oracle(causal):
    q, k, v = make_qkv(jax.random.PRNGKey(1), (1, 2, 256, 64))

    def f_pallas(q_, k_, v_):
        o = flash_attention(
            q_, k_, v_, causal=causal, dropout_rate=RATE, dropout_seed=SEED,
            block_sizes=BS,
        )
        return jnp.sum(o * jnp.cos(jnp.arange(o.size).reshape(o.shape)))

    def f_oracle(q_, k_, v_):
        o = attention_reference(
            q_, k_, v_, causal=causal, dropout_rate=RATE, dropout_seed=SEED
        )
        return jnp.sum(o * jnp.cos(jnp.arange(o.size).reshape(o.shape)))

    g = jax.grad(f_pallas, argnums=(0, 1, 2))(q, k, v)
    g_ref = jax.grad(f_oracle, argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(g, g_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=5e-5)


def test_dropout_gqa_grads_match_oracle():
    # 4 q heads over 2 kv heads: the fwd runs GQA natively, the bwd
    # broadcasts + group-reduces; the per-q-head mask must line up.
    q, _, _ = make_qkv(jax.random.PRNGKey(2), (1, 4, 128, 64))
    _, k, v = make_qkv(jax.random.PRNGKey(3), (1, 2, 128, 64))

    def f(attn):
        def g(q_, k_, v_):
            return jnp.sum(attn(q_, k_, v_) ** 2)
        return g

    pallas = f(lambda q_, k_, v_: flash_attention(
        q_, k_, v_, causal=True, dropout_rate=RATE, dropout_seed=SEED,
        block_sizes=BS,
    ))
    kb, vb = jnp.repeat(k, 2, axis=1), jnp.repeat(v, 2, axis=1)
    o = flash_attention(
        q, k, v, causal=True, dropout_rate=RATE, dropout_seed=SEED,
        block_sizes=BS,
    )
    o_ref = attention_reference(
        q, kb, vb, causal=True, dropout_rate=RATE, dropout_seed=SEED
    )
    np.testing.assert_allclose(np.asarray(o), np.asarray(o_ref), atol=5e-5)

    oracle = f(lambda q_, k_, v_: attention_reference(
        jnp.asarray(q_),
        jnp.repeat(k_, 2, axis=1),
        jnp.repeat(v_, 2, axis=1),
        causal=True, dropout_rate=RATE, dropout_seed=SEED,
    ))
    g = jax.grad(pallas, argnums=(0, 1, 2))(q, k, v)
    g_ref = jax.grad(oracle, argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(g, g_ref):
        # Squared-sum loss on GQA grads gives O(10) values; tolerance is
        # relative-dominated fp32 accumulation noise.
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=5e-4, rtol=1e-4
        )


def test_mask_statistics_and_determinism():
    bh = jnp.arange(8).reshape(8, 1, 1)
    rows = jnp.arange(256).reshape(1, 256, 1)
    cols = jnp.arange(256).reshape(1, 1, 256)
    m = dropout_keep(SEED, bh, rows, cols, RATE)
    frac = float((np.asarray(m) > 0).mean())
    assert abs(frac - (1 - RATE)) < 0.01, frac
    # Survivors are scaled by exactly 1/(1-rate).
    vals = np.unique(np.asarray(m))
    np.testing.assert_allclose(vals, [0.0, 1.0 / (1 - RATE)], rtol=1e-6)
    # Deterministic in the seed; different seeds give different masks.
    m2 = dropout_keep(SEED, bh, rows, cols, RATE)
    np.testing.assert_array_equal(np.asarray(m), np.asarray(m2))
    m3 = dropout_keep(jnp.int32(4321), bh, rows, cols, RATE)
    assert (np.asarray(m) != np.asarray(m3)).mean() > 0.1


def test_dropout_validation_errors():
    q, k, v = make_qkv(jax.random.PRNGKey(0), (1, 1, 128, 64))
    with pytest.raises(ValueError, match="dropout_seed"):
        flash_attention(q, k, v, causal=True, dropout_rate=0.1)
    # Round 4 lifted the dropout x save_lse gate: lse is pre-dropout (the
    # keep mask scales only the P.V accumulation), so the pair composes.
    o, lse = flash_attention(
        q, k, v, causal=True, dropout_rate=0.1, dropout_seed=SEED,
        save_lse=True,
    )
    _, lse_ref = flash_attention(q, k, v, causal=True, save_lse=True)
    np.testing.assert_allclose(
        np.asarray(lse), np.asarray(lse_ref), atol=1e-5
    )


def test_model_dropout_train_and_eval():
    from flash_attention_metal_tpu.models import (
        ModelConfig, forward, init_params,
    )

    cfg = ModelConfig(
        vocab_size=64, d_model=128, n_layers=2, n_heads=2, n_kv_heads=2,
        head_dim=64, d_ff=128, max_seq_len=128, dtype=jnp.float32,
        attn_dropout=0.3,
    )
    params = init_params(jax.random.PRNGKey(0), cfg)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 128), 0, 64)
    # Eval (no key): deterministic, dropout off.
    a = forward(params, tokens, cfg)
    b = forward(params, tokens, cfg)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # Train (key): output differs from eval and across keys.
    c = forward(params, tokens, cfg, dropout_key=jax.random.PRNGKey(2))
    d = forward(params, tokens, cfg, dropout_key=jax.random.PRNGKey(3))
    assert float(jnp.max(jnp.abs(a - c))) > 0
    assert float(jnp.max(jnp.abs(c - d))) > 0
    # Gradients flow through the dropout path.
    from flash_attention_metal_tpu.models import loss_fn

    g = jax.grad(loss_fn)(params, tokens, cfg, jax.random.PRNGKey(2))
    gn = jax.tree_util.tree_reduce(
        lambda s, x: s + float(jnp.sum(jnp.abs(x))), g, 0.0
    )
    assert np.isfinite(gn) and gn > 0


def test_dropout_offsets_global_coordinates():
    """A row-sharded slice with ``dropout_offsets`` reproduces the exact
    mask of the full-tensor run — the mechanism behind sharding-invariant
    dropout (ring/allgather SP, dp, tp)."""
    q, k, v = make_qkv(jax.random.PRNGKey(3), (2, 2, 256, 64))
    ro = 128
    o_full = attention_reference(
        q, k, v, dropout_rate=RATE, dropout_seed=SEED
    )
    o_shard = flash_attention(
        q[:, :, ro:], k, v, q_offset=jnp.int32(ro),
        dropout_rate=RATE, dropout_seed=SEED,
        dropout_offsets=(ro, 0, 0, 0), block_sizes=BS,
    )
    np.testing.assert_allclose(
        np.asarray(o_shard), np.asarray(o_full[:, :, ro:]), atol=5e-5
    )


def test_ring_dropout_matches_single_device():
    """ROADMAP round-2 edge, closed: attention dropout under ring
    sequence parallelism.  Every ring step hashes its mask at GLOBAL
    score coordinates, so the sharded forward AND the reverse-ring
    backward equal the single-device dropout run exactly."""
    from flash_attention_metal_tpu.parallel import make_ring_attention
    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices()[:4]), ("sp",))
    q, k, v = make_qkv(jax.random.PRNGKey(4), (1, 2, 512, 64))
    ring = make_ring_attention(
        mesh, "sp", causal=True, differentiable=True, dropout_rate=RATE
    )
    o_ring = ring(q, k, v, SEED)
    o_ref = flash_attention(
        q, k, v, causal=True, dropout_rate=RATE, dropout_seed=SEED
    )
    np.testing.assert_allclose(
        np.asarray(o_ring), np.asarray(o_ref), atol=5e-5
    )

    def loss_ring(q_, k_, v_):
        return jnp.sum(ring(q_, k_, v_, SEED) ** 2)

    def loss_ref(q_, k_, v_):
        return jnp.sum(
            flash_attention(
                q_, k_, v_, causal=True, dropout_rate=RATE,
                dropout_seed=SEED,
            )
            ** 2
        )

    got = jax.grad(loss_ring, argnums=(0, 1, 2))(q, k, v)
    want = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    for name, a, b in zip("qkv", got, want):
        assert float(jnp.max(jnp.abs(a - b))) < 1e-4, name


def test_train_step_dropout_mesh_invariant():
    """Dropout training is invariant to the mesh factorization: the
    dp x tp x sp sharded loss (ring AND allgather SP attention) equals
    the single-device ``transformer.loss_fn`` for the same dropout key —
    masks hash at global (b, h, row, col), so no seed folding, no
    divergence."""
    from jax.sharding import Mesh
    from flash_attention_metal_tpu.models import (
        ModelConfig, init_params, loss_fn,
    )
    from flash_attention_metal_tpu.models.parallel_train import (
        make_train_step,
    )

    cfg = ModelConfig(
        vocab_size=128, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=256, max_seq_len=256, dtype=jnp.float32,
        attn_impl="pallas", attn_dropout=0.2,
    )
    params = init_params(jax.random.PRNGKey(0), cfg)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (4, 256), 0, 128)
    key = jax.random.PRNGKey(42)
    l0 = float(loss_fn(params, tokens, cfg, dropout_key=key))

    mesh = Mesh(
        np.array(jax.devices()[:8]).reshape(2, 2, 2), ("dp", "tp", "sp")
    )
    for attn in ("allgather", "ring"):
        step = make_train_step(mesh, cfg, sp_attn=attn, dropout=True)
        _, loss = step(params, tokens, key)
        assert abs(float(loss) - l0) < 1e-5, (attn, float(loss), l0)
