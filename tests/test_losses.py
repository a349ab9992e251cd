"""Blockwise cross-entropy + gradient-accumulation tests.

The chunked-vocab loss must equal the dense loss to fp32 roundoff (same
math, different memory), and a grad-accumulated optimizer step must
reproduce the full-batch step exactly (mean-of-means with equal
microbatches == global mean).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from flash_attention_metal_tpu.models import (
    ModelConfig,
    init_params,
    loss_fn,
)
from flash_attention_metal_tpu.models.losses import (
    blockwise_softmax_xent,
    loss_fn_blockwise,
)

CFG = ModelConfig(
    vocab_size=512,
    d_model=128,
    n_layers=2,
    n_heads=2,
    n_kv_heads=2,
    head_dim=64,
    d_ff=128,
    max_seq_len=128,
    dtype=jnp.float32,
)


def _fixtures(seed=0, batch=4, seq=64):
    params = init_params(jax.random.PRNGKey(seed), CFG)
    tokens = jax.random.randint(
        jax.random.PRNGKey(seed + 1), (batch, seq), 0, CFG.vocab_size
    )
    return params, tokens


@pytest.mark.parametrize("chunk", [128, 256, 512])
def test_blockwise_loss_equals_dense(chunk):
    params, tokens = _fixtures()
    dense = float(loss_fn(params, tokens, CFG))
    block = float(
        loss_fn_blockwise(params, tokens, CFG, vocab_chunk=chunk)
    )
    np.testing.assert_allclose(block, dense, rtol=1e-6)


def test_blockwise_grads_equal_dense():
    params, tokens = _fixtures()
    g_dense = jax.grad(loss_fn)(params, tokens, CFG)
    g_block = jax.grad(
        lambda p: loss_fn_blockwise(p, tokens, CFG, vocab_chunk=128)
    )(params)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=2e-6, rtol=1e-5
        ),
        g_dense,
        g_block,
    )


def test_z_loss_matches_manual():
    params, tokens = _fixtures()
    from flash_attention_metal_tpu.models.transformer import forward

    logits = forward(params, tokens, CFG)[:, :-1]
    lse = jax.nn.logsumexp(logits, axis=-1)
    targets = tokens[:, 1:]
    nll = lse - jnp.take_along_axis(logits, targets[..., None], -1)[..., 0]
    z = 1e-3
    manual = float(jnp.mean(nll + z * lse**2))
    block = float(
        loss_fn_blockwise(params, tokens, CFG, vocab_chunk=128, z_loss=z)
    )
    np.testing.assert_allclose(block, manual, rtol=1e-6)


def test_blockwise_rejects_quantized_lm_head():
    from flash_attention_metal_tpu.models import quantize_weights

    params, tokens = _fixtures()
    with pytest.raises(ValueError, match="serving-only"):
        loss_fn_blockwise(quantize_weights(params), tokens, CFG)


def test_grad_accum_step_equals_full_batch():
    from flash_attention_metal_tpu.models.trainer import Trainer

    _, tokens = _fixtures(batch=4, seq=64)

    def one_step(accum):
        tr = Trainer(CFG, seed=7, grad_accum=accum)
        tr.step(tokens)
        return tr.state.params

    p1 = one_step(1)
    p4 = one_step(4)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=1e-6
        ),
        p1,
        p4,
    )


def test_trainer_blockwise_loss_trains():
    import optax
    from flash_attention_metal_tpu.models.trainer import Trainer

    # Memorize one fixed batch with a constant-LR optimizer (the default
    # warmup schedule's first steps are too small to show learning).
    tr = Trainer(
        CFG,
        seed=0,
        grad_accum=2,
        loss=loss_fn_blockwise,
        optimizer=optax.adam(3e-3),
    )
    _, tokens = _fixtures(batch=4, seq=64)
    losses = [tr.step(tokens) for _ in range(6)]
    assert losses[-1] < losses[0] - 0.3, losses


def test_ema_tracks_and_roundtrips(tmp_path):
    from flash_attention_metal_tpu.models.trainer import Trainer

    tr = Trainer(CFG, seed=0, ema_decay=0.9)
    _, tokens = _fixtures(batch=2, seq=64)
    for _ in range(3):
        tr.step(tokens)
    # EMA differs from the live params but stays close (warmup-capped
    # decay keeps it tracking early on).
    diffs = jax.tree_util.tree_map(
        lambda e, p: float(jnp.max(jnp.abs(e - p))),
        tr.ema_params,
        tr.state.params,
    )
    flat = jax.tree_util.tree_leaves(diffs)
    assert max(flat) > 0
    rel = jax.tree_util.tree_map(
        lambda e, p: float(
            jnp.linalg.norm(e - p) / (jnp.linalg.norm(p) + 1e-9)
        ),
        tr.ema_params,
        tr.state.params,
    )
    assert max(jax.tree_util.tree_leaves(rel)) < 0.05
    # Checkpoint round-trip includes the EMA tree.
    tr.save(str(tmp_path / "ck"))
    tr2 = Trainer(CFG, seed=1, ema_decay=0.9)
    tr2.load(str(tmp_path / "ck"))
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b)
        ),
        tr.ema_params,
        tr2.ema_params,
    )
    # EMA weights are a plain tree: they evaluate through the loss.
    from flash_attention_metal_tpu.models import loss_fn as dense_loss

    assert np.isfinite(float(dense_loss(tr.ema_params, tokens, CFG)))


def test_perplexity_matches_dense_loss():
    import math
    from flash_attention_metal_tpu.models.losses import perplexity

    params, tokens = _fixtures()
    want = math.exp(float(loss_fn(params, tokens, CFG)))
    got = perplexity(params, iter([tokens]), CFG, n_batches=1,
                     vocab_chunk=128)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # Token-weighted across two differently-sized batches.
    t2 = tokens[:2]
    got2 = perplexity(
        params, iter([tokens, t2]), CFG, n_batches=2, vocab_chunk=128
    )
    n1 = tokens.shape[0] * (tokens.shape[1] - 1)
    n2 = t2.shape[0] * (t2.shape[1] - 1)
    want2 = math.exp(
        (float(loss_fn(params, tokens, CFG)) * n1
         + float(loss_fn(params, t2, CFG)) * n2) / (n1 + n2)
    )
    np.testing.assert_allclose(got2, want2, rtol=1e-5)


def test_engine_stats():
    from flash_attention_metal_tpu.models import init_params as lm_init
    from flash_attention_metal_tpu.models.transformer import (
        ModelConfig as LMConfig,
    )
    from flash_attention_metal_tpu.runtime import DecodeEngine, Request

    lm_cfg = LMConfig(
        vocab_size=256, d_model=128, n_layers=2, n_heads=2, n_kv_heads=2,
        head_dim=64, d_ff=128, max_seq_len=256, dtype=jnp.float32,
    )
    params = lm_init(jax.random.PRNGKey(0), lm_cfg)
    eng = DecodeEngine(params, lm_cfg, max_batch=2, max_len=256)
    eng.submit(Request(uid=0, prompt=[1, 2, 3], max_new_tokens=6))
    eng.submit(Request(uid=1, prompt=[4, 5], max_new_tokens=4))
    eng.run()
    st = eng.stats()
    assert st["tokens"] == 10.0, st
    assert st["tokens_per_s"] > 0 and st["ms_per_step"] > 0
    assert st["steps"] >= 1


def test_blockwise_chunk_need_not_divide_vocab():
    """A vocabulary the requested chunk does not divide (Llama-3's 128256
    is not a multiple of 4096) takes the largest dividing chunk and
    still equals the dense cross-entropy."""
    import jax.numpy as jnp

    from flash_attention_metal_tpu.models.losses import blockwise_softmax_xent

    key = jax.random.PRNGKey(3)
    h = jax.random.normal(key, (2, 5, 16), jnp.float32)
    w = jax.random.normal(jax.random.PRNGKey(4), (16, 334), jnp.float32)
    t = jax.random.randint(jax.random.PRNGKey(5), (2, 5), 0, 334)
    got = blockwise_softmax_xent(h, w, t, vocab_chunk=128)
    logp = jax.nn.log_softmax(h @ w, axis=-1)
    want = -jnp.mean(jnp.take_along_axis(logp, t[..., None], -1))
    assert abs(float(got) - float(want)) < 1e-4

