"""Sequence-sharded serving decode (BASELINE config 5 composite).

The KV cache's length dim shards over sp; decode merges per-shard
partials with the lse combine (runtime/sp_decode.py).  Greedy
generations must be identical to the single-device engine — the
cross-shard merge is exactly the kernel's intra-chip online-softmax
merge, so there is no tolerance to hide behind.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from flash_attention_metal_tpu.models import ModelConfig, init_params
from flash_attention_metal_tpu.runtime.engine import DecodeEngine, Request

CFG = ModelConfig(
    vocab_size=256,
    d_model=128,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    head_dim=64,
    d_ff=256,
    max_seq_len=512,
    dtype=jnp.float32,
    attn_impl="auto",
)


@pytest.fixture(scope="module")
def params():
    return init_params(jax.random.PRNGKey(0), CFG)


def _generate(params, mesh=None, seq_axis=None, kv_quant=None):
    eng = DecodeEngine(
        params,
        CFG,
        max_batch=4,
        max_len=512,
        eos_id=-1,
        harvest_lag=2,
        mesh=mesh,
        seq_axis=seq_axis,
        kv_quant=kv_quant,
    )
    prompts = [[5, 6, 7, 8], list(range(10, 40)), list(range(100, 180))]
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=6, temperature=0.0))
    return eng.run()


def _sp_mesh():
    return Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dp", "sp"))


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_sp_sharded_decode_matches_single_device(params, kv_quant):
    ref = _generate(params, kv_quant=kv_quant)
    got = _generate(
        params, mesh=_sp_mesh(), seq_axis="sp", kv_quant=kv_quant
    )
    assert ref.keys() == got.keys()
    for uid in ref:
        assert ref[uid] == got[uid], (uid, ref[uid], got[uid])


def test_sp_rejects_rolling_cache(params):
    import dataclasses

    cfg = dataclasses.replace(CFG, attn_window=64)
    with pytest.raises(ValueError, match="dp-only"):
        DecodeEngine(
            params,
            cfg,
            max_batch=4,
            max_len=512,
            mesh=_sp_mesh(),
            seq_axis="sp",
            rolling=True,
        )


def test_tp_sharded_decode_matches_single_device(params):
    """Tensor-parallel serving: Megatron weight shards + head-sharded KV
    cache, psum after the row-parallel projections."""
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))
    ref = _generate(params)
    got = _generate(params, mesh=mesh, seq_axis=None)
    # reuse _generate but with head_axis: call engine directly
    eng_kwargs = dict(max_batch=4, max_len=512, eos_id=-1, harvest_lag=2)
    eng = DecodeEngine(params, CFG, mesh=mesh, head_axis="tp", **eng_kwargs)
    prompts = [[5, 6, 7, 8], list(range(10, 40)), list(range(100, 180))]
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=6, temperature=0.0))
    got_tp = eng.run()
    assert ref == got_tp


def test_dp_tp_sp_int8_decode_matches_single_device(params):
    """The full production topology: slots over dp, heads over tp,
    cache length over sp, int8 KV — generations == single device."""
    mesh = Mesh(
        np.array(jax.devices()[:8]).reshape(2, 2, 2), ("dp", "tp", "sp")
    )
    ref = _generate(params, kv_quant="int8")
    eng = DecodeEngine(
        params, CFG, max_batch=4, max_len=512, eos_id=-1, harvest_lag=2,
        mesh=mesh, head_axis="tp", seq_axis="sp", kv_quant="int8",
    )
    prompts = [[5, 6, 7, 8], list(range(10, 40)), list(range(100, 180))]
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=6, temperature=0.0))
    got = eng.run()
    assert ref == got


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_sp_tp_multi_step_decode_matches_single_device(params, kv_quant):
    """multi_step>1 on the dp x tp x sp mesh: a lax.scan chains decode
    steps inside shard_map (round 5 — the dense path's dispatch
    amortization now composes with the sharded cache).  Greedy
    generations must be token-identical to the plain engines."""
    mesh = Mesh(
        np.array(jax.devices()[:8]).reshape(2, 2, 2), ("dp", "tp", "sp")
    )
    prompts = [[5, 6, 7, 8], list(range(10, 40)), list(range(100, 180))]

    def run(mesh=None, multi_step=1, **kw):
        eng = DecodeEngine(
            params, CFG, max_batch=4, max_len=512, eos_id=-1,
            harvest_lag=2, mesh=mesh, multi_step=multi_step,
            kv_quant=kv_quant, **kw,
        )
        for i, p in enumerate(prompts):
            eng.submit(
                Request(uid=i, prompt=p, max_new_tokens=7, temperature=0.0)
            )
        return eng.run()

    ref = run()
    got = run(mesh=mesh, head_axis="tp", seq_axis="sp", multi_step=3)
    assert ref == got


@pytest.mark.parametrize(
    "variant", ["softcap", "alibi", "softcap_int8"]
)
def test_sp_tp_sharded_decode_softcap_alibi(variant):
    """softcap / ALiBi models serve on the full dp x tp x sp topology
    with generations identical to the dp-only engine (round 5: the
    sharded path carries every score transform — ref kernels.metal:
    600-883 keeps all features in its one production path).  ALiBi's
    distances must come out in GLOBAL position space on every sp shard,
    and its [H] slopes slice per tp shard."""
    import dataclasses

    kv_quant = "int8" if variant.endswith("int8") else None
    if variant.startswith("softcap"):
        cfg = dataclasses.replace(CFG, attn_softcap=30.0)
    else:
        cfg = dataclasses.replace(CFG, attn_alibi=True)
    params_v = init_params(jax.random.PRNGKey(3), cfg)
    mesh = Mesh(
        np.array(jax.devices()[:8]).reshape(2, 2, 2), ("dp", "tp", "sp")
    )
    prompts = [[5, 6, 7, 8], list(range(10, 40)), list(range(100, 180))]

    def run(mesh=None, **kw):
        eng = DecodeEngine(
            params_v, cfg, max_batch=4, max_len=512, eos_id=-1,
            harvest_lag=2, mesh=mesh, kv_quant=kv_quant, **kw,
        )
        for i, p in enumerate(prompts):
            eng.submit(
                Request(uid=i, prompt=p, max_new_tokens=6, temperature=0.0)
            )
        return eng.run()

    ref = run()
    got = run(mesh=mesh, head_axis="tp", seq_axis="sp")
    assert ref == got


CFG_DRAFT = ModelConfig(
    vocab_size=256,
    d_model=128,
    n_layers=1,
    n_heads=2,
    n_kv_heads=1,
    head_dim=64,
    d_ff=128,
    max_seq_len=512,
    dtype=jnp.float32,
)


def _spec_generate(params, params_d, mesh=None, seq_axis=None,
                   head_axis=None, temperature=0.0):
    """Speculative engine run whose verify windows straddle the sp-shard
    boundary: with sp=4 over max_len=512 each shard owns 128 positions,
    and the 122/124-token prompts put the first verify rounds right on
    the 128 crossing."""
    eng = DecodeEngine(
        params,
        CFG,
        max_batch=4,
        max_len=512,
        eos_id=-1,
        harvest_lag=2,
        draft=(params_d, CFG_DRAFT),
        spec_gamma=3,
        mesh=mesh,
        seq_axis=seq_axis,
        head_axis=head_axis,
    )
    prompts = [
        [5, 6, 7, 8],
        list(range(10, 40)),
        list(range(100, 222)),  # len 122: round 2+ straddles shard 0->1
        list(range(30, 154)),  # len 124
    ]
    for i, p in enumerate(prompts):
        eng.submit(
            Request(
                uid=i, prompt=p, max_new_tokens=14, temperature=temperature
            )
        )
    return eng.run()


def test_spec_sp_sharded_matches_unsharded(params):
    """Speculative serving on a dp x sp mesh: greedy generations equal
    BOTH the unsharded speculative engine and the plain (draft-free)
    engine — the sharded verify chunk (per-row shard ownership,
    runtime/sp_decode.py speculative_step) changes only the dispatch
    count, never the tokens."""
    params_d = init_params(jax.random.PRNGKey(1), CFG_DRAFT)
    want_spec = _spec_generate(params, params_d)
    got = _spec_generate(params, params_d, mesh=_sp_mesh(), seq_axis="sp")
    assert want_spec == got


def test_spec_tp_sharded_matches_unsharded(params):
    params_d = init_params(jax.random.PRNGKey(1), CFG_DRAFT)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))
    want_spec = _spec_generate(params, params_d)
    got = _spec_generate(params, params_d, mesh=mesh, head_axis="tp")
    assert want_spec == got


def test_spec_dp_tp_sp_sharded_matches_unsharded(params):
    """Full topology: slots over dp, heads over tp, KV length over sp,
    with a draft model proposing — greedy output invariant."""
    params_d = init_params(jax.random.PRNGKey(1), CFG_DRAFT)
    mesh = Mesh(
        np.array(jax.devices()[:8]).reshape(2, 2, 2), ("dp", "tp", "sp")
    )
    want_spec = _spec_generate(params, params_d)
    got = _spec_generate(
        params, params_d, mesh=mesh, head_axis="tp", seq_axis="sp"
    )
    assert want_spec == got


def test_spec_sp_sampling_smoke(params):
    """Sampled slots on the sharded spec path emit the right counts and
    in-vocab tokens (distribution preserved by the shared acceptance
    rule; exact stream equality is not required across meshes)."""
    params_d = init_params(jax.random.PRNGKey(1), CFG_DRAFT)
    out = _spec_generate(
        params, params_d, mesh=_sp_mesh(), seq_axis="sp", temperature=0.9
    )
    assert sorted(out.keys()) == [0, 1, 2, 3]
    for toks in out.values():
        assert len(toks) == 14
        assert all(0 <= t < CFG.vocab_size for t in toks)


def test_long_context_32k_int8_sp_decode_matches_single_device():
    """BASELINE config-5 scaled-down witness: a 32K-token int8 KV cache
    sharded x8 over sp (4K per shard), decode near the 30K mark — the
    sharded step's greedy token and its logprob equal the single-device
    int8 decode exactly (the cross-shard lse combine is the kernel's own
    online-softmax merge, so there is no tolerance to hide behind).

    The cache is filled directly (not via prefill) so the witness runs in
    CI time; shard ownership is still fully exercised: slot 0's write
    head lands in sp shard 7, slot 1's in shard 0.
    """
    import dataclasses

    from flash_attention_metal_tpu.runtime.decode import (
        decode_and_sample as dense_decode_and_sample,
    )
    from flash_attention_metal_tpu.runtime.kv_cache import init_quant_cache
    from flash_attention_metal_tpu.runtime.sp_decode import SpStepFns

    max_len = 32768
    cache = init_quant_cache(CFG.n_layers, 2, CFG.n_kv_heads, max_len, 64)
    kshape = cache.k_q.shape
    rk = jax.random.PRNGKey(3)
    fill = dataclasses.replace(
        cache,
        k_q=jax.random.randint(rk, kshape, -127, 128, jnp.int8),
        v_q=jax.random.randint(jax.random.fold_in(rk, 1), kshape, -127, 128,
                               jnp.int8),
        k_scale=jax.random.uniform(
            jax.random.fold_in(rk, 2), kshape[:-1], jnp.float32, 0.005, 0.02
        ),
        v_scale=jax.random.uniform(
            jax.random.fold_in(rk, 3), kshape[:-1], jnp.float32, 0.005, 0.02
        ),
        lengths=jnp.asarray([29873, 121], jnp.int32),
    )
    params = init_params(jax.random.PRNGKey(0), CFG)
    tokens = jnp.asarray([5, 9], jnp.int32)
    active = jnp.asarray([True, True])
    temps = jnp.zeros((2,), jnp.float32)  # greedy: key-independent
    key = jax.random.PRNGKey(7)

    # Both decode fns donate the cache: give each its own buffer copy.
    fill2 = jax.tree_util.tree_map(jnp.copy, fill)
    toks_ref, logp_ref, _ = dense_decode_and_sample(
        params, CFG, fill, tokens, active, key, temps
    )

    mesh = Mesh(np.array(jax.devices()).reshape(1, 8), ("dp", "sp"))
    sp = SpStepFns(mesh, CFG, batch_axis="dp", seq_axis="sp")
    toks_sp, logp_sp, _, _ = sp.decode_and_sample(
        params, fill2, tokens, active, key, temps
    )

    np.testing.assert_array_equal(np.asarray(toks_sp), np.asarray(toks_ref))
    np.testing.assert_allclose(
        np.asarray(logp_sp), np.asarray(logp_ref), atol=2e-5
    )


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_sharded_decode_step_logits_match_single_device(params, kv_quant):
    """``SpStepFns.decode_step`` -- the logits a dp x tp x sp engine
    computes, taken teacher-forced -- equals ``decode.decode_step``."""
    import dataclasses

    from flash_attention_metal_tpu.runtime.decode import decode_step
    from flash_attention_metal_tpu.runtime.kv_cache import (
        init_cache,
        init_quant_cache,
    )
    from flash_attention_metal_tpu.runtime.sp_decode import SpStepFns

    shape = (CFG.n_layers, 2, CFG.n_kv_heads, 512, CFG.head_dim)
    rk = jax.random.PRNGKey(3)
    lengths = jnp.asarray([300, 17], jnp.int32)
    if kv_quant:
        cache = init_quant_cache(*shape)
        cache = dataclasses.replace(
            cache,
            k_q=jax.random.randint(rk, shape, -127, 128, jnp.int8),
            v_q=jax.random.randint(jax.random.fold_in(rk, 1), shape, -127,
                                   128, jnp.int8),
            k_scale=jnp.full(shape[:-1], 0.01, jnp.float32),
            v_scale=jnp.full(shape[:-1], 0.02, jnp.float32),
            lengths=lengths,
        )
    else:
        cache = init_cache(*shape, dtype=CFG.dtype)
        cache = dataclasses.replace(
            cache,
            k=jax.random.normal(rk, shape, CFG.dtype),
            v=jax.random.normal(jax.random.fold_in(rk, 1), shape, CFG.dtype),
            lengths=lengths,
        )
    tokens = jnp.asarray([5, 9], jnp.int32)
    active = jnp.asarray([True, True])
    # Both steps donate the cache: give each its own buffers.
    cache2 = jax.tree_util.tree_map(jnp.copy, cache)
    want, _ = decode_step(params, CFG, cache, tokens, active)
    mesh = Mesh(
        np.array(jax.devices()[:8]).reshape(2, 2, 2), ("dp", "tp", "sp")
    )
    sp = SpStepFns(mesh, CFG, seq_axis="sp", head_axis="tp")
    got, new_cache = sp.decode_step(params, cache2, tokens, active)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(new_cache.lengths), [301, 18])
