"""Harness tests: kernel checks at small sizes, the roofline table, the
route decision, the compile cache, and lowering for the GPU."""

import jax
import jax.numpy as jnp
import pytest

from flash_attention_metal_tpu.harness import CHECKS, SMALL
from flash_attention_metal_tpu.utils import (
    attention_flops,
    roofline_fraction,
    roofline_time,
)


@pytest.mark.parametrize("check", sorted(CHECKS))
def test_ladder_all_pass(check):
    """Every kernel check of ``harness/verify.py`` passes at small sizes
    in interpret mode (the same checks run at full width on the card)."""
    results = CHECKS[check](SMALL)
    assert results
    for r in results:
        assert r.passed, r.line()


def test_roofline_model():
    # 1 TFLOP-class attention at bf16 on the H100 SXM peak (989e12).
    from flash_attention_metal_tpu.utils.roofline import CHIP_SPECS

    spec = CHIP_SPECS["NVIDIA H100 80GB HBM3"]
    f = attention_flops(1, 8, 4096, 4096, 64)
    t = roofline_time(f, 1e6, spec)
    assert t == pytest.approx(f / 989e12)
    # Fraction at exactly the roofline time is 1.0.
    assert roofline_fraction(t, f, 1e6, spec) == pytest.approx(1.0)
    # Tiny kernel is bandwidth-bound.
    assert roofline_time(1.0, 1e9, spec) == pytest.approx(1e9 / 3.35e12)


@pytest.mark.parametrize(
    "kind", ["cpu", "NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB"]
)
def test_roofline_unknown_device_raises(kind):
    """A device without data-sheet peaks is an error, never a default."""
    from flash_attention_metal_tpu.utils.roofline import chip_spec

    with pytest.raises(KeyError, match="no peak rates"):
        chip_spec(kind)


def test_flops_model_causal_and_bwd():
    f = attention_flops(2, 4, 1024, 1024, 64)
    assert f == 4 * 2 * 4 * 1024 * 1024 * 64
    assert attention_flops(2, 4, 1024, 1024, 64, causal=True) == f / 2
    assert attention_flops(2, 4, 1024, 1024, 64, backward=True) == f * 2.5


def test_train_bench_flops_model():
    from flash_attention_metal_tpu.harness.train_bench import (
        model_flops_per_token,
    )
    from flash_attention_metal_tpu.models import ModelConfig

    cfg = ModelConfig(
        vocab_size=1024,
        d_model=256,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        head_dim=64,
        d_ff=512,
        max_seq_len=512,
    )
    f = model_flops_per_token(cfg, seq=512)
    # 6x matmul params dominates at tiny seq; sanity-bound the model.
    params = 2 * (256 * 64 * 8 + 4 * 64 * 256 + 3 * 256 * 512) + 1024 * 256
    assert f > 6 * params
    assert f < 12 * params + 7 * 2 * 4 * 64 * 512


def test_interpret_needs_the_switch(monkeypatch):
    """Off the GPU the kernels interpret only on request; without the
    switch the route decision raises and names it."""
    from flash_attention_metal_tpu.kernels._common import (
        INTERPRET_ENV,
        pallas_interpret,
    )

    monkeypatch.setenv(INTERPRET_ENV, "1")
    assert pallas_interpret() is True
    monkeypatch.delenv(INTERPRET_ENV)
    with pytest.raises(RuntimeError, match=INTERPRET_ENV):
        pallas_interpret()


def test_interpret_switch_reaches_the_op(monkeypatch):
    """``impl="auto"`` on the CPU raises without the switch; the plain
    XLA path needs none."""
    from flash_attention_metal_tpu.kernels._common import INTERPRET_ENV
    from flash_attention_metal_tpu.ops import flash_attention

    jax.clear_caches()
    q = jnp.ones((1, 1, 16, 16), jnp.float32)
    monkeypatch.delenv(INTERPRET_ENV)
    with pytest.raises(RuntimeError, match=INTERPRET_ENV):
        flash_attention(q, q, q, causal=True)
    assert flash_attention(q, q, q, causal=True, impl="xla").shape == q.shape
    jax.clear_caches()


@pytest.mark.parametrize(
    "features",
    [
        dict(dtype=jnp.bfloat16, head_dim=128, n_q=4096, n_kv=4096),
        dict(dtype=jnp.bfloat16, head_dim=128, q_offset=0),
        dict(dtype=jnp.float32, head_dim=64, softcap=30.0),
    ],
)
def test_select_impl_off_gpu_is_pallas(features):
    from flash_attention_metal_tpu.ops.attention import select_impl

    assert select_impl(**features) == "pallas"


@pytest.mark.parametrize(
    "features,end",
    [
        (dict(dtype=jnp.bfloat16, head_dim=128, n_q=4096, n_kv=4096),
         "cudnn"),
        (dict(dtype=jnp.bfloat16, head_dim=128, n_q=1, n_kv=4096,
              q_offset=4095), "pallas"),
    ],
)
def test_select_impl_on_gpu_follows_cudnn_cover(monkeypatch, features, end):
    """On the GPU ``auto`` takes cuDNN exactly where ``cudnn_covers``."""
    from flash_attention_metal_tpu.ops import attention

    monkeypatch.setattr(attention.jax, "default_backend", lambda: "gpu")
    assert attention.select_impl(**features) == end


@pytest.mark.parametrize(
    "impl,kw,kind,end",
    [
        ("xla", dict(causal=True), "causal", "xla"),
        ("auto", dict(causal=False), "non-causal", "pallas"),
        ("xla", dict(causal=True, q_offset=4), "causal, q_offset", "xla"),
    ],
)
def test_traced_ends_record_the_end_taken(impl, kw, kind, end):
    """The op records the end it resolved to, by call kind."""
    from flash_attention_metal_tpu.ops import flash_attention
    from flash_attention_metal_tpu.ops.attention import traced_ends

    traced_ends(clear=True)
    q = jax.random.normal(jax.random.PRNGKey(0), (1, 2, 16, 16))
    flash_attention(q, q, q, impl=impl, **kw)
    assert traced_ends(clear=True) == {(kind, end): 1}


@pytest.mark.parametrize(
    "features,covered",
    [
        (dict(dtype=jnp.bfloat16, head_dim=128, n_q=4096, n_kv=4096), True),
        (dict(dtype=jnp.float16, head_dim=64, n_q=512, n_kv=512), True),
        (dict(dtype=jnp.float32, head_dim=128, n_q=512, n_kv=512), False),
        (dict(dtype=jnp.bfloat16, head_dim=256, n_q=512, n_kv=512), False),
        (dict(dtype=jnp.bfloat16, head_dim=128, n_q=1, n_kv=512), False),
        (dict(dtype=jnp.bfloat16, head_dim=128, softcap=30.0), False),
        (dict(dtype=jnp.bfloat16, head_dim=128, save_lse=True), False),
        (dict(dtype=jnp.bfloat16, head_dim=128, window=128), False),
        (dict(dtype=jnp.bfloat16, head_dim=128, dropout_rate=0.1), False),
        (dict(dtype=jnp.bfloat16, head_dim=128, q_offset=3), False),
    ],
)
def test_cudnn_covers(features, covered):
    """cuDNN is chosen only for the feature set that was measured."""
    from flash_attention_metal_tpu.ops.attention import cudnn_covers

    features.setdefault("n_q", 128)
    features.setdefault("n_kv", 128)
    assert cudnn_covers(**features) is covered


def test_compilation_cache_honours_env(monkeypatch, tmp_path):
    """With ``JAX_COMPILATION_CACHE_DIR`` set, the program sets no cache
    directory of its own; without it, the fixed in-checkout one."""
    from flash_attention_metal_tpu.utils import comp_cache

    updates = []
    monkeypatch.setattr(
        comp_cache.jax.config, "update", lambda k, v: updates.append((k, v))
    )
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert comp_cache.enable_compilation_cache() == str(tmp_path)
    assert updates == []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert comp_cache.enable_compilation_cache() == comp_cache.DEFAULT_DIR
    assert ("jax_compilation_cache_dir", comp_cache.DEFAULT_DIR) in updates
    assert comp_cache.DEFAULT_DIR.endswith(".jax_cache")


def _lower_for_gpu(monkeypatch, fn, *args):
    """Lower ``fn`` for CUDA on this CPU host: the Triton lowering of
    every kernel runs (block shapes, dot shapes, supported primitives);
    compiling Triton IR to PTX happens only on the card."""
    import flash_attention_metal_tpu.kernels.flash_bwd as bwd
    import flash_attention_metal_tpu.kernels.flash_fwd as fwd

    monkeypatch.setattr(fwd, "pallas_interpret", lambda: False)
    monkeypatch.setattr(bwd, "pallas_interpret", lambda: False)
    jax.clear_caches()
    try:
        exported = jax.export.export(
            jax.jit(fn),
            platforms=["cuda"],
            disabled_checks=[
                jax.export.DisabledSafetyCheck.custom_call(
                    "__gpu$xla.gpu.triton"
                )
            ],
        )(*args)
    finally:
        jax.clear_caches()
    text = exported.mlir_module()
    assert "__gpu$xla.gpu.triton" in text
    return text


def _spec(*shape, dtype=jnp.bfloat16):
    return jax.ShapeDtypeStruct(shape, dtype)


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float16, jnp.float32])
@pytest.mark.parametrize(
    "kw",
    [
        dict(causal=True),
        dict(causal=False),
        dict(causal=True, window=64, sinks=4, softcap=20.0),
    ],
    ids=["causal", "full", "window-sinks-softcap"],
)
def test_train_kernels_lower_for_gpu(monkeypatch, dtype, kw):
    """Forward + both backward kernels lower through Triton at Llama
    head dim 128 with GQA 4."""
    from flash_attention_metal_tpu.ops import flash_attention

    def grads(q, k):
        def loss(q, k):
            o = flash_attention(q, k, k, impl="pallas", **kw)
            return o.astype(jnp.float32).sum()

        return jax.grad(loss, (0, 1))(q, k)

    text = _lower_for_gpu(
        monkeypatch, grads, _spec(1, 8, 256, 128, dtype=dtype),
        _spec(1, 2, 256, 128, dtype=dtype),
    )
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        assert name in text


def test_feature_kernels_lower_for_gpu(monkeypatch):
    from flash_attention_metal_tpu.config import SegmentIds
    from flash_attention_metal_tpu.ops import flash_attention

    def grads(q, seg, slopes):
        def loss(q, slopes):
            o, lse = flash_attention(
                q, q, q, segment_ids=SegmentIds(seg, seg), causal=True,
                alibi_slopes=slopes, dropout_rate=0.1,
                dropout_seed=jnp.int32(3), save_lse=True, impl="pallas",
            )
            return o.astype(jnp.float32).sum() + lse.sum()

        return jax.grad(loss, (0, 1))(q, slopes)

    _lower_for_gpu(monkeypatch, grads, _spec(2, 4, 256, 64),
                   _spec(2, 256, dtype=jnp.int32),
                   _spec(4, dtype=jnp.float32))


@pytest.mark.parametrize(
    "cache", ["dense", "int8", "fp8", "paged", "paged-int8", "rolling"]
)
def test_decode_kernels_lower_for_gpu(monkeypatch, cache):
    """Decode against every cache kind lowers through Triton (T=1, GQA
    fold 4, head dim 128)."""
    from flash_attention_metal_tpu.kernels import (
        flash_attention_paged,
        flash_attention_paged_quant,
        flash_attention_quant,
        quantize_kv,
    )
    from flash_attention_metal_tpu.ops import flash_attention
    from flash_attention_metal_tpu.ops.attention import gqa_decode_attention

    q = _spec(4, 8, 4, 128)  # folded [B, H_kv, T * group, D]
    kv = _spec(4, 8, 1024, 128)
    lens = _spec(4, dtype=jnp.int32)
    pool = _spec(64, 8, 64, 128)
    table = _spec(4, 16, dtype=jnp.int32)
    if cache == "dense":
        fn, args = gqa_decode_attention, (_spec(4, 32, 1, 128), kv, kv, lens)
    elif cache in ("int8", "fp8"):
        dt = jnp.int8 if cache == "int8" else jnp.float8_e4m3fn
        fn = lambda q, k, l: flash_attention_quant(  # noqa: E731
            q, quantize_kv(k, k, dt), l, causal=True, pos_div=4)
        args = (q, kv, lens)
    elif cache == "paged":
        fn = lambda q, p, t, l: flash_attention_paged(  # noqa: E731
            q, p, p, t, l, pos_div=4)
        args = (q, pool, table, lens)
    elif cache == "paged-int8":
        fn = lambda q, p, s, t, l: flash_attention_paged_quant(  # noqa: E731
            q, p, p, s, s, t, l, pos_div=4)
        args = (q, _spec(64, 8, 64, 128, dtype=jnp.int8),
                _spec(64, 8, 64, dtype=jnp.float32), table, lens)
    else:
        fn = lambda q, k, p, l: flash_attention(  # noqa: E731
            q, k, k, l, kv_positions=p, causal=True, window=500, sinks=4)
        args = (_spec(4, 32, 1, 128), kv, _spec(4, 1024, dtype=jnp.int32),
                lens)
    _lower_for_gpu(monkeypatch, fn, *args)
