"""Checkpoint, scaling-harness, timing and debug-helper tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_metal_tpu.utils.checkpoint import restore_pytree, save_pytree
from flash_attention_metal_tpu.runtime import init_cache


@pytest.fixture(params=["orbax", "pickle"])
def ckpt_backend(request, monkeypatch):
    """Both save paths: Orbax, and the pickle fallback used where Orbax
    is not installed (the GPU machine is not sure to have it)."""
    from flash_attention_metal_tpu.utils import checkpoint

    if request.param == "pickle":
        monkeypatch.setattr(checkpoint, "_HAS_ORBAX", False)
    return request.param


def test_checkpoint_roundtrip_params(tmp_path, ckpt_backend):
    tree = {
        "w": jnp.arange(12.0).reshape(3, 4),
        "layers": [{"b": jnp.ones((2,))}, {"b": jnp.zeros((2,))}],
    }
    path = str(tmp_path / "ckpt")
    save_pytree(path, tree)
    restored = restore_pytree(path, like=tree)
    for a, b in zip(
        jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(restored)
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_kv_cache_snapshot(tmp_path, ckpt_backend):
    """Decode-loop restart state: the KV cache snapshot (SURVEY.md §5)."""
    cache = init_cache(2, 2, 2, 256, 64, dtype=jnp.float32)
    cache.lengths = cache.lengths.at[0].set(7)
    path = str(tmp_path / "kv")
    save_pytree(path, cache)
    restored = restore_pytree(path, like=cache)
    assert int(restored.lengths[0]) == 7
    assert restored.k.shape == cache.k.shape


def test_scaling_harness_smoke():
    from flash_attention_metal_tpu.harness.scaling import run_scaling

    rows = run_scaling(
        n_global=512, heads=2, shard_counts=[1, 2], log=lambda *_: None
    )
    assert [r["shards"] for r in rows] == [1, 2]
    assert all(r["tokens_per_s"] > 0 for r in rows)
    assert rows[0]["scaling_efficiency"] == pytest.approx(1.0)


def test_checked_catches_nan():
    from flash_attention_metal_tpu.utils.debug import checked

    import jax.numpy as jnp
    from jax.experimental import checkify

    def bad(x):
        return jnp.log(x)  # NaN for negative input

    safe = checked(bad)
    safe(jnp.ones(4))  # fine
    with pytest.raises(checkify.JaxRuntimeError):
        safe(-jnp.ones(4))


def test_assert_all_finite():
    from flash_attention_metal_tpu.utils.debug import assert_all_finite

    import jax.numpy as jnp

    assert_all_finite({"a": jnp.ones(3)}, "tree")
    with pytest.raises(FloatingPointError, match="a"):
        assert_all_finite({"a": jnp.array([1.0, jnp.nan])}, "tree")


def test_measure_compiled_orders_work():
    """Host-clock timing waits for the device: more work reads slower."""
    import jax.numpy as jnp

    from flash_attention_metal_tpu.utils.timing import measure_compiled

    x = jnp.ones((256, 256), jnp.float32)

    def slow(a):
        for _ in range(16):
            a = a @ a * 1e-3
        return a

    def fast(a):
        return a + 1.0

    t_slow = measure_compiled(slow, (x,), iters=5)
    t_fast = measure_compiled(fast, (x,), iters=5)
    assert t_slow["median_s"] > t_fast["median_s"] > 0
    assert t_slow["iters"] == 5
