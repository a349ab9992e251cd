"""Kernels compiled for the card (not interpreted) at small, unaligned
shapes: the padding and masking paths the full-width checks of
``chip_smoke.py`` do not reach.  They skip off the GPU; ``chip_smoke.py``
runs them on the card.
"""

import jax.numpy as jnp
import pytest

from flash_attention_metal_tpu.harness import CHECKS, SMALL
from flash_attention_metal_tpu.reference import (
    attention_reference_with_lse,
    make_qkv,
)


@pytest.mark.gpu
@pytest.mark.parametrize("check", ["fwd_bwd_bf16_causal", "decode_paged_int8",
                                   "decode_rolling"])
def test_kernel_check_compiled(check):
    from flash_attention_metal_tpu.kernels._common import pallas_interpret

    assert pallas_interpret() is False
    for r in CHECKS[check](SMALL):
        assert r.passed, r.line()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 3, 77, 24), (1, 2, 1, 8)])
def test_unaligned_shapes_compiled(rng_key, shape):
    from flash_attention_metal_tpu.kernels import flash_attention_fwd

    q, k, v = make_qkv(rng_key, shape)
    o, lse = flash_attention_fwd(q, k, v, causal=True, save_lse=True)
    want_o, want_lse = attention_reference_with_lse(q, k, v, causal=True)
    assert float(jnp.max(jnp.abs(o - want_o))) < 1e-3
    assert float(jnp.max(jnp.abs(lse - want_lse))) < 1e-3
