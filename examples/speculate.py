"""Speculative decoding example: a small draft accelerates a larger target.

    timeout 590 python examples/speculate.py [--gamma 4] [--temperature 0]

With randomly initialized weights the draft rarely agrees with the
target, so most rounds emit 1-2 tokens — the point of the example is the
guarantee: at temperature 0 the output is token-for-token identical to
the target model's own greedy decode, whatever the draft proposes.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import argparse

import jax
import jax.numpy as jnp
import numpy as np

from flash_attention_metal_tpu.utils.comp_cache import enable_compilation_cache
from flash_attention_metal_tpu.models import ModelConfig, init_params
from flash_attention_metal_tpu.runtime import speculative_generate


def main() -> int:
    enable_compilation_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--gamma", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--max-new", type=int, default=32)
    args = ap.parse_args()

    kw = dict(vocab_size=32768, head_dim=64, max_seq_len=2048,
              dtype=jnp.bfloat16)
    cfg_t = ModelConfig(d_model=512, n_layers=4, n_heads=8, n_kv_heads=4,
                        d_ff=2048, **kw)
    cfg_d = ModelConfig(d_model=128, n_layers=1, n_heads=2, n_kv_heads=1,
                        d_ff=256, **kw)
    params_t = init_params(jax.random.PRNGKey(0), cfg_t)
    params_d = init_params(jax.random.PRNGKey(1), cfg_d)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 32768, n).tolist() for n in (64, 17, 100)]
    out = speculative_generate(
        params_t, cfg_t, params_d, cfg_d, prompts, args.max_new,
        gamma=args.gamma, temperature=args.temperature,
    )
    for i, toks in enumerate(out):
        print(f"prompt {i}: {len(toks)} tokens, first 8: {toks[:8]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
