"""Multi-device training example: sharded AdamW over a (dp, tp, sp) mesh.

Run without hardware on a virtual mesh:

    JAX_PLATFORMS=cpu FLASH_ATTENTION_INTERPRET=1 \
      XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/sharded_train.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import optax

from flash_attention_metal_tpu.utils.comp_cache import enable_compilation_cache
from flash_attention_metal_tpu.models import ModelConfig, init_params
from flash_attention_metal_tpu.models.parallel_train import (
    make_optax_train_step,
)
from flash_attention_metal_tpu.parallel import make_mesh


def main() -> int:
    enable_compilation_cache()
    n_dev = len(jax.devices())
    shape = (2, 2, 2) if n_dev >= 8 else (1, 1, n_dev)
    mesh = make_mesh(shape, devices=jax.devices()[: shape[0] * shape[1] * shape[2]])
    cfg = ModelConfig(
        vocab_size=2048,
        d_model=256,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        head_dim=64,
        d_ff=512,
        max_seq_len=512,
        dtype=jnp.float32,
    )
    params = init_params(jax.random.PRNGKey(0), cfg)
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-3))
    opt_state = opt.init(params)
    step = make_optax_train_step(mesh, cfg, opt, sp_attn="ring")
    tokens = jax.random.randint(jax.random.PRNGKey(1), (4, 256), 0, 2048)
    for i in range(5):
        params, opt_state, loss = step(params, opt_state, tokens)
        print(f"step {i}: loss {float(loss):.4f} (mesh {dict(mesh.shape)})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
