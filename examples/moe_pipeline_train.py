"""Pipeline-parallel and expert-parallel training examples (4-axis meshes).

Run without hardware on a virtual mesh:

    JAX_PLATFORMS=cpu FLASH_ATTENTION_INTERPRET=1 \
      XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/moe_pipeline_train.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import optax

from flash_attention_metal_tpu.utils.comp_cache import enable_compilation_cache
from flash_attention_metal_tpu.models import ModelConfig, init_params
from flash_attention_metal_tpu.models.moe import (
    MoEConfig,
    init_moe_params,
    make_moe_optax_step,
)
from flash_attention_metal_tpu.models.pipeline import (
    make_pp_optax_step,
    stack_layer_params,
)
from flash_attention_metal_tpu.parallel import make_mesh


def pipeline_demo(n_dev: int) -> None:
    """GPipe pipeline over (dp, pp, tp, sp) = (1, 2, 2, 2)."""
    mesh = make_mesh(
        (1, 2, 2, 2) if n_dev >= 8 else (1, 1, 1, n_dev),
        axis_names=("dp", "pp", "tp", "sp"),
        devices=jax.devices()[: 8 if n_dev >= 8 else n_dev],
    )
    cfg = ModelConfig(
        vocab_size=1024,
        d_model=128,
        n_layers=4,
        n_heads=4,
        n_kv_heads=2,
        head_dim=64,
        d_ff=256,
        max_seq_len=512,
        dtype=jnp.float32,
    )
    params = stack_layer_params(init_params(jax.random.PRNGKey(0), cfg))
    opt = optax.adamw(3e-3)
    opt_state = opt.init(params)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (8, 256), 0, 1024)
    step = make_pp_optax_step(mesh, cfg, opt, n_micro=4)
    for i in range(5):
        params, opt_state, loss = step(params, opt_state, tokens)
        print(f"[pipeline] step {i}: loss {float(loss):.4f}")


def moe_demo(n_dev: int) -> None:
    """MoE over (dp, ep, tp, sp) = (1, 4, 2, 1): 8 experts, top-2."""
    mesh = make_mesh(
        (1, 4, 2, 1) if n_dev >= 8 else (1, 1, 1, n_dev),
        axis_names=("dp", "ep", "tp", "sp"),
        devices=jax.devices()[: 8 if n_dev >= 8 else n_dev],
    )
    cfg = MoEConfig(
        vocab_size=1024,
        d_model=128,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        head_dim=64,
        d_ff=256,
        max_seq_len=512,
        dtype=jnp.float32,
        n_experts=8,
        top_k=2,
        capacity_factor=1.5,
    )
    params = init_moe_params(jax.random.PRNGKey(0), cfg)
    opt = optax.adamw(3e-3)
    opt_state = opt.init(params)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (8, 256), 0, 1024)
    step = make_moe_optax_step(mesh, cfg, opt)
    for i in range(5):
        params, opt_state, loss = step(params, opt_state, tokens)
        print(f"[moe] step {i}: loss {float(loss):.4f}")


def main() -> int:
    enable_compilation_cache()
    n_dev = len(jax.devices())
    pipeline_demo(n_dev)
    moe_demo(n_dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
