"""LoRA fine-tuning: adapter-only training over a frozen FlashLM base.

Run on the GPU, or on the CPU with the kernels interpreted:
    python examples/finetune_lora.py --steps 20 --rank 8
    JAX_PLATFORMS=cpu FLASH_ATTENTION_INTERPRET=1 \
      python examples/finetune_lora.py --steps 20 --rank 8

Demonstrates the parameter-efficient loop: the base model stays frozen
(bit-identical), AdamW state is adapter-sized, and the merged tree drops
straight into the serving engine.
"""

import argparse

import jax
import jax.numpy as jnp

from flash_attention_metal_tpu.utils.comp_cache import enable_compilation_cache
from flash_attention_metal_tpu.models import (
    LoRAConfig,
    ModelConfig,
    init_lora,
    init_params,
    lora_num_params,
    make_lora_train_step,
    merge_lora,
)
from flash_attention_metal_tpu.models.trainer import synthetic_batches
from flash_attention_metal_tpu.runtime import DecodeEngine, Request


def main():
    enable_compilation_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    args = ap.parse_args()

    cfg = ModelConfig(
        vocab_size=1024, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2,
        head_dim=64, d_ff=512, max_seq_len=512,
    )
    lcfg = LoRAConfig(rank=args.rank)

    key = jax.random.PRNGKey(0)
    params = init_params(key, cfg)  # stand-in for a pretrained checkpoint
    adapters = init_lora(jax.random.PRNGKey(1), params, lcfg)
    n_base = sum(x.size for x in jax.tree_util.tree_leaves(params))
    print(
        f"base params: {n_base/1e6:.1f}M, trainable (LoRA r={args.rank}): "
        f"{lora_num_params(adapters)/1e3:.1f}K "
        f"({100*lora_num_params(adapters)/n_base:.2f}%)"
    )

    step, opt_init = make_lora_train_step(cfg, lcfg)
    opt_state = opt_init(adapters)
    batches = synthetic_batches(cfg, args.batch, args.seq)
    for i in range(args.steps):
        adapters, opt_state, loss = step(
            adapters, opt_state, params, next(batches)
        )
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i}: loss {float(loss):.4f}")

    # Merge and serve.
    merged = merge_lora(params, adapters, lcfg)
    eng = DecodeEngine(merged, cfg, max_batch=2, max_len=512)
    eng.submit(Request(uid=0, prompt=[1, 2, 3, 4], max_new_tokens=16))
    out = eng.run()
    print("merged-model generation:", out[0])


if __name__ == "__main__":
    main()
