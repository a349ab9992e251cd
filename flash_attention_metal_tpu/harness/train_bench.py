"""Training-step benchmark: FlashLM tokens/s and MFU on one chip.

The reference benchmarks only the attention kernels (``main.mm:596-1207``);
this measures the whole training path the kernels serve — forward, FA-2
backward, SGD update — and reports model FLOPs utilization against the
chip's dense peak (the standard large-scale-training metric).

Run: ``timeout 590 python -m flash_attention_metal_tpu.harness.train_bench``
Writes ``train_bench.json``.
"""

from __future__ import annotations

import argparse
import functools
import json

import jax
import jax.numpy as jnp

from ..models import ModelConfig, init_params
from ..models.transformer import sgd_train_step
from ..utils import chip_spec
from ..utils.timing import measure_compiled


def model_flops_per_token(cfg: ModelConfig, seq: int) -> float:
    """Standard 6N + attention FLOPs-per-token model (training = fwd+bwd).

    6 FLOPs per matmul weight per token (2 fwd + 4 bwd), plus causal
    attention score/value matmuls: 4*H*hd*seq/2 per token forward and
    2.5x that backward -> 7*H*hd*seq per layer per token.
    """
    d, v = cfg.d_model, cfg.vocab_size
    hd = cfg.head_dim
    per_layer_params = (
        d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads)  # q, k, v projections
        + cfg.n_heads * hd * d  # out projection
        + 3 * d * cfg.d_ff  # swiglu mlp (w1, w3, w2)
    )
    matmul_params = cfg.n_layers * per_layer_params + v * d  # + lm_head
    dense = 6 * matmul_params
    attn = 7 * cfg.n_layers * cfg.n_heads * hd * seq
    return dense + attn


def run_train_bench(
    *,
    n_layers: int = 4,
    d_model: int = 1024,
    n_heads: int = 16,
    n_kv_heads: int = 8,
    d_ff: int = 4096,
    vocab: int = 32768,
    batch: int = 8,
    seq: int = 2048,
    softcap: float | None = None,
    log=print,
) -> dict:
    cfg = ModelConfig(
        vocab_size=vocab,
        d_model=d_model,
        n_layers=n_layers,
        n_heads=n_heads,
        n_kv_heads=n_kv_heads,
        head_dim=64,
        d_ff=d_ff,
        max_seq_len=seq,
        dtype=jnp.bfloat16,
        attn_softcap=softcap,
    )
    params = init_params(jax.random.PRNGKey(0), cfg)
    tokens = jax.random.randint(
        jax.random.PRNGKey(1), (batch, seq), 0, cfg.vocab_size
    )
    step = functools.partial(sgd_train_step, cfg=cfg, lr=1e-3)
    t = measure_compiled(step, (params, tokens), iters=6)["median_s"]

    toks = batch * seq
    flops = model_flops_per_token(cfg, seq) * toks
    spec = chip_spec()
    result = {
        "model": {
            "n_layers": n_layers,
            "d_model": d_model,
            "n_heads": n_heads,
            "n_kv_heads": n_kv_heads,
            "d_ff": d_ff,
            "vocab": vocab,
            "attn_softcap": softcap,
        },
        "batch": batch,
        "seq": seq,
        "step_ms": t * 1e3,
        "tokens_per_s": toks / t,
        "model_tflops": flops / t / 1e12,
        "mfu": flops / t / spec.peak_bf16_flops,
        "chip": spec.name,
    }
    log(
        f"train step (L{n_layers} d{d_model} b{batch} s{seq}): "
        f"{t*1e3:.1f} ms, {toks/t:,.0f} tok/s, "
        f"{result['model_tflops']:.1f} TF/s model flops = "
        f"{result['mfu']:.0%} MFU on {spec.name}"
    )
    return result


def main() -> int:
    from ..utils.comp_cache import enable_compilation_cache

    enable_compilation_cache()

    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument(
        "--softcap", type=float, default=None,
        help="tanh logit softcap (Gemma-2 style); exercises the "
        "in-kernel softcap backward on the training path",
    )
    args = ap.parse_args()
    result = run_train_bench(
        n_layers=args.layers,
        d_model=args.d_model,
        batch=args.batch,
        seq=args.seq,
        softcap=args.softcap,
    )
    with open("train_bench.json", "w") as f:
        json.dump(result, f, indent=2)
    print("wrote train_bench.json")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
