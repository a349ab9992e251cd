"""Serving benchmark: continuous-batching decode throughput on one chip.

The reference has no serving layer; this is the single-chip half of
BASELINE.json config 5 ("ring flash-attention decode ... fp8 KV +
continuous batching") — steady-state decode tokens/s and per-step latency
of the ``DecodeEngine`` on a FlashLM model, with the multi-chip scaling
story covered by ``harness/scaling.py`` and ``parallel/``.

Run: ``timeout 590 python -m flash_attention_metal_tpu.harness.serving``
Writes ``serving_bench.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..models import ModelConfig, init_params
from ..runtime.engine import DecodeEngine, Request


def build_engine(
    *,
    max_batch: int = 8,
    max_len: int = 2048,
    n_layers: int = 4,
    d_model: int = 512,
    n_heads: int = 8,
    n_kv_heads: int = 4,
    d_ff: int = 2048,
    vocab: int = 32768,
    seed: int = 0,
    weight_quant: bool = False,
    **engine_kwargs,
) -> tuple:
    cfg = ModelConfig(
        vocab_size=vocab,
        d_model=d_model,
        n_layers=n_layers,
        n_heads=n_heads,
        n_kv_heads=n_kv_heads,
        head_dim=64,
        d_ff=d_ff,
        max_seq_len=max_len,
        dtype=jnp.bfloat16,
    )
    params = init_params(jax.random.PRNGKey(seed), cfg)
    if weight_quant:
        # Weight-only int8 serving (models/wquant.py): int8 HBM traffic
        # for every dense matmul weight incl. lm_head.
        from ..models import quantize_weights

        params = quantize_weights(params)
    eng = DecodeEngine(
        params, cfg, max_batch=max_batch, max_len=max_len, **engine_kwargs
    )
    return eng, cfg


def run_serving_bench(
    *,
    max_batch: int = 8,
    n_requests: int = 16,
    prompt_len: int = 128,
    max_new: int = 128,
    paged: bool = False,
    shared_prefix: int = 0,
    multi_step: int = 1,
    weight_quant: bool = False,
    log=print,
) -> dict:
    """One steady-state decode run.

    ``paged=True`` swaps the contiguous slot cache for the pooled
    page-table cache (``runtime/paged_kv.py``); ``shared_prefix > 0``
    additionally gives every request the same first ``shared_prefix``
    prompt tokens and enables the engine's prefix registry, so shared
    pages are prefilled once and adopted by later admissions.
    """
    eng, cfg = build_engine(
        max_batch=max_batch,
        weight_quant=weight_quant,
        paged=paged,
        prefix_share=paged and shared_prefix > 0,
        multi_step=multi_step,
    )
    rng = np.random.default_rng(0)
    common = rng.integers(1, cfg.vocab_size, shared_prefix).tolist()
    for uid in range(n_requests):
        tail = rng.integers(
            1, cfg.vocab_size, prompt_len - shared_prefix
        ).tolist()
        eng.submit(
            Request(
                uid=uid,
                prompt=common + tail,
                max_new_tokens=max_new,
            )
        )

    # Warm both executables (prefill admits up to max_batch, decode runs
    # one token) before the timed region, then wait for them: dispatch is
    # asynchronous, so the timer would otherwise start before the warmup
    # executions have finished.
    eng.step()
    eng.step()
    jax.block_until_ready(eng.next_token)

    t0 = time.perf_counter()
    steps0 = eng.steps
    while eng.pending():
        eng.step()
    elapsed = time.perf_counter() - t0
    steps = eng.steps - steps0

    total_tokens = sum(len(r.generated) for r in eng.finished.values())
    result = {
        "mode": "paged" if paged else "dense",
        "host_cpus": os.cpu_count(),
        "shared_prefix": shared_prefix,
        "multi_step": multi_step,
        "model": {
            "n_layers": cfg.n_layers,
            "d_model": cfg.d_model,
            "n_heads": cfg.n_heads,
            "n_kv_heads": cfg.n_kv_heads,
            "d_ff": cfg.d_ff,
            "vocab": cfg.vocab_size,
        },
        "max_batch": max_batch,
        "n_requests": n_requests,
        "prompt_len": prompt_len,
        "max_new": max_new,
        "decode_steps": steps,
        "elapsed_s": elapsed,
        "total_generated_tokens": total_tokens,
        "tokens_per_s": total_tokens / elapsed,
        "ms_per_step": elapsed / max(steps, 1) * 1e3,
    }
    log(
        f"serving[{result['mode']}]: {total_tokens} tokens in {elapsed:.2f}s"
        f" over {steps} steps -> {result['tokens_per_s']:.0f} tok/s,"
        f" {result['ms_per_step']:.1f} ms/step (batch {max_batch})"
    )
    return result


def main() -> int:
    from ..utils.comp_cache import enable_compilation_cache

    enable_compilation_cache()

    ap = argparse.ArgumentParser()
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=128)
    ap.add_argument(
        "--dense-only", action="store_true",
        help="skip the paged / prefix-shared comparison runs",
    )
    ap.add_argument("--multi-step", type=int, default=1)
    args = ap.parse_args()
    common = dict(
        max_batch=args.max_batch,
        n_requests=args.requests,
        prompt_len=args.prompt_len,
        max_new=args.max_new,
        multi_step=args.multi_step,
    )
    result = run_serving_bench(**common)
    if not args.dense_only:
        result["paged"] = run_serving_bench(**common, paged=True)
        result["paged_prefix_shared"] = run_serving_bench(
            **common, paged=True, shared_prefix=args.prompt_len // 2
        )
        result["multi_step_8"] = run_serving_bench(
            **{**common, "multi_step": 8}
        )
        result["weight_int8"] = run_serving_bench(
            **common, weight_quant=True
        )
    with open("serving_bench.json", "w") as f:
        json.dump(result, f, indent=2)
    print("wrote serving_bench.json")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
