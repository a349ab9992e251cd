"""Time each end of attention on the card: the Pallas kernels, the plain
XLA version and, where it applies, cuDNN.

``ops.attention.select_impl`` follows what this measured.  Shapes
are the smoke run's (``chip_smoke.py``): Llama-3.1-8B attention widths
(32 query heads, 8 KV heads, head dim 128, bf16); 4096-token training
sequences; decode of 8 sequences against a 32k-token cache; a 2-layer
training step; and the engine's decode step.  Each time is printed as
median [min-max] over its repeats.

Run (GPU only): ``python -m flash_attention_metal_tpu.harness.ends
[attention decode train engine]``
"""

from __future__ import annotations

import dataclasses
import subprocess
import time

import jax
import jax.numpy as jnp

from ..kernels import (
    dequantize_kv,
    flash_attention_paged,
    flash_attention_quant,
    quantize_kv,
)
from ..ops.attention import (
    flash_attention,
    fold_gqa_rows,
    gqa_decode_attention,
    unfold_gqa_rows,
)
from ..utils.timing import measure

HQ, HKV, D = 32, 8, 128


def _ms(fn, *args, iters=20) -> tuple:
    """Median, min and max ms over ``iters`` calls after compilation."""
    f = jax.jit(fn)
    m = measure(lambda: f(*args), warmup=2, iters=iters)
    return tuple(m[k] * 1e3 for k in ("median_s", "min_s", "max_s"))


def _spread(xs) -> tuple:
    xs = sorted(xs)
    return xs[len(xs) // 2], xs[0], xs[-1]


def _row(name, times, log):
    log(f"{name}: " + "  ".join(
        f"{k} {med:.3f} [{lo:.3f}-{hi:.3f}] ms"
        for k, (med, lo, hi) in times.items()))


def attention_ends(log=print):
    key = jax.random.PRNGKey(0)
    n = 4096
    q = jax.random.normal(key, (1, HQ, n, D), jnp.bfloat16)
    k = jax.random.normal(jax.random.PRNGKey(1), (1, HKV, n, D), jnp.bfloat16)
    v = jax.random.normal(jax.random.PRNGKey(2), (1, HKV, n, D), jnp.bfloat16)
    for causal in (True, False):
        fwd, both = {}, {}
        for impl in ("pallas", "cudnn", "xla"):
            fwd[impl] = _ms(lambda q, k, v, i=impl: flash_attention(
                q, k, v, causal=causal, impl=i), q, k, v)
            both[impl] = _ms(jax.grad(
                lambda q, k, v, i=impl: jnp.sum(flash_attention(
                    q, k, v, causal=causal, impl=i).astype(jnp.float32)),
                (0, 1, 2)), q, k, v)
        _row(f"fwd B1 H32/8 N{n} D128 causal={causal}", fwd, log)
        _row(f"fwd+bwd B1 H32/8 N{n} D128 causal={causal}", both, log)


def decode_ends(log=print):
    b, n, page = 8, 32768, 128
    key = jax.random.PRNGKey(0)
    q = jax.random.normal(key, (b, HQ, 1, D), jnp.bfloat16)
    k = jax.random.normal(jax.random.PRNGKey(1), (b, HKV, n, D), jnp.bfloat16)
    v = jax.random.normal(jax.random.PRNGKey(2), (b, HKV, n, D), jnp.bfloat16)
    lens = jnp.full((b,), n - 1, jnp.int32)

    def plain(q, k, v, l):
        return flash_attention(q, k, v, l, causal=True, impl="xla")

    _row("decode dense B8 cache 32k", {
        "pallas": _ms(gqa_decode_attention, q, k, v, lens),
        "xla": _ms(plain, q, k, v, lens)}, log)
    group = HQ // HKV
    for dt in (jnp.int8, jnp.float8_e4m3fn):
        qkv = quantize_kv(k, v, dt)
        _row(f"decode {jnp.dtype(dt).name} B8 cache 32k", {
            "pallas": _ms(lambda q, c, l: unfold_gqa_rows(
                flash_attention_quant(fold_gqa_rows(q, HKV), c, l,
                                      causal=True, pos_div=group), HQ, 1),
                q, qkv, lens),
            "xla (dequantize, then plain)": _ms(
                lambda q, c, l: plain(q, *dequantize_kv(c), l), q, qkv, lens),
        }, log)
    pool_k = (k.reshape(b, HKV, n // page, page, D).swapaxes(1, 2)
              .reshape(b * n // page, HKV, page, D))
    pool_v = (v.reshape(b, HKV, n // page, page, D).swapaxes(1, 2)
              .reshape(b * n // page, HKV, page, D))
    table = jnp.arange(b * n // page, dtype=jnp.int32).reshape(b, -1)

    def gathered(q, pk, pv, t, l):
        dense = lambda p: p[t].swapaxes(1, 2).reshape(b, HKV, n, D)  # noqa
        return plain(q, dense(pk), dense(pv), l)

    _row("decode paged B8 cache 32k", {
        "pallas": _ms(lambda q, pk, pv, t, l: unfold_gqa_rows(
            flash_attention_paged(fold_gqa_rows(q, HKV), pk, pv, t, l,
                                  pos_div=group), HQ, 1),
            q, pool_k, pool_v, table, lens),
        "xla (gather pages, then plain)": _ms(
            gathered, q, pool_k, pool_v, table, lens),
    }, log)


def train_step_ends(log=print):
    from ..models.losses import loss_fn_blockwise
    from ..models.trainer import Trainer, make_optimizer
    from .llama import LLAMA_8B, model_config

    tokens = jax.random.randint(jax.random.PRNGKey(1), (1, 4096), 0,
                                LLAMA_8B["vocab_size"])
    times = {}
    for impl in ("pallas", "cudnn", "xla"):
        cfg = model_config(LLAMA_8B, n_layers=2, attn_impl=impl)
        tr = Trainer(cfg, loss=loss_fn_blockwise,
                     optimizer=make_optimizer(warmup_steps=1))
        tr.step(tokens)
        steps = []
        for _ in range(5):
            t0 = time.perf_counter()
            tr.step(tokens)  # returns the loss as a float: waits
            steps.append((time.perf_counter() - t0) * 1e3)
        times[impl] = _spread(steps)
        del tr
    _row("train step L2 Llama-8B widths 1x4096 (AdamW)", times, log)


# Engine depth: 8 of Llama-3.1-8B's 32 layers keeps the compilation of
# four engines with XLA's GEMM autotuning on within a few minutes; each
# layer's attention is the same at any depth.
ENGINE_LAYERS = 8


def engine_ends(log=print):
    """Engine ms/step at the serve phase's shape (8 slots, 4096-token
    cache, 8 requests x 32 tokens), depth ``ENGINE_LAYERS``: dense with
    ``auto`` and with plain XLA attention, the int8 and paged caches
    (whose kernels are called directly).  Three timed runs each."""
    from ..runtime import DecodeEngine, Request
    from .llama import LLAMA_8B, bf16_params, make_requests, model_config

    cfg = model_config(LLAMA_8B, n_layers=ENGINE_LAYERS)
    params = bf16_params(cfg)
    reqs = make_requests(cfg.vocab_size)
    times = {}
    for name, impl, kw in (("dense auto", "auto", {}),
                           ("dense xla", "xla", {}),
                           ("int8", "auto", {"kv_quant": "int8"}),
                           ("paged", "auto", {"paged": True})):
        c = dataclasses.replace(cfg, attn_impl=impl)
        runs = []
        for new in (2, 32, 32, 32):  # the first engine compiles
            eng = DecodeEngine(params, c, max_batch=8, max_len=4096,
                               eos_id=-1, **kw)
            for uid, prompt, _ in reqs:
                eng.submit(Request(uid=uid, prompt=prompt,
                                   max_new_tokens=new))
            eng.run()
            runs.append(eng.stats()["ms_per_step"])
            del eng
        times[name] = _spread(runs[1:])
    _row(f"engine L{ENGINE_LAYERS} ms/step (8 requests x 32 tokens)", times,
         log)


PARTS = {
    "attention": attention_ends,
    "decode": decode_ends,
    "train": train_step_ends,
    "engine": engine_ends,
}


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parts", nargs="*", choices=sorted(PARTS),
                    help="what to time (default: all)")
    args = ap.parse_args()
    if jax.default_backend() != "gpu":
        raise SystemExit("ends measures the GPU only")
    from ..utils.comp_cache import enable_compilation_cache

    enable_compilation_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for part in args.parts or PARTS:
        PARTS[part](lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
