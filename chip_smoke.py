"""Smoke run of the main paths on an NVIDIA GPU at Llama-3.1-8B widths.

Phases (one process, one card):

* **kernels** -- every Pallas kernel against the plain reference at full
  width (``harness/verify.py`` ``FULL``), then the ``gpu``-marked tests.
* **serve** -- ``DecodeEngine`` at full depth (32 layers, bf16 params),
  8 seeded requests, 32 greedy tokens each, with a dense bf16, an int8
  and a paged cache.  The logits of prefill and of every decode step
  (``runtime/decode.py``) and the engine's own log-probabilities are
  compared with ``models.transformer.forward`` over the same tokens,
  teacher-forced, with ``attn_impl="xla"`` (plain jnp attention, no
  kernel and no cache code).
* **train** -- ``models/trainer.py`` AdamW for 5 steps at 2 layers, batch
  1 x 4096 tokens, blockwise cross-entropy; step 1's loss and gradient
  norm against ``attn_impl="xla"``.

``--cards 4`` runs only the multi-card paths and what they are compared
with: the (dp, tp, sp) = (1, 2, 2) training step with all-gather and ring
sequence parallelism against the one-card loss, and the sp x tp sharded
int8 ``DecodeEngine`` against the one-card engine: the logits of both
engines' step functions, teacher-forced over the one-card tokens.

Each phase prints the attention end every call took, as recorded while
tracing (``ops.attention.traced_ends``).

The model is ``meta-llama/Llama-3.1-8B`` (config.json) with seeded random
weights.  Not modelled, and printed as assumed: the ``llama3`` RoPE
scaling, and ``rms_norm_eps`` (FlashLM uses 1e-6, the config 1e-5).

Run: ``python chip_smoke.py`` (one GPU) or ``python chip_smoke.py --cards 4``.
The last line of standard output is a JSON object with ``ok`` and the
device; any failed phase exits non-zero.  ``--tiny`` rehearses every
phase at small widths on any backend (with ``FLASH_ATTENTION_INTERPRET=1``
on the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

SEED = 0

# Agreement bands (CHANGES.md), each about twice what an H100 measured.
# A bf16 model whose attention differs from the reference only in
# rounding (bf16 probabilities into the P.V dot vs fp32 softmax) drifts
# through 32 random layers: 1.7-2.0e-2 of the largest logit, log-
# probabilities 6.3e-2.  The int8 cache adds its quantisation error
# (per-token absmax, 7 bits): 2.8e-2 and 9.4e-2.
BAND_LOGITS = {"dense": 4e-2, "int8": 6e-2, "paged": 4e-2}
BAND_LOGPROB = {"dense": 0.15, "int8": 0.2, "paged": 0.15}
# The sp x tp sharded engine against the one-card engine, both int8,
# teacher-forced: they differ only in where bf16 partial sums are joined
# (row-parallel psums, the lse combine).  Measured 1.09e-2 of the largest
# logit on four H100s.  A greedy token can flip only where the top two
# logits lie within twice that difference, so the same band bounds the
# top-2 gap at a divergence.
BAND_SHARDED = 2e-2
BAND_LOSS = 2e-3  # relative, step-1 loss
BAND_GNORM = 2e-2  # relative, step-1 global gradient norm


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


class Phases:
    """Runs named phases, records each result and wall time."""

    def __init__(self):
        self.failed = []

    def run(self, name, fn):
        t0 = time.perf_counter()
        try:
            ok = fn()
        except Exception as e:  # a phase boundary: report, then fail
            import traceback

            traceback.print_exc()
            log(f"[{name}] ERROR {type(e).__name__}: {e}")
            ok = False
        secs = time.perf_counter() - t0
        log(f"[{name}] {'PASS' if ok else 'FAIL'} in {secs:.1f} s")
        if not ok:
            self.failed.append(name)


def check(label, value, band) -> bool:
    ok = value <= band
    log(f"  [{'PASS' if ok else 'FAIL'}] {label}: {value:.3e} "
        f"(band {band:.3g})")
    return ok


def print_ends(label: str) -> None:
    """The end each attention call took since the last call (or
    ``clear_ends``), as the op and the serving paths recorded it while
    tracing."""
    from flash_attention_metal_tpu.ops.attention import traced_ends

    ends = traced_ends(clear=True)
    log(f"  {label}: attention ends taken: " + ("; ".join(
        f"{kind} -> {end}" for kind, end in sorted(ends)) or "none traced"))


def clear_ends() -> None:
    from flash_attention_metal_tpu.ops.attention import traced_ends

    traced_ends(clear=True)


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------


def phase_kernels(tiny: bool) -> bool:
    from flash_attention_metal_tpu.harness.verify import (
        FULL,
        SMALL,
        run_kernel_checks,
    )

    results = run_kernel_checks(SMALL if tiny else FULL,
                                log=lambda m: log("  " + m))
    ok = all(r.passed for r in results)
    if not tiny:
        import pytest

        rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu",
                          os.path.join(os.path.dirname(__file__), "tests",
                                       "test_gpu_kernels.py")])
        log(f"  gpu-marked tests: pytest exit {int(rc)}")
        ok = ok and int(rc) == 0
    return ok


# --------------------------------------------------------------------------
# serve
# --------------------------------------------------------------------------


def reference_logits(params, cfg, prompts, gens):
    """Teacher-forced logits of the plain-jnp model at every position whose
    logits produced a generated token: ``[B, n_new, V]``."""
    import jax.numpy as jnp
    import numpy as np

    n_new = len(gens[0])
    seqs = [p + g[:-1] for p, g in zip(prompts, gens)]
    width = max(len(s) for s in seqs)
    toks = np.zeros((len(seqs), width), np.int32)
    for i, s in enumerate(seqs):
        toks[i, : len(s)] = s
    idx = np.stack([np.arange(len(p) - 1, len(p) - 1 + n_new)
                    for p in prompts])
    return _reference_run()(params, dataclasses.replace(cfg, attn_impl="xla"),
                            jnp.asarray(toks), jnp.asarray(idx))


@functools.lru_cache(maxsize=1)
def _reference_run():
    """One jitted reference forward, shared by the three cache kinds."""
    import jax
    import jax.numpy as jnp

    from flash_attention_metal_tpu.models.transformer import (
        forward_hidden,
        weight,
    )

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def run(params, cfg, toks, idx):
        h = forward_hidden(params, toks, cfg, remat=False)
        h = jnp.take_along_axis(h, idx[..., None], axis=1)
        return (h @ weight(params["lm_head"], cfg.dtype)).astype(jnp.float32)

    return run


def teacher_forced(prefill, step, cache, prompts, gens):
    """Logits at every position that produced a generated token,
    ``[B, n_new, V]``: ``prefill(cache, tokens, length, slot)`` per slot
    (prompts padded to 128 as the engine pads them), then ``step(cache,
    tokens, active)`` over the generated tokens."""
    import jax.numpy as jnp
    import numpy as np

    out = []
    for slot, p in enumerate(prompts):
        padded = np.zeros((-(-len(p) // 128) * 128,), np.int32)
        padded[: len(p)] = p
        logits, cache = prefill(cache, jnp.asarray(padded),
                                jnp.int32(len(p)), slot)
        out.append([logits])
    active = jnp.ones((len(prompts),), bool)
    for t in range(len(gens[0]) - 1):
        tok = jnp.asarray([g[t] for g in gens], jnp.int32)
        logits, cache = step(cache, tok, active)
        for slot in range(len(prompts)):
            out[slot].append(logits[slot])
    return jnp.stack([jnp.stack(r) for r in out])


def direct_logits(params, cfg, kind, prompts, gens, max_len):
    """Teacher-forced logits from the ``runtime/decode.py`` functions the
    one-card engine calls: ``prefill_slot`` and ``decode_step``."""
    import jax.numpy as jnp

    from flash_attention_metal_tpu.runtime import (
        decode_step,
        init_cache,
        init_paged_cache,
        prefill_slot,
    )
    from flash_attention_metal_tpu.runtime.kv_cache import init_quant_cache

    b = len(prompts)
    shape = (cfg.n_layers, b, cfg.n_kv_heads, max_len, cfg.head_dim)
    if kind == "dense":
        cache = init_cache(*shape, dtype=cfg.dtype)
    elif kind == "int8":
        cache = init_quant_cache(*shape, dtype=jnp.int8)
    else:
        pages = max_len // 128
        cache = init_paged_cache(*shape, n_pages=b * pages, page_size=128,
                                 dtype=cfg.dtype)
        table = jnp.arange(b * pages, dtype=jnp.int32).reshape(b, pages)
        cache = dataclasses.replace(cache, page_table=table)
    return teacher_forced(
        lambda c, t, n, s: prefill_slot(params, cfg, c, t, n, s),
        lambda c, t, a: decode_step(params, cfg, c, t, a),
        cache, prompts, gens)


def sharded_logits(eng, prompts, gens):
    """Teacher-forced logits from the step functions a sharded engine
    calls (``SpStepFns.prefill_slot`` and ``decode_step``), on the
    engine's own sharded params and cache."""
    sp = eng._sp
    return teacher_forced(
        lambda c, t, n, s: sp.prefill_slot(eng.params, c, t, n, s,
                                           chunk=eng._prefill_chunk),
        lambda c, t, a: sp.decode_step(eng.params, c, t, a),
        eng.cache, prompts, gens)


def phase_serve(widths, tiny: bool) -> bool:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from flash_attention_metal_tpu.harness.llama import (
        bf16_params,
        make_requests,
        model_config,
    )

    from flash_attention_metal_tpu.runtime import DecodeEngine, Request

    cfg = model_config(widths)
    max_len = 512 if tiny else 4096
    t0 = time.perf_counter()
    params = bf16_params(cfg)
    jax.block_until_ready(params)
    log(f"  params: {cfg.n_layers} layers bf16, built in "
        f"{time.perf_counter() - t0:.1f} s")
    buckets = (128, 384) if tiny else (512, 2048)
    reqs = make_requests(cfg.vocab_size, buckets=buckets,
                         new=8 if tiny else 32)
    log("  prompt lengths: " + " ".join(str(len(p)) for _, p, _ in reqs))
    ok = True
    for kind, kw in (("dense", {}), ("int8", {"kv_quant": "int8"}),
                     ("paged", {"paged": True})):

        def serve_once():
            eng = DecodeEngine(params, cfg, max_batch=8, max_len=max_len,
                               eos_id=-1, **kw)
            for uid, prompt, new in reqs:
                eng.submit(Request(uid=uid, prompt=prompt,
                                   max_new_tokens=new))
            return eng, eng.run()

        clear_ends()
        t0 = time.perf_counter()
        eng, gen = serve_once()
        first = time.perf_counter() - t0
        print_ends(f"[{kind}] engine")
        lp = np.array([eng.finished[u].logprobs for u, _, _ in reqs])
        del eng
        # Same requests again: the compiled programs are reused.
        eng, gen2 = serve_once()
        stats = eng.stats()
        del eng
        prompts = [p for _, p, _ in reqs]
        gens = [gen[u] for u, _, _ in reqs]
        log(f"  [{kind}] engine: {sum(map(len, gens))} tokens; first run "
            f"{first:.1f} s with compilation; second run "
            f"{stats['ms_per_step']:.2f} ms/step, "
            f"{stats['tokens_per_s']:.1f} tok/s; same tokens: "
            f"{gen == gen2}")
        ref = reference_logits(params, cfg, prompts, gens)
        direct = direct_logits(params, cfg, kind, prompts, gens, max_len)
        scale = float(jnp.max(jnp.abs(ref)))
        err_pre = float(jnp.max(jnp.abs(direct[:, 0] - ref[:, 0]))) / scale
        err_dec = float(jnp.max(jnp.abs(direct[:, 1:] - ref[:, 1:]))) / scale
        ref_lp = jax.nn.log_softmax(ref, axis=-1)
        ref_lp = np.take_along_axis(np.asarray(ref_lp),
                                    np.asarray(gens)[..., None], -1)[..., 0]
        err_lp = float(np.max(np.abs(lp - ref_lp)))
        agree = float(np.mean(np.argmax(np.asarray(direct), -1)
                              == np.asarray(gens)))
        log(f"  [{kind}] logit scale {scale:.3f}; engine tokens == argmax "
            f"of decode-path logits: {agree:.3f}")
        ok &= check(f"{kind} prefill logits vs xla forward (rel)",
                    err_pre, BAND_LOGITS[kind])
        ok &= check(f"{kind} decode-step logits vs xla forward (rel)",
                    err_dec, BAND_LOGITS[kind])
        ok &= check(f"{kind} engine logprobs vs xla forward (abs)",
                    err_lp, BAND_LOGPROB[kind])
        ok &= bool(np.all(np.isfinite(lp)))
    return ok


# --------------------------------------------------------------------------
# train
# --------------------------------------------------------------------------


def phase_train(widths, tiny: bool) -> bool:
    import jax
    import jax.numpy as jnp
    import optax

    from flash_attention_metal_tpu.harness.llama import model_config
    from flash_attention_metal_tpu.models.losses import loss_fn_blockwise
    from flash_attention_metal_tpu.models.trainer import (
        Trainer,
        make_optimizer,
    )

    cfg = model_config(widths, n_layers=2)
    seq = 256 if tiny else 4096
    tokens = jax.random.randint(jax.random.PRNGKey(SEED + 1), (1, seq), 0,
                                cfg.vocab_size)
    trainer = Trainer(
        cfg, seed=SEED, loss=loss_fn_blockwise,
        optimizer=make_optimizer(peak_lr=1e-3, warmup_steps=1,
                                 total_steps=100),
    )
    params0 = trainer.state.params

    def loss_and_norm(c):
        f = jax.jit(jax.value_and_grad(
            lambda p: loss_fn_blockwise(p, tokens, c)))
        loss, grads = f(params0)
        return float(loss), float(optax.global_norm(grads))

    clear_ends()
    loss_a, norm_a = loss_and_norm(cfg)
    print_ends("train step (auto)")
    with jax.default_matmul_precision("highest"):
        loss_x, norm_x = loss_and_norm(dataclasses.replace(cfg,
                                                           attn_impl="xla"))
    losses, times = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        losses.append(trainer.step(tokens))
        times.append(time.perf_counter() - t0)
    log("  losses: " + " ".join(f"{x:.4f}" for x in losses))
    log("  step s: " + " ".join(f"{t:.3f}" for t in times)
        + " (first includes compilation)")
    # The same step with the Triton kernels instead of auto's choice.
    del trainer, params0
    other = Trainer(
        dataclasses.replace(cfg, attn_impl="pallas"), seed=SEED,
        loss=loss_fn_blockwise,
        optimizer=make_optimizer(peak_lr=1e-3, warmup_steps=1,
                                 total_steps=100),
    )
    t_pallas = []
    for _ in range(3):
        t0 = time.perf_counter()
        other.step(tokens)
        t_pallas.append(time.perf_counter() - t0)
    del other
    log(f"  step ms after compilation: auto "
        f"{1e3 * sum(times[1:]) / len(times[1:]):.1f}, pallas "
        f"{1e3 * sum(t_pallas[1:]) / len(t_pallas[1:]):.1f}")
    log(f"  step 1: loss {loss_a:.5f} (xla {loss_x:.5f}), grad norm "
        f"{norm_a:.5f} (xla {norm_x:.5f})")
    ok = all(jnp.isfinite(jnp.asarray(losses)))
    # AdamW on one repeated batch may wobble between late steps; the
    # check is that five steps take the loss well below where it began.
    falling = losses[-1] < 0.9 * losses[0]
    log(f"  [{'PASS' if falling else 'FAIL'}] loss falling: "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (needs < 0.9x)")
    ok &= falling
    ok &= check("step-1 loss vs xla (rel)", abs(loss_a - loss_x) / loss_x,
                BAND_LOSS)
    ok &= check("step-1 grad norm vs xla (rel)",
                abs(norm_a - norm_x) / norm_x, BAND_GNORM)
    ok &= check("trainer step-1 loss vs direct loss (rel)",
                abs(losses[0] - loss_a) / loss_a, BAND_LOSS)
    return bool(ok)


# --------------------------------------------------------------------------
# four cards
# --------------------------------------------------------------------------


def phase_multicard_train(widths, tiny: bool) -> bool:
    import jax

    from flash_attention_metal_tpu.harness.llama import model_config

    from flash_attention_metal_tpu.models import init_params
    from flash_attention_metal_tpu.models.parallel_train import (
        make_train_step,
    )
    from flash_attention_metal_tpu.models.transformer import loss_fn
    from flash_attention_metal_tpu.parallel import make_mesh

    cfg = model_config(widths, n_layers=2)
    seq = 512 if tiny else 8192
    mesh = make_mesh((1, 2, 2))
    params = init_params(jax.random.PRNGKey(SEED), cfg)
    tokens = jax.random.randint(jax.random.PRNGKey(SEED + 1), (1, seq), 0,
                                cfg.vocab_size)
    clear_ends()
    one = float(jax.jit(lambda p, t: loss_fn(p, t, cfg))(params, tokens))
    log(f"  one-card loss {one:.5f}")
    print_ends("one-card loss")
    ok = True
    for sp_attn in ("allgather", "ring"):
        t0 = time.perf_counter()
        step = make_train_step(mesh, cfg, lr=1e-3, sp_attn=sp_attn)
        _, loss = step(params, tokens)
        loss = float(loss)
        log(f"  (dp, tp, sp) = (1, 2, 2) {sp_attn}: loss {loss:.5f}, "
            f"{time.perf_counter() - t0:.1f} s with compilation")
        print_ends(f"{sp_attn} step")
        ok &= check(f"{sp_attn} loss vs one card (rel)",
                    abs(loss - one) / one, BAND_LOSS)
    return bool(ok)


def phase_multicard_serve(widths, tiny: bool) -> bool:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from flash_attention_metal_tpu.harness.llama import (
        bf16_params,
        make_requests,
        model_config,
    )
    from flash_attention_metal_tpu.runtime import DecodeEngine, Request

    cfg = model_config(widths, n_layers=2)
    params = bf16_params(cfg)
    max_len = 512 if tiny else 4096
    reqs = make_requests(cfg.vocab_size, new=16,
                         buckets=(128, 256) if tiny else (512, 1024))
    prompts = [p for _, p, _ in reqs]
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 2, 2),
                ("dp", "tp", "sp"))
    sharded = dict(mesh=mesh, seq_axis="sp", head_axis="tp")

    def engine(**kw):
        return DecodeEngine(params, cfg, max_batch=8, max_len=max_len,
                            eos_id=-1, kv_quant="int8", **kw)

    def generate(**kw):
        eng = engine(**kw)
        for uid, prompt, new in reqs:
            eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=new))
        out = eng.run()
        name = "sharded" if kw else "one-card"
        log(f"  engine {name}: {eng.stats()['ms_per_step']:.2f} ms/step "
            "(with compilation)")
        print_ends(f"{name} engine")
        return [out[u] for u, _, _ in reqs]

    clear_ends()
    gens1 = generate()
    gens4 = generate(**sharded)
    # Teacher-forced over the one-card tokens: both engines' own step
    # functions, every position of every request.
    ref = direct_logits(params, cfg, "int8", prompts, gens1, max_len)
    got = sharded_logits(engine(**sharded), prompts, gens1)
    scale = float(jnp.max(jnp.abs(ref)))
    ok = check("sharded int8 engine logits vs one card, teacher-forced "
               "(rel)", float(jnp.max(jnp.abs(got - ref))) / scale,
               BAND_SHARDED)
    ok &= bool(jnp.all(jnp.isfinite(got)))
    # Free-running greedy tokens may part at a near tie: a request may
    # diverge only where the one-card logits' top two lie within the band.
    ref = np.asarray(ref)
    for i, (a, b) in enumerate(zip(gens1, gens4)):
        n = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if n is None:
            log(f"  request {i}: {len(a)} greedy tokens identical")
            continue
        top2 = np.sort(ref[i, n])[-2:]
        ok &= check(f"request {i} diverges at token {n}: one-card top-2 "
                    "logit gap (rel)", float(top2[1] - top2[0]) / scale,
                    BAND_SHARDED)
    return bool(ok)


def device_memory_report() -> bool:
    """Peak bytes per card: a sharded path must spread its arrays."""
    import jax

    stats = [d.memory_stats() for d in jax.devices()]
    if any(s is None for s in stats):
        log("  this backend reports no device memory")
        return True
    peaks = [s.get("peak_bytes_in_use", 0) for s in stats]
    log("  peak bytes per device: " + " ".join(f"{p / 2**30:.2f}G"
                                               for p in peaks))
    return min(peaks) > 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the multi-card paths")
    ap.add_argument("--tiny", action="store_true",
                    help="rehearsal at small widths on any backend")
    args = ap.parse_args()
    if not args.tiny:
        os.environ["JAX_PLATFORMS"] = "cuda"
    # A cold run is mostly compilation; XLA's benchmarking of GEMM
    # configurations is skipped (default configurations: correct, maybe
    # slower).  Timings that matter come from harness/ends.py.
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_gpu_autotune_level" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_gpu_autotune_level=0").strip()
    import jax

    try:
        devices = jax.devices()
    except RuntimeError as e:
        log(f"no accelerator: {e}")
        return 1
    if not args.tiny and devices[0].platform != "gpu":
        log(f"no GPU: {devices}")
        return 1
    if len(devices) < args.cards:
        log(f"need {args.cards} devices, have {len(devices)}")
        return 1

    from flash_attention_metal_tpu.harness.llama import LLAMA_8B, TINY
    from flash_attention_metal_tpu.utils.comp_cache import (
        enable_compilation_cache,
    )

    log(f"compile cache: {enable_compilation_cache()}; "
        f"XLA_FLAGS={os.environ['XLA_FLAGS']}")
    if not args.tiny:
        log(card_line())
    log(str(devices))
    widths = TINY if args.tiny else LLAMA_8B
    log(f"model: meta-llama/Llama-3.1-8B widths {widths}; seeded random "
        "weights; assumed: no llama3 RoPE scaling, rms_norm_eps 1e-6 "
        "(config: 1e-5)")
    phases = Phases()
    if args.cards == 4:
        phases.run("multicard-train",
                   lambda: phase_multicard_train(widths, args.tiny))
        phases.run("multicard-serve",
                   lambda: phase_multicard_serve(widths, args.tiny))
        phases.run("device-spread", device_memory_report)
    else:
        phases.run("kernels", lambda: phase_kernels(args.tiny))
        phases.run("serve", lambda: phase_serve(widths, args.tiny))
        phases.run("train", lambda: phase_train(widths, args.tiny))
    if phases.failed:
        log(f"failed phases: {phases.failed}")
        return 1
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
