"""Kernel checks: every Pallas kernel against the plain reference.

The reference verifies each kernel against its CPU golden oracle at a
fixed tolerance ladder and prints PASS/FAIL per rung
(``main.mm:231-594,1181-1194``).  Here every translated kernel, and each
feature combination the op exposes, is compared with
``reference/oracle.py`` (fp32 math under
``jax.default_matmul_precision("highest")``) at the ladder's tolerances:
fp32 1e-3, half 1e-2, backward 1e-1 (``main.mm:239,452,1191``), 8-bit KV
3e-2 (int8) / 5e-2 (fp8).

``SMALL`` shapes run on the CPU in interpret mode (the test suite runs
each check); ``FULL`` shapes are Llama-3.1-8B attention widths and run on
the GPU (``chip_smoke.py``).

Run: ``python -m flash_attention_metal_tpu.harness.verify [--full]``
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Dict, List

import jax
import jax.numpy as jnp

from ..config import SegmentIds
from ..kernels import (
    flash_attention_paged,
    flash_attention_paged_quant,
    flash_attention_quant,
    quantize_kv,
)
from ..kernels._common import dropout_keep, pack_dropout_seed
from ..ops.attention import (
    flash_attention,
    fold_gqa_rows,
    gqa_decode_attention,
    unfold_gqa_rows,
)
from ..reference import attention_reference, attention_reference_with_lse
from ..runtime.kv_cache import rolling_slots

TOL_FP32 = 1e-3  # main.mm:239,253,292
TOL_HALF = 1e-2  # main.mm:452,591
TOL_BWD = 1e-1  # main.mm:1191
TOL_QUANT = {"int8": 3e-2, "float8_e4m3fn": 5e-2}

DOT_PRECISION = (
    "kernel dots: bf16/fp16 and 8-bit operands on the tensor cores with "
    "fp32 accumulation; fp32 operands in full-precision fp32 "
    "(Precision.HIGHEST, no TF32); oracle in fp32 under "
    "default_matmul_precision('highest')"
)


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Shapes of one run of the checks."""

    batch: int
    q_heads: int
    kv_heads: int
    seq: int
    head_dim: int
    decode_batch: int
    cache: int
    page: int
    window: int


# Llama-3.1-8B attention (meta-llama/Llama-3.1-8B config.json): 32 query
# heads, 8 KV heads, head dim 128; 4k training sequence, 32k decode cache.
FULL = Sizes(1, 32, 8, 4096, 128, 8, 32768, 128, 1024)
SMALL = Sizes(1, 4, 2, 256, 64, 2, 512, 64, 96)


@dataclasses.dataclass
class RungResult:
    name: str
    max_diff: float
    tolerance: float
    has_nan: bool

    @property
    def passed(self) -> bool:
        return (self.max_diff < self.tolerance) and not self.has_nan

    def line(self) -> str:
        status = "PASS" if self.passed else "FAIL"
        nan = " [NaN!]" if self.has_nan else ""
        return (
            f"[{status}] {self.name}: max diff {self.max_diff:.3e} "
            f"(tol {self.tolerance:.0e}){nan}"
        )


def _rung(name, got, want, tol, relative=False) -> RungResult:
    got = jnp.asarray(got, jnp.float32)
    want = jnp.asarray(want, jnp.float32)
    diff = float(jnp.max(jnp.abs(got - want)))
    if relative:
        diff /= max(float(jnp.max(jnp.abs(want))), 1e-6)
    return RungResult(name, diff, tol, bool(jnp.any(jnp.isnan(got))))


def _qkv(s: Sizes, dtype, seed=42, n_q=None):
    kq, kk, kv = jax.random.split(jax.random.PRNGKey(seed), 3)
    n_q = s.seq if n_q is None else n_q

    def u(key, h, n):
        shape = (s.batch, h, n, s.head_dim)
        return jax.random.uniform(key, shape, jnp.float32, -1, 1).astype(dtype)

    return u(kq, s.q_heads, n_q), u(kk, s.kv_heads, s.seq), u(kv, s.kv_heads, s.seq)


def _rep(x, s: Sizes):
    return jnp.repeat(x, s.q_heads // s.kv_heads, axis=1)


def _out_and_grads(fn, args, with_slopes, cotangent):
    """Output and the VJP of ``cotangent`` (q, k, v[, slopes]) in one
    compiled program."""
    n = 4 if with_slopes else 3

    @jax.jit
    def run(args, cotangent):
        out, vjp = jax.vjp(lambda *x: fn(*x, *args[n:]), *args[:n])
        cot = jax.tree_util.tree_map(lambda c, o: c.astype(o.dtype),
                                     cotangent, out)
        return out, vjp(cot)

    return run(tuple(args), cotangent)


def _compare_grad(
    name: str, s: Sizes, dtype, kernel_kw: dict, ref_kw: dict, *,
    n_q=None, with_slopes=False, with_lse=False,
) -> List[RungResult]:
    """Forward and gradients of the Pallas op against the oracle."""
    q, k, v = _qkv(s, dtype, n_q=n_q)
    w = jax.random.uniform(jax.random.PRNGKey(7), q.shape, jnp.float32, -1, 1)
    wl = jax.random.uniform(jax.random.PRNGKey(8), q.shape[:3], jnp.float32)
    slopes = jnp.asarray(
        [2.0 ** -(8 * (i + 1) / s.q_heads) for i in range(s.q_heads)],
        jnp.float32,
    )
    kernel_kw = dict(kernel_kw)
    ref_kw = dict(ref_kw)

    def kern(q, k, v, sl):
        extra = dict(alibi_slopes=sl) if with_slopes else {}
        return flash_attention(
            q, k, v, impl="pallas", save_lse=with_lse, **kernel_kw, **extra
        )

    def ref(q, k, v, sl):
        extra = dict(alibi_slopes=sl) if with_slopes else {}
        fn = attention_reference_with_lse if with_lse else attention_reference
        return fn(q, _rep(k, s), _rep(v, s), **ref_kw, **extra)

    out_k, g_k = _out_and_grads(kern, (q, k, v, slopes), with_slopes,
                                (w, wl) if with_lse else w)
    with jax.default_matmul_precision("highest"):
        out_r, g_r = _out_and_grads(ref, (q, k, v, slopes), with_slopes,
                                    (w, wl) if with_lse else w)
    half = dtype != jnp.float32
    tol_f = TOL_HALF if half else TOL_FP32
    tol_b = TOL_BWD if half else TOL_FP32
    o_k, o_r = (out_k[0], out_r[0]) if with_lse else (out_k, out_r)
    res = [_rung(f"{name} fwd", o_k, o_r, tol_f)]
    if with_lse:
        res.append(_rung(f"{name} lse", out_k[1], out_r[1], tol_f))
    for label, a, b in zip(("dq", "dk", "dv", "dslopes(rel)"), g_k, g_r):
        rel = label.startswith("dslopes")
        res.append(_rung(f"{name} {label}", a, b, tol_f if rel else tol_b,
                         relative=rel))
    return res


def _fwd_bwd(dtype, causal):
    def check(s: Sizes):
        name = f"fwd+bwd {jnp.dtype(dtype).name} causal={causal}"
        return _compare_grad(name, s, dtype, dict(causal=causal),
                             dict(causal=causal))
    return check


def _feature(name, kw, **flags):
    def check(s: Sizes):
        kw2 = dict(kw)
        if kw2.get("window") == "W":
            kw2["window"] = s.window
        if "segment_ids" in kw2:
            n = s.seq
            seg = jnp.repeat(jnp.arange(4, dtype=jnp.int32), n // 4)[None, :]
            seg = jnp.broadcast_to(seg, (s.batch, n))
            kw2["segment_ids"] = SegmentIds(seg, seg)
        return _compare_grad(f"{name} bf16", s, jnp.bfloat16, kw2, kw2,
                             **flags)
    return check


def _traced_offsets(s: Sizes) -> List[RungResult]:
    """Per-batch offsets as traced values: 2 rows of half-length queries
    against the full KV at different diagonals."""
    s2 = dataclasses.replace(s, batch=2)
    n_q = s.seq // 2
    q, k, v = _qkv(s2, jnp.bfloat16, n_q=n_q)
    offs = jnp.asarray([s.seq - n_q, s.seq // 4], jnp.int32)
    w = jax.random.uniform(jax.random.PRNGKey(7), q.shape, jnp.float32, -1, 1)

    def kern(q, k, v, o):
        return flash_attention(q, k, v, o, causal=True, impl="pallas")

    def ref(q, k, v, o):
        return attention_reference(q, _rep(k, s2), _rep(v, s2), causal=True,
                                   q_offset=o[:, None, None, None])

    o_k, g_k = _out_and_grads(kern, (q, k, v, offs), False, w)
    with jax.default_matmul_precision("highest"):
        o_r, g_r = _out_and_grads(ref, (q, k, v, offs), False, w)
    res = [_rung("traced per-batch q_offset fwd bf16", o_k, o_r, TOL_HALF)]
    for label, a, b in zip(("dq", "dk", "dv"), g_k, g_r):
        res.append(_rung(f"traced per-batch q_offset {label}", a, b, TOL_BWD))
    return res


def _dropout(s: Sizes) -> List[RungResult]:
    """The in-kernel dropout mask equals the oracle's bit for bit.

    With V = I (KV length = head dim) the output row is the dropped
    probability row itself, so the kernel's zero pattern IS its mask.
    """
    rate, seed = 0.2, jnp.int32(1234)
    d = s.head_dim
    q = jax.random.uniform(jax.random.PRNGKey(3), (1, s.q_heads, s.seq, d),
                           jnp.float32, -1, 1)
    k = jax.random.uniform(jax.random.PRNGKey(4), (1, s.q_heads, d, d),
                           jnp.float32, -1, 1)
    eye = jnp.broadcast_to(jnp.eye(d, dtype=jnp.float32), k.shape)
    o = jax.jit(lambda q, k, v: flash_attention(
        q, k, v, dropout_rate=rate, dropout_seed=seed, impl="pallas"))(
            q, k, eye)
    sv = pack_dropout_seed(seed)
    keep = dropout_keep(
        sv[0], jnp.arange(s.q_heads).reshape(1, -1, 1, 1),
        jnp.arange(s.seq).reshape(1, 1, -1, 1),
        jnp.arange(d).reshape(1, 1, 1, -1), rate,
    )
    mismatches = jnp.sum((o != 0) != (keep != 0))
    res = [RungResult("dropout mask bit-identical (mismatches)",
                      float(mismatches), 1.0, False)]
    res += _feature("dropout", dict(causal=True, dropout_rate=rate,
                                    dropout_seed=seed))(s)
    return res


def _decode_inputs(s: Sizes):
    b, n = s.decode_batch, s.cache
    key = jax.random.PRNGKey(11)
    kq, kk, kv = jax.random.split(key, 3)
    q = jax.random.uniform(kq, (b, s.q_heads, 1, s.head_dim), jnp.float32,
                           -1, 1).astype(jnp.bfloat16)
    k = jax.random.uniform(kk, (b, s.kv_heads, n, s.head_dim), jnp.float32,
                           -1, 1).astype(jnp.bfloat16)
    v = jax.random.uniform(kv, (b, s.kv_heads, n, s.head_dim), jnp.float32,
                           -1, 1).astype(jnp.bfloat16)
    # Ragged lengths: the token being decoded sits at position lengths[b].
    lengths = jnp.asarray(
        [n - 1 - (i * 997) % (n // 2) for i in range(b)], jnp.int32
    )
    return q, k, v, lengths


def _decode_ref(s, q, k, v, lengths):
    with jax.default_matmul_precision("highest"):
        return jax.jit(lambda q, k, v, o: attention_reference(
            q, _rep(k, s), _rep(v, s), causal=True,
            q_offset=o[:, None, None, None]))(q, k, v, lengths)


def _to_pool(x, page):
    """[B, H, N, ...] -> a page pool [B*N/page, H, page, ...] whose page
    table is the identity."""
    b, h, n = x.shape[:3]
    tail = x.shape[3:]
    return (x.reshape(b, h, n // page, page, *tail).swapaxes(1, 2)
            .reshape(b * n // page, h, page, *tail))


def _decode(kind: str):
    def check(s: Sizes) -> List[RungResult]:
        q, k, v, lengths = _decode_inputs(s)
        ref = _decode_ref(s, q, k, v, lengths)
        group = s.q_heads // s.kv_heads
        fold = fold_gqa_rows(q, s.kv_heads)
        table = jnp.arange(s.decode_batch * s.cache // s.page, dtype=jnp.int32)
        table = table.reshape(s.decode_batch, -1)
        tol = TOL_HALF
        if kind == "dense bf16":
            o = jax.jit(gqa_decode_attention)(q, k, v, lengths)
        elif kind in ("int8", "float8_e4m3fn"):
            qkv = quantize_kv(k, v, getattr(jnp, kind))
            o = jax.jit(lambda f, c, l: flash_attention_quant(
                f, c, l, causal=True, pos_div=group))(fold, qkv, lengths)
            o = unfold_gqa_rows(o, s.q_heads, 1)
            tol = TOL_QUANT[kind]
        elif kind == "paged bf16":
            o = jax.jit(lambda f, pk, pv, t, l: flash_attention_paged(
                f, pk, pv, t, l, pos_div=group))(
                    fold, _to_pool(k, s.page), _to_pool(v, s.page), table,
                    lengths)
            o = unfold_gqa_rows(o, s.q_heads, 1)
        elif kind == "paged int8":
            qkv = quantize_kv(k, v, jnp.int8)
            o = jax.jit(lambda f, a, b_, c, d, t, l: flash_attention_paged_quant(
                f, a, b_, c, d, t, l, pos_div=group))(
                    fold, _to_pool(qkv.k_q, s.page),
                    _to_pool(qkv.v_q, s.page), _to_pool(qkv.k_scale, s.page),
                    _to_pool(qkv.v_scale, s.page), table, lengths)
            o = unfold_gqa_rows(o, s.q_heads, 1)
            tol = TOL_QUANT["int8"]
        else:
            raise ValueError(kind)
        return [_rung(f"decode {kind} (T=1, GQA fold {group}, cache "
                      f"{s.cache})", o, ref, tol)]
    return check


def _decode_rolling(s: Sizes) -> List[RungResult]:
    """Rolling (wrapped) cache with sinks: position-space masking over a
    cache of ``cache // 4`` slots that has seen ``cache`` positions."""
    cap, sinks = s.cache // 4, 4
    window = cap - sinks - 64
    q, k_hist, v_hist, _ = _decode_inputs(s)
    cur = s.cache
    lengths = jnp.full((s.decode_batch,), cur - 1, jnp.int32)
    # Each slot holds the latest position that maps to it.
    slots = rolling_slots(jnp.arange(cur), cap, sinks)
    pos = jnp.full((cap,), -1, jnp.int32).at[slots].max(jnp.arange(cur))
    kc = k_hist[:, :, jnp.maximum(pos, 0)]
    vc = v_hist[:, :, jnp.maximum(pos, 0)]
    pos = jnp.broadcast_to(pos, (s.decode_batch, cap))
    o = jax.jit(lambda q, k, v, l, p: flash_attention(
        q, k, v, l, kv_positions=p, causal=True, window=window,
        sinks=sinks))(q, kc, vc, lengths, pos)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda q, k, v, o: attention_reference(
            q, _rep(k, s), _rep(v, s), causal=True, window=window,
            sinks=sinks, q_offset=o[:, None, None, None]))(
                q, k_hist, v_hist, lengths)
    return [_rung(f"decode rolling bf16 (capacity {cap}, sinks {sinks})",
                  o, ref, TOL_HALF)]


CHECKS: Dict[str, Callable[[Sizes], List[RungResult]]] = {
    "fwd_bwd_bf16_causal": _fwd_bwd(jnp.bfloat16, True),
    "fwd_bwd_bf16_full": _fwd_bwd(jnp.bfloat16, False),
    "fwd_bwd_fp32_causal": _fwd_bwd(jnp.float32, True),
    "fwd_bwd_fp32_full": _fwd_bwd(jnp.float32, False),
    "window_sinks": _feature("window+sinks",
                             dict(causal=True, window="W", sinks=4)),
    "softcap": _feature("softcap", dict(causal=True, softcap=30.0)),
    "alibi": _feature("alibi", dict(causal=True), with_slopes=True),
    "segment_ids": _feature("segment ids",
                            dict(causal=True, segment_ids=True)),
    "dropout": _dropout,
    "save_lse": _feature("save_lse", dict(causal=True), with_lse=True),
    "traced_offset": _traced_offsets,
    "decode_dense": _decode("dense bf16"),
    "decode_int8": _decode("int8"),
    "decode_fp8": _decode("float8_e4m3fn"),
    "decode_paged": _decode("paged bf16"),
    "decode_paged_int8": _decode("paged int8"),
    "decode_rolling": _decode_rolling,
}


def run_kernel_checks(
    sizes: Sizes = SMALL, log: Callable[[str], None] = print
) -> List[RungResult]:
    """Run every check at ``sizes``; logs one line per comparison."""
    log(DOT_PRECISION)
    results: List[RungResult] = []
    for name, check in CHECKS.items():
        for r in check(sizes):
            log(r.line())
            results.append(r)
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--full", action="store_true",
                    help="Llama-3.1-8B widths (GPU)")
    args = ap.parse_args()
    results = run_kernel_checks(FULL if args.full else SMALL)
    failed = [r for r in results if not r.passed]
    print(f"{len(results) - len(failed)}/{len(results)} passed")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
