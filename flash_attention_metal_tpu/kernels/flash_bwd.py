"""FlashAttention-2 backward: a dK/dV kernel and a dQ kernel, Triton route.

The reference's backward (``kernels.metal:884-1209``) recomputes the
probabilities from the saved logsumexp (``kernels.metal:1081-1089``) and
accumulates the gradients.  Here the same recompute runs in two
deterministic kernels with no atomics:

* **dK/dV**: one program per (KV block, batch, KV head).  It keeps its K/V
  tile and fp32 dK/dV accumulators in registers and loops over the query
  heads of its GQA group and, for each, over the query blocks that can
  see the tile -- so a group's gradients are summed in registers, with no
  K/V broadcast and no group-sized dK/dV in memory.
* **dQ**: one program per (query block, batch, query head), looping over
  the KV blocks of the forward's causal/window range.  With ALiBi it also
  writes each row's sum of dS * distance, which the wrapper reduces to
  d/d(slopes).

Both replay the forward's score transforms (softcap, ALiBi), masks and
dropout hash, and chain dS through ``1 - tanh^2`` for the cap -- no
O(N^2) tensor is ever materialised.  The lse cotangent folds into the
per-row ``delta`` (d lse / d s = p).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..config import BlockSizes, default_scale
from ._common import dropout_keep, pack_dropout_seed, pallas_interpret
from .flash_fwd import (
    _LOG2E,
    _pad_to,
    _round_up,
    causal_kv_range,
    dot_precision,
    pad_dim,
)


def _scores(q, k, *, row_pos, col_pos, cols, scale2, softcap,
            slope2, causal, window, sinks, seg, n_kv, block_k, prec):
    """Recompute the forward's log2-domain scores for one tile.

    Returns ``(s, th)``: masked scores (-inf where hidden) and, with a
    softcap, ``tanh`` of the uncapped score for the chain rule.
    """
    s = pl.dot(q, k, trans_b=True, precision=prec) * scale2
    th = None
    if softcap is not None:
        c2 = softcap * _LOG2E
        th = jnp.tanh(s * (1.0 / c2))
        s = c2 * th
    if slope2 is not None:
        s = s + slope2 * (col_pos - row_pos).astype(jnp.float32)
    visible = None
    if causal:
        visible = col_pos <= row_pos
        if window is not None:
            keep = col_pos > row_pos - window
            if sinks:
                keep = keep | (col_pos < sinks)
            visible = visible & keep
    if seg is not None:
        visible = seg if visible is None else visible & seg
    if n_kv % block_k:
        in_range = cols[None, :] < n_kv
        visible = in_range if visible is None else visible & in_range
    if visible is not None:
        s = jnp.where(visible, s, -jnp.inf)
    return s, th


def _ds(p, dp, delta, th):
    """dS (gradient w.r.t. the capped, biased natural-log score) and the
    same chained through the cap."""
    du = p * (dp - delta[:, None])
    dx = du if th is None else du * (1.0 - th * th)
    return du, dx


def _dkv_kernel(
    *refs,
    names: Tuple[str, ...],
    sm_scale: float,
    causal: bool,
    window,
    sinks: int,
    softcap,
    dropout_rate: float,
    dropout_heads,
    n_kv: int,
    block_q: int,
    block_k: int,
    num_q_blocks: int,
    num_heads: int,
    group: int,
):
    r = dict(zip(names, refs))
    j = pl.program_id(0)
    b = pl.program_id(1)
    hk = pl.program_id(2)
    k = r["k"][...]
    v = r["v"][...]
    prec = dot_precision(k.dtype)
    scale2 = sm_scale * _LOG2E
    cols = j * block_k + jnp.arange(block_k, dtype=jnp.int32)
    col_pos = cols[None, :]
    off = r["off"][b] if "off" in r else 0
    if "kvseg" in r:
        kvseg = r["kvseg"][...][None, :]
    if dropout_rate:
        seed = [r["seed"][t] for t in range(5)]
        bh_mul = dropout_heads if dropout_heads is not None else num_heads
        drop_cols = (seed[2] + cols)[None, :]

    if causal:
        i_lo = jnp.clip(jnp.maximum(j * block_k - off, 0) // block_q, 0,
                        num_q_blocks)
        i_hi = num_q_blocks
        if window is not None:
            last = (j + 1) * block_k - 1 - off + window - 1
            i_hi = jnp.where(last < 0, 0, last // block_q + 1)
            i_hi = jnp.clip(i_hi, 0, num_q_blocks)
            if sinks:
                i_hi = jnp.where(j * block_k < sinks, num_q_blocks, i_hi)
        i_hi = jnp.maximum(i_hi, i_lo)
    else:
        i_lo, i_hi = 0, num_q_blocks

    def head_body(g, carry):
        h = hk * group + g
        slope2 = r["slopes"][h] * _LOG2E if "slopes" in r else None
        if dropout_rate:
            drop_bh = (b + seed[3]) * bh_mul + (h + seed[4])

        def body(i, carry):
            dk, dv = carry
            sl = pl.ds(i * block_q, block_q)
            q = r["q"][g, sl, :]
            do = r["do"][g, sl, :]
            lse2 = r["lse"][g, sl]
            delta = r["delta"][g, sl]
            rows = i * block_q + jnp.arange(block_q, dtype=jnp.int32)
            seg = None
            if "qseg" in r:
                seg = r["qseg"][sl][:, None] == kvseg
            s, th = _scores(
                q, k, row_pos=(rows + off)[:, None], col_pos=col_pos,
                cols=cols, scale2=scale2, softcap=softcap,
                slope2=slope2, causal=causal, window=window, sinks=sinks,
                seg=seg, n_kv=n_kv, block_k=block_k, prec=prec,
            )
            p = jnp.exp2(s - lse2[:, None])
            dp = pl.dot(do, v, trans_b=True, precision=prec)
            if dropout_rate:
                keep = dropout_keep(
                    seed[0], drop_bh, (seed[1] + rows)[:, None], drop_cols,
                    dropout_rate,
                )
                pd = p * keep
                dp = dp * keep
            else:
                pd = p
            dv = dv + pl.dot(pd.astype(do.dtype), do, trans_a=True,
                             precision=prec)
            _, dx = _ds(p, dp, delta, th)
            dk = dk + pl.dot(dx.astype(q.dtype), q, trans_a=True,
                             precision=prec)
            return dk, dv

        return jax.lax.fori_loop(i_lo, i_hi, body, carry)

    d = k.shape[-1]
    zeros = jnp.zeros((block_k, d), jnp.float32)
    dk, dv = jax.lax.fori_loop(0, group, head_body, (zeros, zeros))
    r["dk"][...] = (dk * sm_scale).astype(r["dk"].dtype)
    r["dv"][...] = dv.astype(r["dv"].dtype)


def _dq_kernel(
    *refs,
    names: Tuple[str, ...],
    sm_scale: float,
    causal: bool,
    window,
    sinks: int,
    softcap,
    dropout_rate: float,
    dropout_heads,
    n_kv: int,
    block_q: int,
    block_k: int,
    num_kv_blocks: int,
    num_heads: int,
):
    r = dict(zip(names, refs))
    i = pl.program_id(0)
    b = pl.program_id(1)
    h = pl.program_id(2)
    q = r["q"][...]
    do = r["do"][...]
    lse2 = r["lse"][...]
    delta = r["delta"][...]
    prec = dot_precision(q.dtype)
    scale2 = sm_scale * _LOG2E
    rows = i * block_q + jnp.arange(block_q, dtype=jnp.int32)
    off = r["off"][b] if "off" in r else 0
    row_pos = (rows + off)[:, None]
    slope2 = r["slopes"][h] * _LOG2E if "slopes" in r else None
    if "qseg" in r:
        qseg = r["qseg"][...][:, None]
    if dropout_rate:
        seed = [r["seed"][t] for t in range(5)]
        bh_mul = dropout_heads if dropout_heads is not None else num_heads
        drop_bh = (b + seed[3]) * bh_mul + (h + seed[4])
        drop_rows = (seed[1] + rows)[:, None]

    def body(j, carry):
        dq, dsl = carry
        sl = pl.ds(j * block_k, block_k)
        k = r["k"][sl, :]
        v = r["v"][sl, :]
        cols = j * block_k + jnp.arange(block_k, dtype=jnp.int32)
        col_pos = cols[None, :]
        seg = None
        if "qseg" in r:
            seg = qseg == r["kvseg"][sl][None, :]
        s, th = _scores(
            q, k, row_pos=row_pos, col_pos=col_pos, cols=cols, scale2=scale2,
            softcap=softcap, slope2=slope2, causal=causal,
            window=window, sinks=sinks, seg=seg, n_kv=n_kv,
            block_k=block_k, prec=prec,
        )
        p = jnp.exp2(s - lse2[:, None])
        dp = pl.dot(do, v, trans_b=True, precision=prec)
        if dropout_rate:
            dp = dp * dropout_keep(
                seed[0], drop_bh, drop_rows, (seed[2] + cols)[None, :],
                dropout_rate,
            )
        du, dx = _ds(p, dp, delta, th)
        dq = dq + pl.dot(dx.astype(k.dtype), k, precision=prec)
        if slope2 is not None:
            dist = (col_pos - row_pos).astype(jnp.float32)
            dsl = dsl + jnp.sum(du * dist, axis=1)
        return dq, dsl

    carry = (
        jnp.zeros((block_q, q.shape[-1]), jnp.float32),
        jnp.zeros((block_q,), jnp.float32),
    )
    if causal:
        sink_hi, lo, hi = causal_kv_range(
            i, off, block_q=block_q, block_k=block_k,
            num_kv_blocks=num_kv_blocks, pos_div=1, window=window,
            sinks=sinks,
        )
        if sinks and window is not None:
            carry = jax.lax.fori_loop(0, sink_hi, body, carry)
        dq, dsl = jax.lax.fori_loop(lo, hi, body, carry)
    else:
        dq, dsl = jax.lax.fori_loop(0, num_kv_blocks, body, carry)
    r["dq"][...] = (dq * sm_scale).astype(r["dq"].dtype)
    if "dslope" in r:
        r["dslope"][...] = dsl


@functools.partial(
    jax.jit,
    static_argnames=(
        "sm_scale",
        "causal",
        "window",
        "sinks",
        "block_sizes",
        "softcap",
        "dropout_rate",
        "dropout_heads",
    ),
)
def flash_attention_bwd(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    o: jax.Array,
    do: jax.Array,
    lse: jax.Array,
    q_offset: Optional[jax.Array] = None,
    dlse: Optional[jax.Array] = None,
    *,
    sm_scale: Optional[float] = None,
    causal: bool = False,
    window: Optional[int] = None,
    sinks: int = 0,
    segment_ids=None,
    block_sizes: Optional[BlockSizes] = None,
    softcap: Optional[float] = None,
    alibi_slopes: Optional[jax.Array] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[jax.Array] = None,
    dropout_offsets=None,
    dropout_heads: Optional[int] = None,
) -> Tuple[jax.Array, ...]:
    """(dQ, dK, dV) from the saved output and ``lse [B, H, N_q]``.

    ``k``/``v`` may have fewer heads than ``q`` (GQA/MQA); dK/dV come back
    with the KV head count.  ``dlse``: optional ``[B, H, N_q]`` cotangent
    on the logsumexp output.  With ``alibi_slopes`` a fourth element
    ``d_slopes`` (``[H]`` fp32) is returned.  The other arguments have
    ``flash_attention_fwd``'s meaning and must match the forward call.
    """
    batch, heads, n_q, head_dim = q.shape
    kv_heads, n_kv = k.shape[1], k.shape[2]
    if heads % kv_heads:
        raise ValueError(
            f"q heads ({heads}) must be a multiple of kv heads ({kv_heads})"
        )
    group = heads // kv_heads
    if sm_scale is None:
        sm_scale = default_scale(head_dim)
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        window = int(window)
    if dropout_rate:
        if not 0.0 < dropout_rate < 1.0:
            raise ValueError(
                f"dropout_rate must be in [0, 1), got {dropout_rate}"
            )
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 requires dropout_seed")
    bs = (block_sizes or BlockSizes()).resolve(n_q, n_kv, head_dim)
    bq, bk = bs.block_q_bwd, bs.block_k_bwd
    n_q_pad, n_kv_pad = _round_up(n_q, bq), _round_up(n_kv, bk)
    dp = pad_dim(head_dim)

    delta = jnp.sum(o.astype(jnp.float32) * do.astype(jnp.float32), -1)
    if dlse is not None:
        delta = delta - dlse.astype(jnp.float32)
    # Fully masked rows (lse = -inf) and padding rows get +inf, so their
    # recomputed probabilities are exp2(-inf) = 0 instead of NaN.
    lse2 = jnp.where(jnp.isneginf(lse), jnp.inf, lse * _LOG2E)

    q_p = _pad_to(_pad_to(q, 3, dp), 2, n_q_pad)
    do_p = _pad_to(_pad_to(do.astype(q.dtype), 3, dp), 2, n_q_pad)
    k_p = _pad_to(_pad_to(k, 3, dp), 2, n_kv_pad)
    v_p = _pad_to(_pad_to(v, 3, dp), 2, n_kv_pad)
    lse_p = _pad_to(lse2.astype(jnp.float32), 2, n_q_pad, jnp.inf)
    delta_p = _pad_to(delta, 2, n_q_pad)

    extra = []  # (name, array, dkv spec, dq spec)
    if causal or alibi_slopes is not None:
        if q_offset is None:
            q_offset = n_kv - n_q
        off = jnp.broadcast_to(
            jnp.asarray(q_offset, jnp.int32).reshape(-1), (batch,)
        )
        whole = pl.BlockSpec((batch,), lambda x, b, h: (0,))
        extra.append(("off", off, whole, whole))
    if segment_ids is not None:
        qseg = _pad_to(segment_ids.q.astype(jnp.int32), 1, n_q_pad, -1)
        kvseg = _pad_to(segment_ids.kv.astype(jnp.int32), 1, n_kv_pad, -2)
        extra.append((
            "qseg", qseg,
            pl.BlockSpec((None, n_q_pad), lambda j, b, h: (b, 0)),
            pl.BlockSpec((None, bq), lambda i, b, h: (b, i)),
        ))
        extra.append((
            "kvseg", kvseg,
            pl.BlockSpec((None, bk), lambda j, b, h: (b, j)),
            pl.BlockSpec((None, n_kv_pad), lambda i, b, h: (b, 0)),
        ))
    if alibi_slopes is not None:
        slopes = jnp.asarray(alibi_slopes, jnp.float32).reshape(heads)
        whole = pl.BlockSpec((heads,), lambda x, b, h: (0,))
        extra.append(("slopes", slopes, whole, whole))
    if dropout_rate:
        seed = _pad_to(pack_dropout_seed(dropout_seed, dropout_offsets), 0, 8)
        whole = pl.BlockSpec((8,), lambda x, b, h: (0,))
        extra.append(("seed", seed, whole, whole))
    common = dict(
        sm_scale=float(sm_scale), causal=causal, window=window,
        sinks=int(sinks), softcap=softcap, dropout_rate=float(dropout_rate),
        dropout_heads=dropout_heads, n_kv=n_kv, block_q=bq, block_k=bk,
        num_heads=heads,
    )
    # 64x64 tiles with 4 warps measured fastest on an H100 at head dim
    # 128: 8 warps were 1.5-1.8x slower, 128-row query tiles up to 1.17x
    # (CHANGES.md).
    params = plt.CompilerParams(num_warps=4, num_stages=2)
    interpret = pallas_interpret()

    # ---- dK/dV: grid (KV block, batch, KV head) ----
    grp = pl.BlockSpec((None, group, n_q_pad, dp),
                       lambda j, b, h: (b, h, 0, 0))
    grp_row = pl.BlockSpec((None, group, n_q_pad), lambda j, b, h: (b, h, 0))
    tile = pl.BlockSpec((None, None, bk, dp), lambda j, b, h: (b, h, j, 0))
    names = ["q", "do", "lse", "delta", "k", "v"] + [e[0] for e in extra]
    dk, dv = pl.pallas_call(
        functools.partial(
            _dkv_kernel, names=tuple(names + ["dk", "dv"]),
            num_q_blocks=n_q_pad // bq, group=group, **common,
        ),
        out_shape=[jax.ShapeDtypeStruct(k_p.shape, k.dtype),
                   jax.ShapeDtypeStruct(v_p.shape, v.dtype)],
        grid=(n_kv_pad // bk, batch, kv_heads),
        in_specs=[grp, grp, grp_row, grp_row, tile, tile]
        + [e[2] for e in extra],
        out_specs=[tile, tile],
        compiler_params=params,
        interpret=interpret,
        backend="triton",
        name="flash_bwd_dkv",
    )(q_p, do_p, lse_p, delta_p, k_p, v_p, *[e[1] for e in extra])

    # ---- dQ: grid (query block, batch, query head) ----
    qtile = pl.BlockSpec((None, None, bq, dp), lambda i, b, h: (b, h, i, 0))
    qrow = pl.BlockSpec((None, None, bq), lambda i, b, h: (b, h, i))
    kv_all = pl.BlockSpec((None, None, n_kv_pad, dp),
                          lambda i, b, h: (b, h // group, 0, 0))
    out_shape = [jax.ShapeDtypeStruct(q_p.shape, q.dtype)]
    out_specs = [qtile]
    names = ["q", "do", "lse", "delta", "k", "v"] + [e[0] for e in extra]
    names.append("dq")
    if alibi_slopes is not None:
        out_shape.append(
            jax.ShapeDtypeStruct((batch, heads, n_q_pad), jnp.float32)
        )
        out_specs.append(qrow)
        names.append("dslope")
    res = pl.pallas_call(
        functools.partial(
            _dq_kernel, names=tuple(names),
            num_kv_blocks=n_kv_pad // bk, **common,
        ),
        out_shape=out_shape,
        grid=(n_q_pad // bq, batch, heads),
        in_specs=[qtile, qtile, qrow, qrow, kv_all, kv_all]
        + [e[3] for e in extra],
        out_specs=out_specs,
        compiler_params=params,
        interpret=interpret,
        backend="triton",
        name="flash_bwd_dq",
    )(q_p, do_p, lse_p, delta_p, k_p, v_p, *[e[1] for e in extra])

    dq = res[0][:, :, :n_q, :head_dim]
    dk = dk[:, :, :n_kv, :head_dim]
    dv = dv[:, :, :n_kv, :head_dim]
    if alibi_slopes is not None:
        d_slopes = jnp.sum(res[1][:, :, :n_q], axis=(0, 2))
        return dq, dk, dv, d_slopes
    return dq, dk, dv
