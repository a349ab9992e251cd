"""Flash-attention forward: one Pallas kernel on the Triton route.

The reference's two performance kernels (``flash_attention_v2_kernel``,
``kernels.metal:457-596``, and the half-precision
``flash_attention_v4_half_kernel``, ``kernels.metal:597-883``) become one
Triton program per (query block, batch, head): it keeps its query tile
and the fp32 online-softmax state in registers and loops over KV blocks
(FlashAttention-2, Algorithm 1).  Triton pipelines the K/V loads across
loop steps (``num_stages``), which is what the reference's ping-pong
K/V staging did by hand.  Softmax statistics are fp32 whatever the
input dtype, like the reference's fp32 m/l registers inside its fp16
kernels (``kernels.metal:633-638``).

Every feature the op exposes is a static specialisation of the same
body:

* causal masking with a per-batch, possibly traced, query offset (query
  row ``r`` of batch ``b`` sees keys ``c <= r // pos_div + q_offset[b]``);
  blocks above the diagonal, and below a sliding window, are skipped by
  the loop bounds, so work scales with the visible area;
* ``window`` with ``sinks`` (the first ``sinks`` keys stay visible);
* packed-sequence segment ids;
* position-space masking for rolling caches (``kv_positions``);
* tanh ``softcap`` and ALiBi slopes between QK^T and masking;
* in-kernel attention dropout from the counter-based hash in
  ``_common.dropout_keep``, bit-identical to the oracle's mask;
* an 8-bit K/V load path (int8 or fp8 with per-token scales ``[B, H,
  N]``): the scales fold into the score columns and the probabilities,
  so the 8-bit tiles are only converted, never rescaled;
* a paged KV pool, where each loop step loads its own page id from the
  page table (there is no scalar prefetch on the GPU);
* ``pos_div``: rows per position, for the GQA decode head-fold
  (``ops.gqa_decode_attention`` packs a KV head's query heads into
  adjacent rows so the cache is read once per KV head).

The LSE output is ``[B, H, N_q]`` fp32 (natural log).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..config import BlockSizes, default_scale
from ._common import dropout_keep, pack_dropout_seed, pallas_interpret

_LOG2E = math.log2(math.e)
_LN2 = math.log(2.0)


def pad_dim(n: int) -> int:
    """Head dims run as the next power of two (at least 16): Triton
    tensors are powers of two and its dot needs 16 columns."""
    return max(16, 1 << (n - 1).bit_length())


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _pad_to(x: jax.Array, axis: int, size: int, value=0) -> jax.Array:
    if x.shape[axis] == size:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, size - x.shape[axis])
    return jnp.pad(x, widths, constant_values=value)


def dot_precision(dtype) -> Optional[jax.lax.Precision]:
    """fp32 operands take full-precision fp32 dots: left at the default,
    Triton would run them in TF32, which keeps ~3 decimal digits and
    cannot hold the 1e-3 fp32 tolerance.  Half and 8-bit operands run
    on the tensor cores with fp32 accumulation."""
    return jax.lax.Precision.HIGHEST if dtype == jnp.float32 else None


def launch_params(block_rows: int, head_dim: int):
    """Warps and pipeline stages for a tile of ``block_rows`` x head dim."""
    warps = 8 if block_rows >= 128 and head_dim >= 128 else 4
    return plt.CompilerParams(
        num_warps=warps, num_stages=2 if head_dim > 128 else 3
    )


def causal_kv_range(i, off, *, block_q, block_k, num_kv_blocks, pos_div,
                    window, sinks):
    """KV block ranges a causal query block must visit.

    Returns ``(sink_hi, lo, hi)``: blocks ``[0, sink_hi)`` hold sink
    keys that sit below the window, and ``[lo, hi)`` the diagonal and
    the window.  Everything else is fully masked and never loaded.
    """
    last_pos = ((i + 1) * block_q - 1) // pos_div + off
    hi = jnp.clip((last_pos + block_k) // block_k, 0, num_kv_blocks)
    if window is None:
        return 0, 0, hi
    first_pos = (i * block_q) // pos_div + off - window + 1
    lo = jnp.clip(jnp.maximum(first_pos, 0) // block_k, 0, hi)
    sink_hi = 0
    if sinks:
        sink_hi = jnp.minimum((sinks + block_k - 1) // block_k, lo)
    return sink_hi, lo, hi


def _fwd_kernel(
    *refs,
    names: Tuple[str, ...],
    sm_scale: float,
    causal: bool,
    window,
    sinks: int,
    softcap,
    dropout_rate: float,
    dropout_heads,
    pos_div: int,
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
    prec = dot_precision(q.dtype)
    scale2 = sm_scale * _LOG2E

    rows = i * block_q + jnp.arange(block_q, dtype=jnp.int32)
    off = r["off"][b] if "off" in r else 0
    row_pos = (rows // pos_div if pos_div != 1 else rows) + off
    row_pos = row_pos[:, None]
    if "qseg" in r:
        qseg = r["qseg"][...][:, None]
    if "slopes" in r:
        slope2 = r["slopes"][h] * _LOG2E
    if dropout_rate:
        seed = [r["seed"][t] for t in range(5)]
        bh_mul = dropout_heads if dropout_heads is not None else num_heads
        drop_bh = (b + seed[3]) * bh_mul + (h + seed[4])
        drop_rows = (seed[1] + rows)[:, None]

    def body(j, carry):
        acc, m_prev, l_prev = carry
        start = j * block_k
        cols = start + jnp.arange(block_k, dtype=jnp.int32)
        if "table" in r:
            page = r["table"][j]
            k = r["k"][page, :, :]
            v = r["v"][page, :, :]
        else:
            k = r["k"][pl.ds(start, block_k), :]
            v = r["v"][pl.ds(start, block_k), :]
        if k.dtype != q.dtype:
            k = k.astype(q.dtype)
            v = v.astype(q.dtype)
        s = pl.dot(q, k, trans_b=True, precision=prec)
        if "ks" in r:
            if "table" in r:
                ks, vs = r["ks"][page, :], r["vs"][page, :]
            else:
                ks = r["ks"][pl.ds(start, block_k)]
                vs = r["vs"][pl.ds(start, block_k)]
            s = s * (ks * scale2)[None, :]
        else:
            s = s * scale2
        if softcap is not None:
            c2 = softcap * _LOG2E
            s = c2 * jnp.tanh(s * (1.0 / c2))
        col_pos = cols[None, :]
        if "kvpos" in r:
            col_pos = r["kvpos"][pl.ds(start, block_k)][None, :]
        if "slopes" in r:
            s = s + slope2 * (col_pos - row_pos).astype(jnp.float32)

        visible = None
        if "kvpos" in r:
            visible = (col_pos <= row_pos) & (col_pos >= 0)
        elif causal:
            visible = col_pos <= row_pos
        if window is not None:
            keep = col_pos > row_pos - window
            if sinks:
                keep = keep | (col_pos < sinks)
            visible = visible & keep
        if "qseg" in r:
            seg = qseg == r["kvseg"][pl.ds(start, block_k)][None, :]
            visible = seg if visible is None else visible & seg
        if n_kv % block_k and "kvpos" not in r:
            in_range = cols[None, :] < n_kv
            visible = in_range if visible is None else visible & in_range
        if visible is not None:
            s = jnp.where(visible, s, -jnp.inf)

        m_new = jnp.maximum(m_prev, jnp.max(s, axis=1))
        m_safe = jnp.where(m_new == -jnp.inf, 0.0, m_new)
        alpha = jnp.exp2(m_prev - m_safe)
        p = jnp.exp2(s - m_safe[:, None])
        l_new = l_prev * alpha + jnp.sum(p, axis=1)
        if dropout_rate:
            # Dropout zeroes entries of the P.V product only; l sums the
            # undropped p, so 1/l normalises before the mask applies.
            p = p * dropout_keep(
                seed[0], drop_bh, drop_rows, (seed[2] + cols)[None, :],
                dropout_rate,
            )
        if "ks" in r:
            p = p * vs[None, :]
        pv = pl.dot(p.astype(v.dtype), v, precision=prec)
        return acc * alpha[:, None] + pv, m_new, l_new

    d = q.shape[-1]
    carry = (
        jnp.zeros((block_q, d), jnp.float32),
        jnp.full((block_q,), -jnp.inf, jnp.float32),
        jnp.zeros((block_q,), jnp.float32),
    )
    if causal and "kvpos" not in r:
        sink_hi, lo, hi = causal_kv_range(
            i, off, block_q=block_q, block_k=block_k,
            num_kv_blocks=num_kv_blocks, pos_div=pos_div, window=window,
            sinks=sinks,
        )
        if sinks and window is not None:
            carry = jax.lax.fori_loop(0, sink_hi, body, carry)
        acc, m, l = jax.lax.fori_loop(lo, hi, body, carry)
    else:
        acc, m, l = jax.lax.fori_loop(0, num_kv_blocks, body, carry)

    empty = l == 0.0
    l_safe = jnp.where(empty, 1.0, l)
    r["o"][...] = (acc / l_safe[:, None]).astype(r["o"].dtype)
    if "lse" in r:
        r["lse"][...] = jnp.where(empty, -jnp.inf, (m + jnp.log2(l_safe)) * _LN2)


def attention_fwd(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    q_offset=None,
    *,
    sm_scale: Optional[float] = None,
    causal: bool = False,
    window: Optional[int] = None,
    sinks: int = 0,
    segment_ids=None,
    kv_positions: Optional[jax.Array] = None,
    k_scale: Optional[jax.Array] = None,
    v_scale: Optional[jax.Array] = None,
    page_table: Optional[jax.Array] = None,
    block_sizes: Optional[BlockSizes] = None,
    save_lse: bool = False,
    softcap: Optional[float] = None,
    alibi_slopes: Optional[jax.Array] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[jax.Array] = None,
    dropout_offsets=None,
    dropout_heads: Optional[int] = None,
    pos_div: int = 1,
):
    """The shared forward wrapper (dense, 8-bit and paged callers).

    ``k``/``v`` are ``[B, H_kv, N_kv, D]``, or with ``page_table`` a pool
    ``[P, H_kv, page_size, D]`` read through ``page_table [B, pages]``.
    ``k_scale``/``v_scale`` are per-token scales shaped like ``k`` without
    its last dim.  Returns ``o`` or ``(o, lse)``.
    """
    batch, heads, n_q, head_dim = q.shape
    kv_heads = k.shape[1]
    if heads % kv_heads:
        raise ValueError(
            f"q heads ({heads}) must be a multiple of kv heads ({kv_heads})"
        )
    group = heads // kv_heads
    paged = page_table is not None
    n_kv = page_table.shape[1] * k.shape[2] if paged else k.shape[2]
    if sm_scale is None:
        sm_scale = default_scale(head_dim)
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        window = int(window)
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if kv_positions is not None and not causal:
        raise ValueError("kv_positions requires causal=True")
    if pos_div != 1:
        if pos_div < 1:
            raise ValueError(f"pos_div must be >= 1, got {pos_div}")
        if not causal:
            raise ValueError("pos_div > 1 requires causal=True")
        if (
            kv_positions is not None
            or segment_ids is not None
            or alibi_slopes is not None
            or dropout_rate
        ):
            raise NotImplementedError(
                "pos_div > 1 (GQA decode head-fold) does not compose with "
                "kv_positions/segment_ids/alibi/dropout"
            )
    if dropout_rate:
        if not 0.0 < dropout_rate < 1.0:
            raise ValueError(
                f"dropout_rate must be in [0, 1), got {dropout_rate}"
            )
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 requires dropout_seed")
        if kv_positions is not None:
            raise NotImplementedError(
                "dropout is a training-path feature; rolling-cache "
                "(kv_positions) serving does not support it"
            )

    bs = (block_sizes or BlockSizes()).resolve(n_q, n_kv, head_dim)
    block_q = bs.block_q
    if paged:
        block_k = k.shape[2]
        if block_k < 16 or block_k & (block_k - 1):
            raise ValueError(
                f"page_size={block_k} must be a power of two >= 16"
            )
    else:
        block_k = bs.block_k
    n_q_pad = _round_up(n_q, block_q)
    n_kv_pad = _round_up(n_kv, block_k)
    dp = pad_dim(head_dim)

    q_p = _pad_to(_pad_to(q, 3, dp), 2, n_q_pad)
    if paged:
        k_p, v_p = _pad_to(k, 3, dp), _pad_to(v, 3, dp)
    else:
        k_p = _pad_to(_pad_to(k, 3, dp), 2, n_kv_pad)
        v_p = _pad_to(_pad_to(v, 3, dp), 2, n_kv_pad)

    names, inputs, specs = [], [], []

    def add(name, x, spec):
        names.append(name)
        inputs.append(x)
        specs.append(spec)

    add("q", q_p, pl.BlockSpec((None, None, block_q, dp),
                               lambda i, b, h: (b, h, i, 0)))
    if paged:
        n_pages, _, page, _ = k.shape
        kv_spec = pl.BlockSpec((n_pages, None, page, dp),
                               lambda i, b, h: (0, h // group, 0, 0))
    else:
        kv_spec = pl.BlockSpec((None, None, n_kv_pad, dp),
                               lambda i, b, h: (b, h // group, 0, 0))
    add("k", k_p, kv_spec)
    add("v", v_p, kv_spec)
    if k_scale is not None:
        if paged:
            sc_spec = pl.BlockSpec((n_pages, None, page),
                                   lambda i, b, h: (0, h // group, 0))
            ks, vs = k_scale, v_scale
        else:
            sc_spec = pl.BlockSpec((None, None, n_kv_pad),
                                   lambda i, b, h: (b, h // group, 0))
            ks = _pad_to(k_scale, 2, n_kv_pad)
            vs = _pad_to(v_scale, 2, n_kv_pad)
        add("ks", ks.astype(jnp.float32), sc_spec)
        add("vs", vs.astype(jnp.float32), sc_spec)
    if paged:
        add("table", jnp.asarray(page_table, jnp.int32),
            pl.BlockSpec((None, page_table.shape[1]),
                         lambda i, b, h: (b, 0)))
    if causal or alibi_slopes is not None or kv_positions is not None:
        if q_offset is None:
            q_offset = n_kv - n_q // pos_div
        off = jnp.broadcast_to(
            jnp.asarray(q_offset, jnp.int32).reshape(-1), (batch,)
        )
        add("off", off, pl.BlockSpec((batch,), lambda i, b, h: (0,)))
    if segment_ids is not None:
        add("qseg",
            _pad_to(segment_ids.q.astype(jnp.int32), 1, n_q_pad, -1),
            pl.BlockSpec((None, block_q), lambda i, b, h: (b, i)))
        add("kvseg",
            _pad_to(segment_ids.kv.astype(jnp.int32), 1, n_kv_pad, -2),
            pl.BlockSpec((None, n_kv_pad), lambda i, b, h: (b, 0)))
    if kv_positions is not None:
        add("kvpos",
            _pad_to(kv_positions.astype(jnp.int32), 1, n_kv_pad, -1),
            pl.BlockSpec((None, n_kv_pad), lambda i, b, h: (b, 0)))
    if alibi_slopes is not None:
        add("slopes", jnp.asarray(alibi_slopes, jnp.float32).reshape(heads),
            pl.BlockSpec((heads,), lambda i, b, h: (0,)))
    if dropout_rate:
        seed = _pad_to(pack_dropout_seed(dropout_seed, dropout_offsets), 0, 8)
        add("seed", seed, pl.BlockSpec((8,), lambda i, b, h: (0,)))

    out_shape = [jax.ShapeDtypeStruct((batch, heads, n_q_pad, dp), q.dtype)]
    out_specs = [pl.BlockSpec((None, None, block_q, dp),
                              lambda i, b, h: (b, h, i, 0))]
    names.append("o")
    if save_lse:
        out_shape.append(
            jax.ShapeDtypeStruct((batch, heads, n_q_pad), jnp.float32)
        )
        out_specs.append(pl.BlockSpec((None, None, block_q),
                                      lambda i, b, h: (b, h, i)))
        names.append("lse")

    kernel = functools.partial(
        _fwd_kernel,
        names=tuple(names),
        sm_scale=float(sm_scale),
        causal=causal,
        window=window,
        sinks=int(sinks),
        softcap=softcap,
        dropout_rate=float(dropout_rate),
        dropout_heads=dropout_heads,
        pos_div=pos_div,
        n_kv=n_kv,
        block_q=block_q,
        block_k=block_k,
        num_kv_blocks=n_kv_pad // block_k,
        num_heads=heads,
    )
    out = pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(n_q_pad // block_q, batch, heads),
        in_specs=specs,
        out_specs=out_specs,
        compiler_params=launch_params(block_q, dp),
        interpret=pallas_interpret(),
        backend="triton",
        name="flash_fwd",
    )(*inputs)
    o = out[0][:, :, :n_q, :head_dim]
    if save_lse:
        return o, out[1][:, :, :n_q]
    return o


@functools.partial(
    jax.jit,
    static_argnames=(
        "sm_scale",
        "causal",
        "window",
        "sinks",
        "block_sizes",
        "save_lse",
        "softcap",
        "dropout_rate",
        "dropout_heads",
        "pos_div",
    ),
)
def flash_attention_fwd(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    q_offset: Optional[jax.Array] = None,
    *,
    sm_scale: Optional[float] = None,
    causal: bool = False,
    window: Optional[int] = None,
    sinks: int = 0,
    segment_ids=None,
    kv_positions: Optional[jax.Array] = None,
    block_sizes: Optional[BlockSizes] = None,
    save_lse: bool = False,
    softcap: Optional[float] = None,
    alibi_slopes: Optional[jax.Array] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[jax.Array] = None,
    dropout_offsets=None,
    dropout_heads: Optional[int] = None,
    pos_div: int = 1,
) -> Union[jax.Array, Tuple[jax.Array, jax.Array]]:
    """Flash-attention forward over ``[B, H, N, D]`` inputs.

    ``q_offset``: optional int32 scalar or per-batch ``[B]`` vector (may
    be traced: ring shards, ragged decode) -- query row ``r`` of batch
    ``b`` attends to keys ``c <= r // pos_div + q_offset[b]`` when
    ``causal``.  Defaults to ``n_kv - n_q // pos_div`` (end-aligned).

    ``window``: with ``causal``, each row sees only its last ``window``
    keys; ``sinks`` keeps the first ``sinks`` keys visible beyond it.

    ``segment_ids``: optional ``config.SegmentIds`` (``q: [B, N_q]``,
    ``kv: [B, N_kv]``) -- tokens attend only within equal ids.

    ``kv_positions``: optional ``[B, N_kv]`` int32 global position of
    each KV slot (-1 == never written); masking runs in position space,
    as a rolling cache needs.  Requires ``causal``; forward only.

    ``softcap``: tanh cap on the scaled scores, ``s = cap*tanh(s/cap)``.
    ``alibi_slopes``: ``[H]`` slopes adding ``slope * (col - row -
    q_offset)`` after the cap (position space with ``kv_positions``).

    ``dropout_rate``/``dropout_seed``: attention-probability dropout from
    a hash of the seed and the absolute (batch*head, row, col), the same
    mask the oracle and the backward kernels regenerate.
    ``dropout_offsets`` ``(row, col, batch, head)`` and ``dropout_heads``
    translate shard-local coordinates to global ones under ``shard_map``.

    ``pos_div``: rows per position (GQA decode head-fold).  Requires
    ``causal``; does not compose with alibi/segments/kv_positions/dropout.

    Returns ``o`` (shape and dtype of ``q``) or ``(o, lse)`` with
    ``lse [B, H, N_q]`` fp32; fully masked rows give ``o = 0`` and
    ``lse = -inf``.
    """
    return attention_fwd(
        q, k, v, q_offset,
        sm_scale=sm_scale, causal=causal, window=window, sinks=sinks,
        segment_ids=segment_ids, kv_positions=kv_positions,
        block_sizes=block_sizes, save_lse=save_lse, softcap=softcap,
        alibi_slopes=alibi_slopes, dropout_rate=dropout_rate,
        dropout_seed=dropout_seed, dropout_offsets=dropout_offsets,
        dropout_heads=dropout_heads, pos_div=pos_div,
    )
