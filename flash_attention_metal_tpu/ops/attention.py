"""Public attention API: typed, differentiable, vmappable.

The reference's "API" is a positional Metal buffer ABI — Q/K/V/O at buffer
indices 0-3, scalars via ``setBytes`` at 4-10 (``main.mm:417-432``).  Here
that becomes a typed Python signature with a ``custom_vjp`` wiring the
FA-2 backward kernels (``flash_bwd.py``) to the forward's logsumexp
residual, the way the reference's V4 forward feeds its backward kernel
(``kernels.metal:861-864`` -> ``kernels.metal:993-996``).

Implementations (``impl``):

* ``"pallas"`` — the Triton-route flash kernels (``kernels/``); every
  feature, GQA without a K/V broadcast.
* ``"xla"``    — the plain jnp path (``reference/oracle.py``, autodiff
  backward); materialises ``[B, H, N, N]`` scores.
* ``"cudnn"``  — ``jax.nn.dot_product_attention(implementation="cudnn")``
  for the calls it covers (``cudnn_covers``: half precision, causal or
  not, GQA, no other feature).
* ``"auto"``   — ``select_impl``: cuDNN where it covers the call on the
  GPU, the Pallas kernel otherwise.
"""

from __future__ import annotations

import collections
import functools
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..config import BlockSizes, default_scale
from ..kernels._common import pack_dropout_seed
from ..kernels.flash_bwd import flash_attention_bwd
from ..kernels.flash_fwd import flash_attention_fwd
from ..reference.oracle import attention_reference, attention_reference_with_lse

IMPLS = ("pallas", "xla", "cudnn")


def cudnn_covers(
    *, dtype, head_dim, save_lse=False, window=None, sinks=0,
    segment_ids=None, softcap=None, alibi_slopes=None, dropout_rate=0.0,
    kv_positions=None, q_offset=None, n_q=None, n_kv=None,
) -> bool:
    """Whether cuDNN's fused attention runs the call, as measured: half
    precision, head dim <= 128, causal or not, GQA, no other feature."""
    return (
        jnp.dtype(dtype) in (jnp.dtype(jnp.bfloat16), jnp.dtype(jnp.float16))
        and head_dim % 8 == 0
        and head_dim <= 128
        and not save_lse
        and window is None
        and not sinks
        and segment_ids is None
        and softcap is None
        and alibi_slopes is None
        and not dropout_rate
        and kv_positions is None
        and q_offset is None
        and n_q == n_kv
    )


def select_impl(**features) -> str:
    """The end ``impl="auto"`` takes for a call with ``features``
    (``cudnn_covers``'s keywords).

    Off the GPU there is only the Pallas kernel (interpreted on request,
    see ``kernels._common.pallas_interpret``).  On the GPU: cuDNN wherever
    it covers the call, the Triton kernel for every other call; the plain
    XLA path was slowest in every measured case (CHANGES.md).  cuDNN won
    forward + backward and non-causal forward on an H100.  The Triton
    kernel was faster on causal forward alone, but the op cannot tell a
    forward-only call from one that will be differentiated, so a covered
    causal call takes cuDNN either way.  Decode does not come here: the
    serving paths call the decode kernels directly.
    """
    if jax.default_backend() == "gpu" and cudnn_covers(**features):
        return "cudnn"
    return "pallas"


# The end each traced call took, by call kind: counted when the call is
# traced, so a compiled program counts once per call site.  Read with
# ``traced_ends`` (the smoke run prints it per phase).
_ENDS: collections.Counter = collections.Counter()


def note_end(kind: str, end: str) -> None:
    """Count a traced call of ``kind`` that took ``end``."""
    _ENDS[(kind, end)] += 1


def traced_ends(clear: bool = False) -> dict:
    """``{(call kind, end): traced calls}`` since the last clear."""
    out = dict(_ENDS)
    if clear:
        _ENDS.clear()
    return out


def _call_kind(causal, q_offset, kv_positions) -> str:
    if kv_positions is not None:
        return "rolling cache"
    if q_offset is not None:
        return "causal, q_offset" if causal else "q_offset"
    return "causal" if causal else "non-causal"


@functools.partial(
    jax.custom_vjp, nondiff_argnums=(7, 8, 9, 10, 11, 12, 13, 14, 15)
)
def _flash_core(
    q, k, v, q_offset, alibi_slopes, dropout_seed, segment_ids,
    causal, window, sinks, sm_scale, softcap, dropout_rate, dropout_heads,
    block_sizes, save_lse,
):
    """The one differentiable attention primitive behind the public op.

    Every capability rides a single custom_vjp: causal/window/sinks,
    packed segments, tanh softcap, ALiBi (with d/d(slopes)), in-kernel
    dropout, GQA, and the optional differentiable logsumexp output — all
    on the Pallas kernel pair, never through an O(N^2) score tensor.

    ``dropout_seed`` is None when ``dropout_rate == 0``; with dropout it
    is the packed ``[seed, row_off, col_off, b_off, h_off]`` int32 vector
    (``kernels._common.pack_dropout_seed``) — traced, so a new seed every
    train step costs no recompile — and the backward kernels regenerate
    the identical mask from it.
    """
    out, _ = _flash_core_fwd_rule(
        q, k, v, q_offset, alibi_slopes, dropout_seed, segment_ids,
        causal, window, sinks, sm_scale, softcap, dropout_rate,
        dropout_heads, block_sizes, save_lse,
    )
    return out


def _flash_core_fwd_rule(
    q, k, v, q_offset, alibi_slopes, dropout_seed, segment_ids,
    causal, window, sinks, sm_scale, softcap, dropout_rate, dropout_heads,
    block_sizes, save_lse,
):
    o, lse = flash_attention_fwd(
        q, k, v, q_offset,
        sm_scale=sm_scale, causal=causal, window=window, sinks=sinks,
        segment_ids=segment_ids, block_sizes=block_sizes, save_lse=True,
        softcap=softcap, alibi_slopes=alibi_slopes,
        dropout_rate=dropout_rate, dropout_seed=dropout_seed,
        dropout_heads=dropout_heads,
    )
    res = (q, k, v, q_offset, alibi_slopes, dropout_seed, segment_ids, o,
           lse)
    return ((o, lse) if save_lse else o), res


def _flash_core_bwd_rule(
    causal, window, sinks, sm_scale, softcap, dropout_rate, dropout_heads,
    block_sizes, save_lse, residuals, cts,
):
    (q, k, v, q_offset, alibi_slopes, dropout_seed, segment_ids, o,
     lse) = residuals
    do, dlse = cts if save_lse else (cts, None)
    grads = flash_attention_bwd(
        q, k, v, o, do, lse, q_offset, dlse,
        sm_scale=sm_scale, causal=causal, window=window, sinks=sinks,
        segment_ids=segment_ids, block_sizes=block_sizes, softcap=softcap,
        alibi_slopes=alibi_slopes, dropout_rate=dropout_rate,
        dropout_seed=dropout_seed, dropout_heads=dropout_heads,
    )
    dq, dk, dv = grads[:3]
    d_slopes = None
    if alibi_slopes is not None:
        d_slopes = grads[3].astype(alibi_slopes.dtype)

    def float0(x):
        return np.zeros(np.shape(x), jax.dtypes.float0)

    d_seg = (
        None
        if segment_ids is None
        else jax.tree_util.tree_map(float0, segment_ids)
    )
    d_seed = None if dropout_seed is None else float0(dropout_seed)
    return dq, dk, dv, float0(q_offset), d_slopes, d_seed, d_seg


_flash_core.defvjp(_flash_core_fwd_rule, _flash_core_bwd_rule)


def _broadcast_kv_heads(q: jax.Array, k: jax.Array, v: jax.Array):
    """GQA/MQA: replicate KV heads up to the Q head count (plain path)."""
    h_q, h_kv = q.shape[1], k.shape[1]
    if h_q == h_kv:
        return k, v
    reps = h_q // h_kv
    return jnp.repeat(k, reps, axis=1), jnp.repeat(v, reps, axis=1)


def _cudnn_attention(q, k, v, *, causal, sm_scale):
    """cuDNN fused attention on ``[B, H, N, D]`` inputs (BNHD inside)."""
    o = jax.nn.dot_product_attention(
        q.transpose(0, 2, 1, 3),
        k.transpose(0, 2, 1, 3),
        v.transpose(0, 2, 1, 3),
        scale=sm_scale,
        is_causal=causal,
        implementation="cudnn",
    )
    return o.transpose(0, 2, 1, 3)


def flash_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    q_offset: Optional[jax.Array] = None,
    segment_ids=None,
    *,
    causal: bool = False,
    window: Optional[int] = None,
    sinks: int = 0,
    kv_positions: Optional[jax.Array] = None,
    sm_scale: Optional[float] = None,
    softcap: Optional[float] = None,
    alibi_slopes: Optional[jax.Array] = None,
    block_sizes: Optional[BlockSizes] = None,
    save_lse: bool = False,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[jax.Array] = None,
    dropout_offsets=None,
    dropout_heads: Optional[int] = None,
    impl: str = "auto",
) -> Union[jax.Array, Tuple[jax.Array, jax.Array]]:
    """Differentiable flash attention over ``[B, H, N, D]`` inputs.

    Args:
      q: ``[batch, q_heads, n_q, head_dim]``.
      k, v: ``[batch, kv_heads, n_kv, head_dim]`` (kv_heads may divide
        q_heads for GQA/MQA).
      q_offset: optional int32 scalar or per-batch ``[B]`` vector (may be
        traced): with ``causal``, query row r attends to key cols
        c <= r + q_offset.  Defaults to ``n_kv - n_q`` (end-aligned).
      causal: apply causal masking.
      window: with causal, restrict each row to its last ``window``
        visible keys (sliding-window attention); out-of-window blocks are
        never loaded.
      segment_ids: optional ``config.SegmentIds`` for packed sequences
        (tokens attend only within equal ids).
      sinks: with window, keep the first ``sinks`` positions visible
        beyond the window (attention sinks / streaming-LLM).
      kv_positions: optional ``[B, N_kv]`` int32 slot-position map for
        rolling (wrapped) KV caches; switches causal/window masking to
        position space.  Forward-only (serving path).
      sm_scale: softmax scale; defaults to ``1/sqrt(head_dim)``.
      softcap: optional tanh logit cap (Gemma-2 style) on the scaled
        scores: ``s = softcap * tanh(s / softcap)``.  Differentiable
        in-kernel.
      alibi_slopes: optional ``[q_heads]`` fp32 ALiBi slopes adding the
        linear position bias ``slope * (col - row - q_offset)``.
        Differentiable, including d/d(slopes).
      block_sizes: kernel tiles (see ``config.BlockSizes``).
      save_lse: also return per-row logsumexp ``[B, H, N_q]`` (fp32).
        Both outputs are differentiable.
      dropout_rate: attention-probability dropout.  The keep mask
        {0, 1/(1-rate)} is a stateless hash of ``dropout_seed`` (traced
        int32 scalar — new seed each step, no recompile) and absolute
        coordinates; the backward kernels regenerate it bit-exactly, so
        no mask tensor ever hits HBM.  Not with ``kv_positions``.
      dropout_seed: int32 scalar; required when ``dropout_rate > 0``.
      dropout_offsets: optional ``(row, col, batch, head)`` int32 scalars
        (traced OK) translating shard-local coordinates to GLOBAL ones
        under ``shard_map``, so every mesh factorization regenerates the
        exact single-device mask.
      dropout_heads: static global head count for the (b, h) hash stream
        (required for exactness under tp head sharding; defaults to the
        local head count).
      impl: "auto" | "pallas" | "xla" | "cudnn" (see the module doc).

    Returns:
      ``o`` with the shape/dtype of ``q``, or ``(o, lse)``.
    """
    if q.ndim != 4:
        raise ValueError(f"expected [B, H, N, D] inputs, got {q.shape}")
    if sm_scale is None:
        sm_scale = default_scale(q.shape[-1])
    if q.shape[1] % k.shape[1]:
        raise ValueError(
            f"q heads ({q.shape[1]}) must be a multiple of kv heads "
            f"({k.shape[1]})"
        )
    features = dict(
        dtype=q.dtype, head_dim=q.shape[-1], save_lse=save_lse, window=window, sinks=sinks,
        segment_ids=segment_ids, softcap=softcap, alibi_slopes=alibi_slopes,
        dropout_rate=dropout_rate, kv_positions=kv_positions,
        q_offset=q_offset, n_q=q.shape[2], n_kv=k.shape[2],
    )
    if impl == "auto":
        impl = select_impl(**features)
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    # The rolling-cache path below runs the kernel whatever the impl.
    note_end(_call_kind(causal, q_offset, kv_positions),
             "pallas" if kv_positions is not None else impl)
    if impl == "cudnn":
        if not cudnn_covers(**features):
            raise NotImplementedError(
                "impl='cudnn' covers half-precision causal/non-causal "
                "attention with GQA and head dim <= 128 only"
            )
        return _cudnn_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    if q_offset is None:
        q_offset = k.shape[2] - q.shape[2]
    q_offset = jnp.asarray(q_offset, jnp.int32)

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
        dropout_seed = pack_dropout_seed(dropout_seed, dropout_offsets)

    if kv_positions is not None:
        # Rolling-cache serving path: forward-only, straight to the kernel.
        return flash_attention_fwd(
            q, k, v, q_offset,
            sm_scale=sm_scale, causal=causal, window=window, sinks=sinks,
            kv_positions=kv_positions, block_sizes=block_sizes,
            save_lse=save_lse, softcap=softcap, alibi_slopes=alibi_slopes,
        )

    if impl == "xla":
        k, v = _broadcast_kv_heads(q, k, v)
        if q_offset.ndim == 1:  # per-batch offsets broadcast over [H, N]
            q_offset = q_offset[:, None, None, None]
        common = dict(
            causal=causal, sm_scale=sm_scale, q_offset=q_offset,
            window=window, sinks=sinks, segment_ids=segment_ids,
            softcap=softcap, alibi_slopes=alibi_slopes,
        )
        if save_lse:
            if dropout_rate:
                raise NotImplementedError("save_lse with dropout")
            return attention_reference_with_lse(q, k, v, **common)
        return attention_reference(
            q, k, v, dropout_rate=dropout_rate, dropout_seed=dropout_seed,
            dropout_heads=dropout_heads, **common,
        )

    if alibi_slopes is not None:
        alibi_slopes = jnp.asarray(alibi_slopes, jnp.float32)
    return _flash_core(
        q,
        k,
        v,
        q_offset,
        alibi_slopes,
        dropout_seed if dropout_rate else None,
        segment_ids,
        causal,
        window,
        sinks,
        sm_scale,
        softcap,
        dropout_rate,
        dropout_heads if dropout_rate else None,
        block_sizes,
        save_lse,
    )


def mha(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    **kwargs,
) -> jax.Array:
    """Convenience wrapper for ``[B, N, H, D]`` (sequence-major) layouts."""
    out = flash_attention(
        q.transpose(0, 2, 1, 3),
        k.transpose(0, 2, 1, 3),
        v.transpose(0, 2, 1, 3),
        **kwargs,
    )
    if isinstance(out, tuple):
        o, lse = out
        return o.transpose(0, 2, 1, 3), lse
    return out.transpose(0, 2, 1, 3)


def fold_gqa_rows(q: jax.Array, kv_heads: int) -> jax.Array:
    """[B, Hq, T, D] -> [B, Hkv, T*group, D] with row = t*group + g.

    Row-major grouping matches the kernels' ``h // kv_group`` GQA
    convention (q-head index = kv*group + g) and the ``pos_div`` mask
    semantics (position = row // group)."""
    b, hq, t, d = q.shape
    group = hq // kv_heads
    return (
        q.reshape(b, kv_heads, group, t, d)
        .transpose(0, 1, 3, 2, 4)
        .reshape(b, kv_heads, t * group, d)
    )


def unfold_gqa_rows(x: jax.Array, q_heads: int, t: int) -> jax.Array:
    """Inverse of ``fold_gqa_rows`` on outputs (any trailing dims)."""
    b, hkv = x.shape[:2]
    group = q_heads // hkv
    tail = x.shape[3:]
    x = x.reshape(b, hkv, t, group, *tail)
    perm = (0, 1, 3, 2) + tuple(range(4, x.ndim))
    return x.transpose(*perm).reshape(b, q_heads, t, *tail)


def gqa_decode_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    q_offset: jax.Array,
    *,
    window: Optional[int] = None,
    sinks: int = 0,
    softcap: Optional[float] = None,
    sm_scale: Optional[float] = None,
    block_sizes: Optional[BlockSizes] = None,
    save_lse: bool = False,
) -> Union[jax.Array, Tuple[jax.Array, jax.Array]]:
    """Head-folded GQA/MQA decode attention (forward-only, serving path).

    ``q``: ``[B, H_q, T, D]`` new-token queries at positions
    ``q_offset[b] + t``; ``k, v``: ``[B, H_kv, N, D]`` cache.  A program
    per query head would stream each KV head's cache ``group = H_q /
    H_kv`` times; folding the group's query heads into adjacent rows of
    one tile (kernel ``pos_div``: row ``r`` masks at position
    ``r // group``) streams it once per KV head and gives the dots real
    rows instead of one.

    Returns ``o`` shaped like ``q`` (and ``lse [B, H_q, T]``).
    Not composable with ALiBi (per-head slopes would need per-row
    slopes), rolling caches, or dropout; use ``flash_attention`` there.
    """
    b, hq, t, d = q.shape
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"q heads ({hq}) not a multiple of kv heads ({hkv})")
    group = hq // hkv
    note_end("GQA-folded decode", "pallas")
    out = flash_attention_fwd(
        fold_gqa_rows(q, hkv), k, v, q_offset, causal=True, window=window,
        sinks=sinks, softcap=softcap, sm_scale=sm_scale,
        block_sizes=block_sizes, save_lse=save_lse, pos_div=group,
    )
    if save_lse:
        return unfold_gqa_rows(out[0], hq, t), unfold_gqa_rows(out[1], hq, t)
    return unfold_gqa_rows(out, hq, t)
