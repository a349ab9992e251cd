"""Sequence-sharded (sp) serving decode — the BASELINE config-5 composite.

The KV cache's *length* dimension is sharded over the mesh's ``sp`` axis
(slots stay sharded over ``dp``); every decode step computes a partial
attention against the local KV shard and merges partials with the
cross-chip logsumexp combine (``parallel.context.lse_psum_combine``) —
the reference's online-softmax merge (``kernels.metal:148-159``) lifted
to the serving cache, seeded by its LSE persistence design
(``kernels.metal:861-864``).

Mechanics:

* **Masked shard appends.** A token at global position ``p`` lives in sp
  shard ``p // maxloc``; every shard computes the new K/V (activations
  are replicated over sp) but only the owner's dynamic-update sticks —
  no gather, no host logic, one compiled program for every occupancy.
* **Local causal offset.** The kernel's per-batch ``q_offset`` becomes
  ``lengths - my_sp * maxloc``: shards wholly before the write head see
  everything (offset >= maxloc), the owner shard gets the usual ragged
  decode mask, shards after it are fully masked and their partials carry
  ``lse = -inf`` so the combine weights them to zero.
* **Quantized shards.** The int8/fp8 cache (``kernels/quant.py``)
  shards identically — values and per-token scales split on the same
  axis, so each chip holds ``1/sp`` of an already-8-bit cache.

Supported cache types: dense ``KVCache`` and ``QuantKVCache``.  Rolling
(window) caches stay dp-only — a wrapped position map has no contiguous
shard ownership.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec

from ..kernels.flash_fwd import flash_attention_fwd
from ..kernels.quant import QuantizedKV, flash_attention_quant, quantize_tokens
from ..models.transformer import (
    ModelConfig,
    Params,
    _maybe_rope,
    _merge_heads,
    _split_heads,
    alibi_slopes,
    mlp_block,
    rms_norm,
)
from ..ops.attention import note_end
from ..parallel.context import lse_psum_combine
from .decode import sample_batch
from .kv_cache import KVCache, QuantKVCache, bump_lengths


def _tp_mlp(layer, x, cfg, head_axis):
    """Megatron MLP: column-parallel gate/up, row-parallel down + psum."""
    if head_axis is None:
        return mlp_block(layer, x, cfg)
    dt = cfg.dtype
    h = rms_norm(x, layer["mlp_norm"])
    gate = jax.nn.silu(h @ layer["w_gate"].astype(dt))
    up = h @ layer["w_up"].astype(dt)
    out = (gate * up) @ layer["w_down"].astype(dt)
    return x + jax.lax.psum(out, head_axis)


def cache_pspec(
    leaf,
    batch_axis: str,
    seq_axis: Optional[str] = None,
    head_axis: Optional[str] = None,
) -> PartitionSpec:
    """PartitionSpec for a KV-cache leaf: slots on ``batch_axis``, the
    length dim on ``seq_axis`` (sp), the KV-head dim on ``head_axis``
    (tp).

    Leaf ranks: 5 = k/v values ``[L, B, H, len, D]``; 4 = quant scales
    ``[L, B, H, len]``; 1 = lengths ``[B]``.
    """
    if leaf.ndim == 5:
        return PartitionSpec(None, batch_axis, head_axis, seq_axis, None)
    if leaf.ndim == 4:
        return PartitionSpec(None, batch_axis, head_axis, seq_axis)
    if leaf.ndim == 1:
        return PartitionSpec(batch_axis)
    raise ValueError(
        f"unsupported cache leaf rank {leaf.ndim} for sequence sharding "
        "(rolling caches are dp-only)"
    )


def param_pspecs(params, head_axis: Optional[str]):
    """Megatron tensor-parallel PartitionSpecs for the decode params.

    Column-parallel: wq/wk/wv (heads live in the output columns) and
    w_gate/w_up; row-parallel (psum after): wo, w_down.  Norms, embed,
    and lm_head stay replicated (decode logits are psum'd only through
    the row-parallel projections, then identical on every tp shard).
    """
    rep = PartitionSpec()
    if head_axis is None:
        return jax.tree_util.tree_map(lambda _: rep, params)
    col = PartitionSpec(None, head_axis)
    row = PartitionSpec(head_axis, None)
    layer_spec = {
        "attn_norm": rep,
        "wq": col,
        "wk": col,
        "wv": col,
        "wo": row,
        "mlp_norm": rep,
        "w_gate": col,
        "w_up": col,
        "w_down": row,
    }
    return {
        "embed": rep,
        "layers": [dict(layer_spec) for _ in params["layers"]],
        "final_norm": rep,
        "lm_head": rep,
    }


def _quantize_like(cache: QuantKVCache, x: jax.Array):
    """Symmetric per-token absmax quantization matching append_tokens_quant."""
    from ..kernels.quant import _QMAX

    qdtype = cache.k_q.dtype
    qmax = _QMAX[jnp.dtype(qdtype)]
    amax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=-1, keepdims=True)
    scale = jnp.maximum(amax, 1e-12) / qmax
    xf = x.astype(jnp.float32) / scale
    if jnp.dtype(qdtype) == jnp.int8.dtype:
        xq = jnp.clip(jnp.round(xf), -qmax, qmax).astype(qdtype)
    else:
        xq = xf.astype(qdtype)
    return xq, scale[..., 0]


def _masked_append(buf, new, start, owned, per_row: bool = False):
    """Write ``new [B, H, T, D]`` at per-slot offsets where ``owned``.

    ``buf``: the local shard ``[B, H, maxloc, D]``; non-owned slots keep
    their previous contents (read-modify-write through a clipped index).

    ``per_row=True`` ignores the chunk-wise ``owned`` and instead writes
    each row ``t`` iff ``0 <= start + t < maxloc`` — required when a
    multi-row chunk may straddle an sp-shard boundary (the speculative
    verify window lands at arbitrary lengths, unlike 128-aligned prefill
    chunks).  ``T`` must be small and static (it unrolls row updates).
    """
    t_new = new.shape[2]
    maxloc = buf.shape[2]

    if per_row:

        def put_rows(b, nw, st):
            for t in range(t_new):
                pos = st + t
                ow = (pos >= 0) & (pos < maxloc)
                idx = jnp.clip(pos, 0, maxloc - 1)
                old = jax.lax.dynamic_slice(
                    b, (0, idx, 0), (b.shape[0], 1, b.shape[2])
                )
                b = jax.lax.dynamic_update_slice(
                    b, jnp.where(ow, nw[:, t : t + 1], old), (0, idx, 0)
                )
            return b

        return jax.vmap(put_rows)(buf, new, start)

    def put(b, nw, st, ow):
        idx = jnp.clip(st, 0, maxloc - t_new)
        old = jax.lax.dynamic_slice(
            b, (0, idx, 0), (b.shape[0], t_new, b.shape[2])
        )
        return jax.lax.dynamic_update_slice(
            b, jnp.where(ow, nw, old), (0, idx, 0)
        )

    return jax.vmap(put)(buf, new, start, owned)


def _masked_append_scale(buf, new, start, owned, per_row: bool = False):
    """Scale variant: ``buf [B, H, maxloc]``, ``new [B, H, T]``."""
    t_new = new.shape[2]
    maxloc = buf.shape[2]

    if per_row:

        def put_rows(b, nw, st):
            for t in range(t_new):
                pos = st + t
                ow = (pos >= 0) & (pos < maxloc)
                idx = jnp.clip(pos, 0, maxloc - 1)
                old = jax.lax.dynamic_slice(b, (0, idx), (b.shape[0], 1))
                b = jax.lax.dynamic_update_slice(
                    b, jnp.where(ow, nw[:, t : t + 1], old), (0, idx)
                )
            return b

        return jax.vmap(put_rows)(buf, new, start)

    def put(b, nw, st, ow):
        idx = jnp.clip(st, 0, maxloc - t_new)
        old = jax.lax.dynamic_slice(b, (0, idx), (b.shape[0], t_new))
        return jax.lax.dynamic_update_slice(
            b, jnp.where(ow, nw, old), (0, idx)
        )

    return jax.vmap(put)(buf, new, start, owned)


def _sp_attn_with_cache(
    layer: Params,
    x: jax.Array,
    cfg: ModelConfig,
    cache,
    layer_idx: int,
    positions: jax.Array,
    *,
    seq_axis: Optional[str],
    head_axis: Optional[str] = None,
    tp_size: int = 1,
    row_owned: bool = False,
) -> Tuple[jax.Array, object]:
    """One attention block against the LOCAL KV shard: sp lse-combine
    across sequence shards, Megatron column/row sharding across tp.

    Call inside ``shard_map``; ``x``/``positions`` replicated over
    sp/tp, ``cache`` the local shard.  Mirrors
    ``decode._attn_with_cache``.

    ``row_owned=True`` switches the shard appends to per-row ownership
    so a small multi-row chunk may straddle the sp boundary (speculative
    verify windows land at arbitrary lengths).
    """
    if cfg.attn_window is not None:
        raise ValueError(
            "sequence-sharded decode does not compose with sliding-window "
            "caches (window masking is slot-local); use dp sharding"
        )
    dt = cfg.dtype
    t_new = x.shape[1]
    my_sp = jax.lax.axis_index(seq_axis) if seq_axis is not None else 0

    # Score transforms (softcap / ALiBi) ride the sharded path too
    # (round 5; the reference's production kernel carries every feature
    # in one path, ``kernels.metal:600-883``).  softcap is elementwise —
    # shard-local by construction.  ALiBi needs global distances: the
    # kernel computes ``dist = col - (row + q_offset)`` and the sp
    # offset below is ``global_qpos - my_sp*maxloc``, so the shard term
    # cancels and distances come out in global position space on every
    # shard.  Under tp, each shard's q heads are the contiguous
    # ``[my_tp*h_loc, (my_tp+1)*h_loc)`` block of the column-parallel
    # projection — slice the [H] slope vector to match.
    slopes = None
    if cfg.attn_alibi:
        slopes = alibi_slopes(cfg.n_heads)
        if head_axis is not None:
            h_loc = cfg.n_heads // tp_size
            my_tp = jax.lax.axis_index(head_axis)
            slopes = jax.lax.dynamic_slice(slopes, (my_tp * h_loc,), (h_loc,))
    _transforms = dict(softcap=cfg.attn_softcap, alibi_slopes=slopes)

    # Column-parallel projections: the weight shard's columns ARE this
    # tp shard's heads, so head splitting just uses the local counts.
    h = rms_norm(x, layer["attn_norm"])
    q = _split_heads(
        h @ layer["wq"].astype(dt), cfg.n_heads // tp_size, cfg.head_dim
    )
    k = _split_heads(
        h @ layer["wk"].astype(dt), cfg.n_kv_heads // tp_size, cfg.head_dim
    )
    v = _split_heads(
        h @ layer["wv"].astype(dt), cfg.n_kv_heads // tp_size, cfg.head_dim
    )
    q = _maybe_rope(q, positions, cfg)
    k = _maybe_rope(k, positions, cfg)

    is_quant = isinstance(cache, QuantKVCache)
    note_end(
        f"sharded {'decode' if t_new == 1 else 'prefill'}, "
        f"{'8-bit' if is_quant else 'dense'} cache",
        "pallas",
    )
    maxloc = (cache.k_q if is_quant else cache.k).shape[3]
    local_start = cache.lengths - my_sp * maxloc  # [B], may be negative
    owned = (local_start >= 0) & (local_start + t_new <= maxloc)
    # The kernel's causal convention: query row r attends local columns
    # c <= r + offset with offset = lengths - my_sp*maxloc (fully visible
    # shards get offset >= maxloc; fully future shards go to lse=-inf).
    offset = local_start

    if is_quant:
        kq, ks = _quantize_like(cache, k)
        vq, vs = _quantize_like(cache, v)
        k_l = _masked_append(
            cache.k_q[layer_idx], kq, local_start, owned, per_row=row_owned
        )
        v_l = _masked_append(
            cache.v_q[layer_idx], vq, local_start, owned, per_row=row_owned
        )
        ks_l = _masked_append_scale(
            cache.k_scale[layer_idx], ks, local_start, owned,
            per_row=row_owned,
        )
        vs_l = _masked_append_scale(
            cache.v_scale[layer_idx], vs, local_start, owned,
            per_row=row_owned,
        )
        import dataclasses as _dc

        cache = _dc.replace(
            cache,
            k_q=cache.k_q.at[layer_idx].set(k_l),
            v_q=cache.v_q.at[layer_idx].set(v_l),
            k_scale=cache.k_scale.at[layer_idx].set(ks_l),
            v_scale=cache.v_scale.at[layer_idx].set(vs_l),
        )
        o_l, lse_l = flash_attention_quant(
            q,
            QuantizedKV(k_q=k_l, v_q=v_l, k_scale=ks_l, v_scale=vs_l),
            offset,
            causal=True,
            save_lse=True,
            **_transforms,
        )
    else:
        k_l = _masked_append(
            cache.k[layer_idx], k, local_start, owned, per_row=row_owned
        )
        v_l = _masked_append(
            cache.v[layer_idx], v, local_start, owned, per_row=row_owned
        )
        cache = KVCache(
            k=cache.k.at[layer_idx].set(k_l),
            v=cache.v.at[layer_idx].set(v_l),
            lengths=cache.lengths,
        )
        o_l, lse_l = flash_attention_fwd(
            q,
            k_l,
            v_l,
            offset,
            causal=True,
            save_lse=True,
            **_transforms,
        )

    if seq_axis is not None:
        o = lse_psum_combine(o_l, lse_l, seq_axis).astype(dt)
    else:
        o = o_l
    out = _merge_heads(o) @ layer["wo"].astype(dt)
    if head_axis is not None:
        # Row-parallel output projection: partial sums join over tp.
        out = jax.lax.psum(out, head_axis)
    return x + out, cache


class SpStepFns:
    """jit+shard_map'd prefill/decode steps for a (dp x sp x tp)-sharded
    engine.

    ``decode_and_sample(params, cache, tokens, active, key, temps,
    top_ks, top_ps)``, ``decode_step(params, cache, tokens, active)``
    (logits only) and
    ``prefill_chunk(params, cache, tokens, start_len, prompt_len, slot)``
    take/return GLOBAL arrays laid out per ``cache_pspec`` /
    ``param_pspecs``.  ``seq_axis`` shards the KV length dim (lse
    combine), ``head_axis`` shards heads + Megatron weights (psum after
    the row-parallel projections); either may be None.
    """

    def __init__(
        self,
        mesh: Mesh,
        cfg: ModelConfig,
        *,
        batch_axis: str = "dp",
        seq_axis: Optional[str] = "sp",
        head_axis: Optional[str] = None,
    ):
        self.mesh = mesh
        self.cfg = cfg
        self.batch_axis = batch_axis
        self.seq_axis = seq_axis
        self.head_axis = head_axis
        self.tp_size = mesh.shape[head_axis] if head_axis else 1
        if self.tp_size > 1 and (
            cfg.n_heads % self.tp_size or cfg.n_kv_heads % self.tp_size
        ):
            raise ValueError(
                f"n_heads={cfg.n_heads}/n_kv_heads={cfg.n_kv_heads} must "
                f"divide over {head_axis}={self.tp_size}"
            )
        tp_size = self.tp_size
        self._prefill_fn = None

        cspec = functools.partial(
            cache_pspec, batch_axis=batch_axis, seq_axis=seq_axis,
            head_axis=head_axis,
        )
        rep = PartitionSpec()
        dp = PartitionSpec(batch_axis)

        def logits_step(params, cache, tok, active):
            """One sharded decode step's logits (shard-local view).

            lm_head is replicated (see param_pspecs), so the logits are
            identical on every tp/sp shard of a dp group.
            """
            positions = cache.lengths[:, None]
            x = params["embed"][tok[:, None]].astype(cfg.dtype)
            for i, layer in enumerate(params["layers"]):
                x, cache = _sp_attn_with_cache(
                    layer, x, cfg, cache, i, positions, seq_axis=seq_axis,
                    head_axis=head_axis, tp_size=tp_size,
                )
                x = _tp_mlp(layer, x, cfg, head_axis)
            x = rms_norm(x, params["final_norm"])
            logits = (x @ params["lm_head"].astype(cfg.dtype)).astype(
                jnp.float32
            )[:, 0]
            return logits, bump_lengths(cache, 1, active)

        def one_step(params, cache, tok, active, k_i, temps, top_ks,
                     top_ps, pen_counts, presences, frequencies, min_ps):
            """One sharded decode+sample step (shard-local view); ``k_i``
            must already be dp-folded."""
            logits, cache = logits_step(params, cache, tok, active)
            toks = sample_batch.__wrapped__(
                logits, k_i, temps,
                top_ks, top_ps, pen_counts, presences, frequencies, min_ps,
            )
            toks = jnp.where(active, toks, 0)
            b = toks.shape[0]
            logp = jax.nn.log_softmax(logits, axis=-1)[jnp.arange(b), toks]
            pen_counts = pen_counts.at[jnp.arange(b), toks].add(
                active.astype(jnp.int32)
            )
            return toks, logp, cache, pen_counts

        self._one_step = one_step

        def decode_body(params, cache, tokens, active, key, temps,
                        top_ks, top_ps, pen_counts, presences, frequencies,
                        min_ps):
            my_dp = jax.lax.axis_index(batch_axis)
            return one_step(
                params, cache, tokens, active,
                jax.random.fold_in(key, my_dp), temps, top_ks, top_ps,
                pen_counts, presences, frequencies, min_ps,
            )

        def _wrap_decode(params, cache, tokens, active, key, temps,
                         top_ks=None, top_ps=None, pen_counts=None,
                         presences=None, frequencies=None, min_ps=None):
            b = tokens.shape[0]
            if top_ks is None:
                top_ks = jnp.zeros(tokens.shape, jnp.int32)
            if top_ps is None:
                top_ps = jnp.ones(tokens.shape, jnp.float32)
            if pen_counts is None:
                pen_counts = jnp.zeros((b, cfg.vocab_size), jnp.int32)
            if presences is None:
                presences = jnp.zeros((b,), jnp.float32)
            if frequencies is None:
                frequencies = jnp.zeros((b,), jnp.float32)
            if min_ps is None:
                min_ps = jnp.zeros((b,), jnp.float32)
            spec = jax.tree_util.tree_map(cspec, cache)
            fn = jax.shard_map(
                decode_body,
                mesh=mesh,
                in_specs=(
                    param_pspecs(params, head_axis),
                    spec,
                    dp,
                    dp,
                    rep,
                    dp,
                    dp,
                    dp,
                    dp,
                    dp,
                    dp,
                    dp,
                ),
                out_specs=(dp, dp, spec, dp),
                check_vma=False,
            )
            return fn(params, cache, tokens, active, key, temps,
                      top_ks, top_ps, pen_counts, presences, frequencies,
                      min_ps)

        self.decode_and_sample = jax.jit(_wrap_decode, donate_argnums=(1,))

        def _wrap_logits(params, cache, tokens, active):
            spec = jax.tree_util.tree_map(cspec, cache)
            fn = jax.shard_map(
                logits_step,
                mesh=mesh,
                in_specs=(param_pspecs(params, head_axis), spec, dp, dp),
                out_specs=(dp, spec),
                check_vma=False,
            )
            return fn(params, cache, tokens, active)

        # ``decode.decode_step``'s sharded twin: one step's logits over
        # given tokens, for teacher-forced comparison with one device.
        self.decode_step = jax.jit(_wrap_logits, donate_argnums=(1,))
        self._multi_fns = {}

    # ------------------------------------------------------------------
    def _build_multi(self, n_steps: int):
        """``n_steps`` sharded decode+sample steps in ONE dispatch: a
        ``lax.scan`` chains the sampled token of step i into step i+1
        inside ``shard_map`` (the sp lse-combine and tp psums run inside
        the scan body — XLA collectives compose with scan), mirroring
        ``decode.decode_and_sample_multi`` on the dense path.  Returns
        ``[n_steps, B]`` tokens/logps."""
        mesh = self.mesh
        batch_axis = self.batch_axis
        head_axis = self.head_axis
        one_step = self._one_step
        cspec = functools.partial(
            cache_pspec, batch_axis=batch_axis, seq_axis=self.seq_axis,
            head_axis=head_axis,
        )
        rep = PartitionSpec()
        dp = PartitionSpec(batch_axis)

        def multi_body(params, cache, tokens, active, key, temps,
                       top_ks, top_ps, pen_counts, presences, frequencies,
                       min_ps):
            my_dp = jax.lax.axis_index(batch_axis)

            def body(carry, k_i):
                tok, c, counts = carry
                toks, logp, c, counts = one_step(
                    params, c, tok, active, k_i, temps, top_ks, top_ps,
                    counts, presences, frequencies, min_ps,
                )
                return (toks, c, counts), (toks, logp)

            keys = jax.random.split(
                jax.random.fold_in(key, my_dp), n_steps
            )
            (_, cache, pen_counts), (all_toks, all_logps) = jax.lax.scan(
                body, (tokens, cache, pen_counts), keys
            )
            return all_toks, all_logps, cache, pen_counts

        def _wrap(params, cache, tokens, active, key, temps,
                  top_ks=None, top_ps=None, pen_counts=None,
                  presences=None, frequencies=None, min_ps=None):
            b = tokens.shape[0]
            if top_ks is None:
                top_ks = jnp.zeros(tokens.shape, jnp.int32)
            if top_ps is None:
                top_ps = jnp.ones(tokens.shape, jnp.float32)
            if pen_counts is None:
                pen_counts = jnp.zeros((b, self.cfg.vocab_size), jnp.int32)
            if presences is None:
                presences = jnp.zeros((b,), jnp.float32)
            if frequencies is None:
                frequencies = jnp.zeros((b,), jnp.float32)
            if min_ps is None:
                min_ps = jnp.zeros((b,), jnp.float32)
            spec = jax.tree_util.tree_map(cspec, cache)
            # [n_steps, B] outputs: batch is dim 1.
            step_dp = PartitionSpec(None, batch_axis)
            fn = jax.shard_map(
                multi_body,
                mesh=mesh,
                in_specs=(
                    param_pspecs(params, head_axis),
                    spec, dp, dp, rep, dp, dp, dp, dp, dp, dp, dp,
                ),
                out_specs=(step_dp, step_dp, spec, dp),
                check_vma=False,
            )
            return fn(params, cache, tokens, active, key, temps,
                      top_ks, top_ps, pen_counts, presences, frequencies,
                      min_ps)

        return jax.jit(_wrap, donate_argnums=(1,))

    def decode_and_sample_multi(self, params, cache, tokens, active, key,
                                temps, top_ks=None, top_ps=None,
                                pen_counts=None, presences=None,
                                frequencies=None, min_ps=None, *,
                                n_steps: int):
        fn = self._multi_fns.get(n_steps)
        if fn is None:
            fn = self._multi_fns[n_steps] = self._build_multi(n_steps)
        return fn(params, cache, tokens, active, key, temps, top_ks,
                  top_ps, pen_counts, presences, frequencies, min_ps)

    # ------------------------------------------------------------------
    def _build_prefill(self):
        cfg = self.cfg
        mesh = self.mesh
        batch_axis, seq_axis = self.batch_axis, self.seq_axis
        head_axis, tp_size = self.head_axis, self.tp_size
        cspec = functools.partial(
            cache_pspec, batch_axis=batch_axis, seq_axis=seq_axis,
            head_axis=head_axis,
        )
        rep = PartitionSpec()

        def prefill_body(params, cache, tokens, start_len, prompt_len, slot):
            # ``slot`` is traced (replicated int32): ONE compilation
            # serves every slot (the body below is already dynamic-slice
            # based — only the closure captured it statically before).
            my_dp = jax.lax.axis_index(batch_axis)
            b_loc = cache.lengths.shape[0]
            slot_local = slot - my_dp * b_loc
            owned_dp = (slot_local >= 0) & (slot_local < b_loc)
            sl = jnp.clip(slot_local, 0, b_loc - 1)

            def view(leaf):
                if leaf.ndim == 1:
                    return jnp.full((1,), start_len, jnp.int32)
                if leaf.ndim == 4:
                    return jax.lax.dynamic_slice(
                        leaf,
                        (0, sl, 0, 0),
                        (leaf.shape[0], 1, leaf.shape[2], leaf.shape[3]),
                    )
                return jax.lax.dynamic_slice(
                    leaf,
                    (0, sl, 0, 0, 0),
                    (leaf.shape[0], 1, *leaf.shape[2:]),
                )

            slot_cache = jax.tree_util.tree_map(view, cache)
            n_chunk = tokens.shape[0]
            positions = (start_len + jnp.arange(n_chunk))[None, :]
            x = params["embed"][tokens[None, :]].astype(cfg.dtype)
            for i, layer in enumerate(params["layers"]):
                x, slot_cache = _sp_attn_with_cache(
                    layer, x, cfg, slot_cache, i, positions,
                    seq_axis=seq_axis, head_axis=head_axis, tp_size=tp_size,
                )
                x = _tp_mlp(layer, x, cfg, head_axis)
            x = rms_norm(x, params["final_norm"])
            logits = (x @ params["lm_head"].astype(cfg.dtype)).astype(
                jnp.float32
            )
            new_len = jnp.minimum(
                prompt_len, start_len + n_chunk
            ).astype(jnp.int32)

            def write(buf, new):
                if buf.ndim == 1:
                    old = jax.lax.dynamic_slice(buf, (sl,), (1,))
                    val = jnp.where(owned_dp, new_len, old)
                    return jax.lax.dynamic_update_slice(buf, val, (sl,))
                if buf.ndim == 4:
                    old = jax.lax.dynamic_slice(
                        buf,
                        (0, sl, 0, 0),
                        (buf.shape[0], 1, buf.shape[2], buf.shape[3]),
                    )
                    return jax.lax.dynamic_update_slice(
                        buf, jnp.where(owned_dp, new, old), (0, sl, 0, 0)
                    )
                old = jax.lax.dynamic_slice(
                    buf, (0, sl, 0, 0, 0), (buf.shape[0], 1, *buf.shape[2:])
                )
                return jax.lax.dynamic_update_slice(
                    buf, jnp.where(owned_dp, new, old), (0, sl, 0, 0, 0)
                )

            new_cache = jax.tree_util.tree_map(write, cache, slot_cache)
            last_idx = jnp.clip(prompt_len - start_len - 1, 0, n_chunk - 1)
            last = logits[0, last_idx]
            # Non-owner dp shards computed a different slot's view; keep
            # only the owner's logits (replicated by the psum).
            last = jax.lax.psum(
                jnp.where(owned_dp, last, 0.0), batch_axis
            )
            return last, new_cache

        def _wrap(params, cache, tokens, start_len, prompt_len, slot):
            spec = jax.tree_util.tree_map(cspec, cache)
            fn = jax.shard_map(
                prefill_body,
                mesh=mesh,
                in_specs=(
                    param_pspecs(params, head_axis),
                    spec,
                    rep,
                    rep,
                    rep,
                    rep,
                ),
                out_specs=(rep, spec),
                check_vma=False,
            )
            return fn(params, cache, tokens, start_len, prompt_len, slot)

        return jax.jit(_wrap, donate_argnums=(1,))

    def prefill_chunk(
        self, params, cache, tokens, start_len, prompt_len, slot: int
    ):
        if self._prefill_fn is None:
            self._prefill_fn = self._build_prefill()
        return self._prefill_fn(
            params, cache, tokens, jnp.int32(start_len),
            jnp.int32(prompt_len), jnp.int32(slot),
        )

    def prefill_slot(
        self, params, cache, tokens, prompt_len, slot: int, chunk: int
    ):
        """Chunked prefill (every chunk must land in one sp shard —
        guaranteed by chunk | maxloc and 128-padded prompts)."""
        n_pad = tokens.shape[0]
        last = None
        for start in range(0, n_pad, chunk):
            piece = tokens[start : start + chunk]
            logits, cache = self.prefill_chunk(
                params, cache, piece, start, prompt_len, slot
            )
            if last is None or start < int(prompt_len):
                last = logits
        return last, cache

    # ------------------------------------------------------------------
    def _build_spec(self, cfg_d: ModelConfig, gamma: int):
        """Speculative round on the sp/tp-sharded target cache.

        The draft model is small: its params stay replicated and its
        (dense, dp-sharded) cache decodes locally on every shard — the
        redundant sp/tp-replicated draft compute is far cheaper than
        cross-shard coordination.  The target verifies all proposals in
        ONE multi-row sharded decode (``_sp_attn_with_cache`` with
        per-row shard ownership, since the verify window lands at
        arbitrary lengths and may straddle the sp boundary).  Acceptance
        is ``speculative.acceptance_rule`` — identical semantics to the
        dense engine (greedy slots emit exactly the target's greedy
        tokens).
        """
        import dataclasses

        from .decode import decode_step
        from .speculative import acceptance_rule

        cfg = self.cfg
        mesh = self.mesh
        batch_axis, seq_axis = self.batch_axis, self.seq_axis
        head_axis, tp_size = self.head_axis, self.tp_size
        cspec = functools.partial(
            cache_pspec, batch_axis=batch_axis, seq_axis=seq_axis,
            head_axis=head_axis,
        )
        # Draft cache: dense, slots over dp only (no sp/tp dims).
        dspec = functools.partial(cache_pspec, batch_axis=batch_axis)
        rep = PartitionSpec()
        dp = PartitionSpec(batch_axis)

        def spec_body(params_t, cache_t, params_d, cache_d, tok, active,
                      key, temps, top_ks, top_ps, min_ps, pen_counts,
                      presences, frequencies):
            from .decode import filter_scaled_logits

            my_dp = jax.lax.axis_index(batch_axis)
            keys = jax.random.split(jax.random.fold_in(key, my_dp), gamma + 2)
            greedy_slot = temps <= 0.0
            tau = jnp.maximum(temps, 1e-6)[:, None]
            l0_t, l0_d = cache_t.lengths, cache_d.lengths

            # --- draft: gamma dp-local proposals + one ingest step so the
            # draft cache covers its own last proposal.  Proposals come
            # from the FILTERED, penalty-adjusted draft distribution
            # (same per-slot settings as the acceptance's p/q — see
            # ``speculative.acceptance_rule``); penalties use running
            # counts over the window's earlier proposals.
            draft_toks, draft_logits = [], []
            cur = tok
            counts_run = pen_counts
            for i in range(gamma):
                logits_d, cache_d = decode_step.__wrapped__(
                    params_d, cfg_d, cache_d, cur, active
                )
                logits_d = logits_d - (
                    presences[:, None] * (counts_run > 0)
                    + frequencies[:, None] * counts_run
                )
                g = jnp.argmax(logits_d, -1).astype(jnp.int32)
                s = jax.random.categorical(
                    keys[i],
                    filter_scaled_logits(
                        logits_d / tau, top_ks, top_ps, min_ps
                    ),
                ).astype(jnp.int32)
                cur = jnp.where(greedy_slot, g, s)
                counts_run = counts_run + jax.nn.one_hot(
                    cur, counts_run.shape[-1], dtype=jnp.int32
                )
                draft_toks.append(cur)
                draft_logits.append(logits_d)
            _, cache_d = decode_step.__wrapped__(
                params_d, cfg_d, cache_d, cur, active
            )
            d = jnp.stack(draft_toks, 1)  # [B, gamma]

            # --- target verify: one multi-row sharded decode over
            # [tok, d_0..d_{gamma-1}] padded to the kernel's 8-row tiling.
            t_rows = gamma + 1
            t_pad = -(-t_rows // 8) * 8
            seq = jnp.concatenate([tok[:, None], d], axis=1)
            seq = jnp.pad(seq, ((0, 0), (0, t_pad - t_rows)))
            positions = cache_t.lengths[:, None] + jnp.arange(t_pad)[None, :]
            x = params_t["embed"][seq].astype(cfg.dtype)
            for i, layer in enumerate(params_t["layers"]):
                x, cache_t = _sp_attn_with_cache(
                    layer, x, cfg, cache_t, i, positions, seq_axis=seq_axis,
                    head_axis=head_axis, tp_size=tp_size, row_owned=True,
                )
                x = _tp_mlp(layer, x, cfg, head_axis)
            x = rms_norm(x, params_t["final_norm"])
            logits_t = (x @ params_t["lm_head"].astype(cfg.dtype)).astype(
                jnp.float32
            )[:, :t_rows]

            out, n_acc, bonus = acceptance_rule(
                d, jnp.stack(draft_logits, 1), logits_t, greedy_slot, tau,
                keys[gamma], keys[gamma + 1], top_ks, top_ps, min_ps,
                pen_counts, presences, frequencies,
            )
            n_emit = jnp.where(active, n_acc + 1, 0).astype(jnp.int32)
            cache_t = dataclasses.replace(
                cache_t, lengths=(l0_t + n_emit).astype(jnp.int32)
            )
            cache_d = dataclasses.replace(
                cache_d, lengths=(l0_d + n_emit).astype(jnp.int32)
            )
            emitted = jnp.arange(gamma + 1)[None, :] < n_emit[:, None]
            out_hot = jax.nn.one_hot(
                out, pen_counts.shape[-1], dtype=jnp.int32
            )
            pen_counts = pen_counts + jnp.sum(
                out_hot * emitted[..., None], axis=1
            )
            return out, n_emit, bonus, cache_t, cache_d, pen_counts

        def _wrap(params_t, cache_t, params_d, cache_d, tok, active, key,
                  temps, top_ks=None, top_ps=None, min_ps=None,
                  pen_counts=None, presences=None, frequencies=None):
            b = tok.shape[0]
            if top_ks is None:
                top_ks = jnp.zeros((b,), jnp.int32)
            if top_ps is None:
                top_ps = jnp.ones((b,), jnp.float32)
            if min_ps is None:
                min_ps = jnp.zeros((b,), jnp.float32)
            if pen_counts is None:
                pen_counts = jnp.zeros((b, cfg.vocab_size), jnp.int32)
            if presences is None:
                presences = jnp.zeros((b,), jnp.float32)
            if frequencies is None:
                frequencies = jnp.zeros((b,), jnp.float32)
            spec_t = jax.tree_util.tree_map(cspec, cache_t)
            spec_d = jax.tree_util.tree_map(dspec, cache_d)
            fn = jax.shard_map(
                spec_body,
                mesh=mesh,
                in_specs=(
                    param_pspecs(params_t, head_axis),
                    spec_t,
                    jax.tree_util.tree_map(lambda _: rep, params_d),
                    spec_d,
                    dp,
                    dp,
                    rep,
                    dp,
                    dp,
                    dp,
                    dp,
                    dp,
                    dp,
                    dp,
                ),
                out_specs=(dp, dp, dp, spec_t, spec_d, dp),
                check_vma=False,
            )
            return fn(params_t, cache_t, params_d, cache_d, tok, active,
                      key, temps, top_ks, top_ps, min_ps, pen_counts,
                      presences, frequencies)

        return jax.jit(_wrap, donate_argnums=(1, 3))

    def speculative_step(
        self, params_t, cache_t, params_d, cache_d, tok, active, key,
        temps, top_ks=None, top_ps=None, min_ps=None, pen_counts=None,
        presences=None, frequencies=None, *,
        cfg_d: ModelConfig, gamma: int,
    ):
        """One sharded speculative round; see ``_build_spec``."""
        built = getattr(self, "_spec_fn", None)
        if built is None or self._spec_sig != (cfg_d, gamma):
            self._spec_fn = self._build_spec(cfg_d, gamma)
            self._spec_sig = (cfg_d, gamma)
        return self._spec_fn(
            params_t, cache_t, params_d, cache_d, tok, active, key, temps,
            top_ks, top_ps, min_ps, pen_counts, presences, frequencies,
        )
