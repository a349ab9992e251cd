"""Ring (sequence-parallel) flash attention over a device mesh.

The mechanism is exactly the reference's online-softmax block merge
(``kernels.metal:148-159,565-575``) lifted from intra-chip KV tiles to
inter-chip KV *shards*: each device holds one contiguous KV shard, KV
rotates around the ring via ``jax.lax.ppermute`` (point-to-point over
the interconnect), and each step's partial attention — computed by the full local
flash kernel, which returns its logsumexp (``kernels.metal:861-864``) —
is folded into the running (o, lse) with the identical rescale rule.

The next shard's ``ppermute`` is issued *before* the current step's
compute, so XLA's latency-hiding scheduler overlaps the transfer with the
kernel — the inter-chip version of V2's prefetch-next-while-compute-
current double buffer (``kernels.metal:531-588``).

Causal masking falls out of the kernel's traced ``q_offset``: on ring
step s, this device (index ``i``) is looking at the shard that originated
on device ``src = (i - s) mod n``; visibility of local KV column ``c``
(global ``src*n_loc + c``) to local Q row ``r`` (global ``i*n_loc + r``)
is ``c <= r + (i - src)*n_loc`` — one scalar offset per step:
* ``src < i``  -> offset >= n_loc: fully visible (mask is a no-op)
* ``src == i`` -> offset 0: standard causal
* ``src > i``  -> offset <= -n_loc: fully masked; the kernel's block skip
  prunes every tile, so the step costs ~nothing on the compute side.

These functions are meant to be called INSIDE ``jax.shard_map`` (see
``make_ring_attention`` for a canned wrapper).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec

from ..config import BlockSizes
from ..kernels._common import pack_dropout_seed
from ..kernels.flash_bwd import flash_attention_bwd
from ..kernels.flash_fwd import flash_attention_fwd
from ..ops.attention import note_end
from ..reference.oracle import attention_reference_with_lse


def merge_partials(
    o_a: jax.Array,
    lse_a: jax.Array,
    o_b: jax.Array,
    lse_b: jax.Array,
) -> Tuple[jax.Array, jax.Array]:
    """Combine two normalized attention partials via their logsumexps.

    ``o_*``: [..., N, D] fp32 normalized partial outputs;
    ``lse_*``: [..., N, 1] fp32 logsumexp (``-inf`` == empty partial).
    Returns the merged (o, lse).  This is the reference's online-softmax
    rescale (``kernels.metal:148-159``) in merge form.
    """
    m = jnp.maximum(lse_a, lse_b)
    # exp(-inf - -inf) would be NaN; clamp the pivot for empty pairs.
    m_safe = jnp.where(jnp.isneginf(m), 0.0, m)
    w_a = jnp.where(jnp.isneginf(lse_a), 0.0, jnp.exp(lse_a - m_safe))
    w_b = jnp.where(jnp.isneginf(lse_b), 0.0, jnp.exp(lse_b - m_safe))
    denom = w_a + w_b
    denom_safe = jnp.where(denom == 0.0, 1.0, denom)
    o = (o_a * w_a + o_b * w_b) / denom_safe
    lse = jnp.where(denom == 0.0, -jnp.inf, m_safe + jnp.log(denom_safe))
    return o, lse


def ring_flash_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    axis_name: str,
    axis_size: int,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    block_sizes: Optional[BlockSizes] = None,
    save_lse: bool = False,
    impl: str = "pallas",
    dropout_rate: float = 0.0,
    dropout_seed: Optional[jax.Array] = None,
    dropout_heads: Optional[int] = None,
) -> Union[jax.Array, Tuple[jax.Array, jax.Array]]:
    """Ring attention over sequence-sharded [B, H, n_local, D] shards.

    Call inside ``shard_map`` with the sequence dim sharded on
    ``axis_name``.  Requires equal Q and KV shard lengths (self-attention
    layout).  Returns the local output shard (and local LSE if requested).

    ``dropout_rate``/``dropout_seed``: in-kernel attention dropout.  Each
    ring step hashes the mask at its GLOBAL score coordinates (rows
    offset by this device's shard origin, cols by the visiting shard's
    origin), so the sharded result equals the single-device
    ``flash_attention(dropout_seed=...)`` run exactly — and the merge is
    still exact, because the per-step lse sums the *undropped* p (the
    single-device kernel's own convention: dropout applies to the
    normalized probabilities).
    """
    if dropout_rate and impl == "xla":
        raise NotImplementedError("ring dropout requires impl='pallas'")
    note_end("sequence ring", "xla" if impl == "xla" else "pallas")
    n_loc = q.shape[2]
    if k.shape[2] != n_loc:
        raise ValueError("ring attention expects equal q/kv shard lengths")
    my = jax.lax.axis_index(axis_name)
    # The caller may pre-pack dp/tp batch-head offsets into the seed
    # vector (``pack_dropout_seed``); the ring adds its own sequence-shard
    # row origin and, per step, the visiting shard's column origin.
    sv = pack_dropout_seed(dropout_seed) if dropout_rate else None

    def local_flash(q_, k_, v_, offset, src):
        if impl == "xla":
            return attention_reference_with_lse(
                q_, k_, v_, causal=causal, sm_scale=sm_scale, q_offset=offset
            )
        drop = {}
        if dropout_rate:
            drop = dict(
                dropout_rate=dropout_rate,
                dropout_seed=sv[0],
                dropout_offsets=(
                    sv[1] + my * n_loc,
                    sv[2] + src * n_loc,
                    sv[3],
                    sv[4],
                ),
                dropout_heads=dropout_heads,
            )
        return flash_attention_fwd(
            q_,
            k_,
            v_,
            offset,
            causal=causal,
            sm_scale=sm_scale,
            block_sizes=block_sizes,
            save_lse=True,
            **drop,
        )

    perm = [(i, (i + 1) % axis_size) for i in range(axis_size)]

    o_acc = jnp.zeros(q.shape, jnp.float32)
    lse_acc = jnp.full((*q.shape[:3], 1), -jnp.inf, jnp.float32)
    kb, vb = k, v
    # Statically unrolled ring: axis_size is a mesh constant, so each step
    # specializes its collective and lets XLA overlap it with compute.
    for step in range(axis_size):
        if step < axis_size - 1:
            kb_next = jax.lax.ppermute(kb, axis_name, perm)
            vb_next = jax.lax.ppermute(vb, axis_name, perm)
        else:
            kb_next = vb_next = None

        src = (my - step) % axis_size
        offset = (my - src) * n_loc  # traced; sign encodes the mask mode
        o_i, lse_i = local_flash(q, kb, vb, offset, src)
        o_acc, lse_acc = merge_partials(
            o_acc,
            lse_acc,
            o_i.astype(jnp.float32),
            lse_i[..., None].astype(jnp.float32),
        )

        if kb_next is not None:
            kb, vb = kb_next, vb_next

    o = o_acc.astype(q.dtype)
    if save_lse:
        return o, lse_acc[..., 0]
    return o


@functools.partial(
    jax.custom_vjp, nondiff_argnums=(4, 5, 6, 7, 8, 9, 10)
)
def ring_flash_attention_diff(
    q,
    k,
    v,
    dropout_seed,
    axis_name: str,
    axis_size: int,
    causal: bool,
    sm_scale: Optional[float],
    block_sizes: Optional[BlockSizes],
    dropout_rate: float = 0.0,
    dropout_heads: Optional[int] = None,
):
    """Differentiable ring attention (call inside ``shard_map``).

    Forward is ``ring_flash_attention``; backward is a *reverse ring*:
    KV shards rotate around the ring a second time together with their
    fp32 dK/dV accumulators, each device folding in the FA-2 backward
    partial for (local Q x visiting KV), and after a full cycle every
    dK/dV lands back on its home device — no all-gather, comm volume
    2x the forward ring (dK and dV ride along), overlapped with the
    backward kernels the same way the forward overlaps ``ppermute``.

    ``dropout_seed`` is a traced int32 scalar (pass 0 when
    ``dropout_rate == 0``); the forward and the reverse-ring backward
    regenerate the same mask from GLOBAL score coordinates, so training
    under ring sequence parallelism with attention dropout matches the
    single-device run exactly.
    """
    return ring_flash_attention(
        q,
        k,
        v,
        axis_name=axis_name,
        axis_size=axis_size,
        causal=causal,
        sm_scale=sm_scale,
        block_sizes=block_sizes,
        dropout_rate=dropout_rate,
        dropout_seed=dropout_seed,
        dropout_heads=dropout_heads,
    )


def _ring_diff_fwd(
    q, k, v, dropout_seed, axis_name, axis_size, causal, sm_scale,
    block_sizes, dropout_rate=0.0, dropout_heads=None,
):
    o, lse = ring_flash_attention(
        q,
        k,
        v,
        axis_name=axis_name,
        axis_size=axis_size,
        causal=causal,
        sm_scale=sm_scale,
        block_sizes=block_sizes,
        save_lse=True,
        dropout_rate=dropout_rate,
        dropout_seed=dropout_seed,
        dropout_heads=dropout_heads,
    )
    return o, (q, k, v, dropout_seed, o, lse)


def _ring_diff_bwd(
    axis_name, axis_size, causal, sm_scale, block_sizes,
    dropout_rate, dropout_heads, res, do,
):
    q, k, v, dropout_seed, o, lse = res
    n_loc = q.shape[2]
    my = jax.lax.axis_index(axis_name)
    sv = pack_dropout_seed(dropout_seed) if dropout_rate else None
    perm = [(i, (i + 1) % axis_size) for i in range(axis_size)]
    # The local LSE (already merged over the whole ring) reconstructs
    # P = exp(S - L) exactly on every ring step, so per-step partials are
    # true slices of the global gradient (``flash_bwd`` recompute trick,
    # ``kernels.metal:1081-1089``, lifted across devices).  The backward
    # kernels take GQA K/V as they are and return KV-head-sized dK/dV.
    dq_acc = jnp.zeros(q.shape, jnp.float32)
    kb, vb = k, v
    dkb = jnp.zeros(k.shape, jnp.float32)
    dvb = jnp.zeros(v.shape, jnp.float32)
    for step in range(axis_size):
        src = (my - step) % axis_size
        offset = (my - src) * n_loc
        drop = {}
        if dropout_rate:
            # Same GLOBAL mask coordinates as the forward's ring step that
            # visited this (my, src) pair, so every gradient partial sees
            # exactly the mask its forward probabilities used.
            drop = dict(
                dropout_rate=dropout_rate,
                dropout_seed=sv[0],
                dropout_offsets=(
                    sv[1] + my * n_loc,
                    sv[2] + src * n_loc,
                    sv[3],
                    sv[4],
                ),
                dropout_heads=dropout_heads,
            )
        dq_i, dk_i, dv_i = flash_attention_bwd(
            q,
            kb.astype(q.dtype),
            vb.astype(q.dtype),
            o,
            do.astype(q.dtype),
            lse,
            offset,
            sm_scale=sm_scale,
            causal=causal,
            block_sizes=block_sizes,
            **drop,
        )
        dq_acc = dq_acc + dq_i.astype(jnp.float32)
        dkb = dkb + dk_i.astype(jnp.float32)
        dvb = dvb + dv_i.astype(jnp.float32)
        # Rotate the KV shard together with its gradient accumulators;
        # after axis_size single-step rotations everything is home.  The
        # last step only needs the accumulators to travel.
        if step < axis_size - 1:
            kb = jax.lax.ppermute(kb, axis_name, perm)
            vb = jax.lax.ppermute(vb, axis_name, perm)
        dkb = jax.lax.ppermute(dkb, axis_name, perm)
        dvb = jax.lax.ppermute(dvb, axis_name, perm)

    d_seed = (
        None
        if dropout_seed is None
        else np.zeros(np.shape(dropout_seed), jax.dtypes.float0)
    )
    return (
        dq_acc.astype(q.dtype),
        dkb.astype(k.dtype),
        dvb.astype(v.dtype),
        d_seed,
    )


ring_flash_attention_diff.defvjp(_ring_diff_fwd, _ring_diff_bwd)


def make_ring_attention(
    mesh: Mesh,
    axis_name: str = "sp",
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    block_sizes: Optional[BlockSizes] = None,
    impl: str = "pallas",
    differentiable: bool = False,
    dropout_rate: float = 0.0,
):
    """shard_map-wrapped ring attention over ``mesh``'s ``axis_name``.

    Returns a function of global ``[B, H, N, D]`` arrays whose sequence
    dim is sharded over ``axis_name``; batch/head dims follow the mesh's
    remaining axes only if the caller shards them separately.  With
    ``differentiable=True`` the returned function carries the
    reverse-ring custom VJP (``ring_flash_attention_diff``).
    """
    axis_size = mesh.shape[axis_name]
    spec = PartitionSpec(None, None, axis_name, None)
    rate = float(dropout_rate)
    in_specs = (spec, spec, spec) + ((PartitionSpec(),) if rate else ())

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=spec,
        check_vma=False,
    )
    def ring(q, k, v, *seed_arg):
        seed = seed_arg[0] if rate else jnp.asarray(0, jnp.int32)
        if differentiable:
            return ring_flash_attention_diff(
                q, k, v, seed, axis_name, axis_size, causal, sm_scale,
                block_sizes, rate,
            )
        return ring_flash_attention(
            q,
            k,
            v,
            axis_name=axis_name,
            axis_size=axis_size,
            causal=causal,
            sm_scale=sm_scale,
            block_sizes=block_sizes,
            impl=impl,
            dropout_rate=rate,
            dropout_seed=seed if rate else None,
        )

    return ring
