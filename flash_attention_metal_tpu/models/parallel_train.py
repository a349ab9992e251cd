"""Manually-sharded (dp x tp x sp) training step for FlashLM.

The reference has no distribution at all (SURVEY.md §2 parallelism table);
this module is the scaling story end-to-end: one ``shard_map``
over a 3-axis mesh, with every collective explicit —

* **dp** (data):      batch sharded; gradient ``psum`` at the end.
* **tp** (tensor):    attention heads + FFN width sharded column/row-wise
                      (Megatron layout): wq/wk/wv/w_gate/w_up column-
                      sharded (no comms in), wo/w_down row-sharded
                      (one ``psum`` out).  GQA keeps each KV head
                      co-located with its Q-head group (boom guide §14).
* **sp** (sequence):  activations sharded along the sequence; attention
                      runs the context-parallel all-gather path
                      (``parallel/context.py`` — differentiable, the
                      gather transposes to reduce-scatter in the
                      backward); the next-token shift fetches the
                      neighbor's first token with a ``ppermute``; the
                      vocab-sharded cross entropy does a pmax/psum
                      logsumexp.

Everything is jit-compiled once over the mesh; the driver exercises it on
a virtual CPU mesh (``__graft_entry__.dryrun_multichip``) and the same
code lays onto a real pod slice unchanged.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..kernels._common import pack_dropout_seed
from ..parallel.context import allgather_attention
from ..parallel.ring import ring_flash_attention_diff
from .transformer import (
    ModelConfig,
    Params,
    _merge_heads,
    _split_heads,
    init_params,
    rms_norm,
    rope,
)

AXES = ("dp", "tp", "sp")


def param_specs(cfg: ModelConfig) -> Params:
    """PartitionSpec tree matching the Megatron TP layout."""
    layer = {
        "attn_norm": P(),
        "wq": P(None, "tp"),
        "wk": P(None, "tp"),
        "wv": P(None, "tp"),
        "wo": P("tp", None),
        "mlp_norm": P(),
        "w_gate": P(None, "tp"),
        "w_up": P(None, "tp"),
        "w_down": P("tp", None),
    }
    return {
        "embed": P(),
        "layers": [dict(layer) for _ in range(cfg.n_layers)],
        "final_norm": P(),
        "lm_head": P(None, "tp"),
    }


def _replicated_axes(spec: P) -> Tuple[str, ...]:
    """Mesh axes a param with this spec is replicated over (grad-psum set)."""
    used = {a for part in spec for a in ((part,) if isinstance(part, str) else (part or ()))}
    return tuple(a for a in AXES if a not in used)


def _tp_attention(
    layer, x, cfg, positions, tp_size, sp_size, sp_attn, dropout_seed=None
):
    dt = cfg.dtype
    h_local = cfg.n_heads // tp_size
    hk_local = max(cfg.n_kv_heads // tp_size, 1)
    if cfg.n_kv_heads % tp_size and tp_size % cfg.n_kv_heads:
        raise ValueError("tp size must divide n_kv_heads or vice versa")
    h = rms_norm(x, layer["attn_norm"])
    q = _split_heads(h @ layer["wq"].astype(dt), h_local, cfg.head_dim)
    k = _split_heads(h @ layer["wk"].astype(dt), hk_local, cfg.head_dim)
    v = _split_heads(h @ layer["wv"].astype(dt), hk_local, cfg.head_dim)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    rate = cfg.attn_dropout if dropout_seed is not None else 0.0
    if rate:
        # Attention dropout at GLOBAL (b, h, row, col) mask coordinates:
        # dp/tp shard origins pre-packed here, sequence-shard row/col
        # origins added inside ring/allgather — so ANY dp x tp x sp
        # factorization reproduces the single-device mask bit-for-bit
        # (sharding-invariant dropout; see kernels._common.dropout_keep).
        seedvec = pack_dropout_seed(
            dropout_seed,
            (
                0,
                0,
                jax.lax.axis_index("dp") * x.shape[0],
                jax.lax.axis_index("tp") * h_local,
            ),
        )
    else:
        seedvec = jnp.zeros((5,), jnp.int32)
    if sp_attn == "ring":
        # Sequence-parallel attention via the reverse-ring custom VJP:
        # KV (and dK/dV in the backward) rotate between devices instead
        # of an all-gather -- peak memory O(n_local) instead of O(n_global).
        o = ring_flash_attention_diff(
            q, k, v, seedvec, "sp", sp_size, True, None, cfg.block_sizes,
            rate, cfg.n_heads if rate else None,
        )
    else:
        # All-gather KV over sp, per-shard causal offset handled inside.
        o = allgather_attention(
            q,
            k,
            v,
            axis_name="sp",
            causal=True,
            block_sizes=cfg.block_sizes,
            impl=cfg.attn_impl,
            dropout_rate=rate,
            dropout_seed=seedvec if rate else None,
            dropout_heads=cfg.n_heads if rate else None,
        )
    out_partial = _merge_heads(o) @ layer["wo"].astype(dt)
    out = jax.lax.psum(out_partial, "tp")
    return x + out


def _tp_mlp(layer, x, cfg):
    dt = cfg.dtype
    h = rms_norm(x, layer["mlp_norm"])
    gate = jax.nn.silu(h @ layer["w_gate"].astype(dt))
    up = h @ layer["w_up"].astype(dt)
    down_partial = (gate * up) @ layer["w_down"].astype(dt)
    return x + jax.lax.psum(down_partial, "tp")


def vocab_sharded_ce(
    logits,
    tokens,
    sp_size: int,
    reduce_axes: Tuple[str, ...] = ("dp", "sp"),
    nll_weight=None,
):
    """Vocab-sharded (tp) + sequence-sharded (sp) next-token CE.

    ``logits`` is the local ``[B_loc, n_loc, V/tp]`` shard; targets are
    the left-shifted tokens with the sp-boundary token fetched from the
    right neighbor via ``ppermute``.  The logsumexp runs as a pmax/psum
    over tp.  ``reduce_axes`` are the data-replica axes the scalar is
    psum'd over; ``nll_weight`` (optional per-shard scalar, e.g. a
    pipeline last-stage mask) multiplies both the NLL and the token
    count so masked shards drop out of the mean entirely.
    """
    sp_idx = jax.lax.axis_index("sp")
    n_loc = tokens.shape[1]

    # --- next-token targets across the sp boundary ---
    first_tok = tokens[:, :1]
    left_perm = [(i, (i - 1) % sp_size) for i in range(sp_size)]
    recv_first = jax.lax.ppermute(first_tok, "sp", left_perm)
    targets = jnp.concatenate([tokens[:, 1:], recv_first], axis=1)
    # The global final position has no target.
    pos_global = sp_idx * n_loc + jnp.broadcast_to(
        jnp.arange(n_loc), tokens.shape
    )
    valid = pos_global < (sp_size * n_loc - 1)

    # --- vocab-sharded cross entropy (pmax/psum logsumexp) ---
    tp_idx = jax.lax.axis_index("tp")
    v_local = logits.shape[-1]
    # The logsumexp pivot is gradient-invariant, so stop_gradient around the
    # (non-differentiable) pmax is mathematically exact.
    m_local = jax.lax.stop_gradient(jnp.max(logits, axis=-1))
    m = jax.lax.stop_gradient(jax.lax.pmax(m_local, "tp"))
    sumexp = jnp.sum(jnp.exp(logits - m[..., None]), axis=-1)
    lse = jnp.log(jax.lax.psum(sumexp, "tp")) + m

    local_idx = targets - tp_idx * v_local
    in_shard = (local_idx >= 0) & (local_idx < v_local)
    gathered = jnp.take_along_axis(
        logits, jnp.clip(local_idx, 0, v_local - 1)[..., None], axis=-1
    )[..., 0]
    target_logit = jax.lax.psum(jnp.where(in_shard, gathered, 0.0), "tp")

    nll = jnp.where(valid, lse - target_logit, 0.0)
    valid_f = valid.astype(jnp.float32)
    if nll_weight is not None:
        nll = nll * nll_weight
        valid_f = valid_f * nll_weight
    total = jax.lax.psum(jnp.sum(nll), reduce_axes)
    count = jax.lax.psum(jnp.sum(valid_f), reduce_axes)
    return total / count


def _sharded_loss(
    params, tokens, cfg: ModelConfig, tp_size: int, sp_size: int,
    sp_attn: str, dropout_key=None,
):
    """Per-shard forward + vocab/sequence-sharded cross entropy.

    ``dropout_key``: optional replicated PRNG key enabling
    ``cfg.attn_dropout``.  Per-layer seeds are derived exactly like the
    single-device ``transformer.forward_hidden`` and the masks hash at
    global coordinates, so the sharded loss with dropout equals the
    single-device loss for the same key on any mesh factorization.
    """
    sp_idx = jax.lax.axis_index("sp")
    n_loc = tokens.shape[1]
    positions = sp_idx * n_loc + jnp.broadcast_to(
        jnp.arange(n_loc), tokens.shape
    )

    x = params["embed"][tokens].astype(cfg.dtype)

    seeds = None
    if dropout_key is not None and cfg.attn_dropout > 0.0:
        # Replicated key -> identical per-layer seeds on every shard
        # (mirrors transformer.forward_hidden's derivation exactly).
        seeds = jax.random.randint(
            dropout_key, (cfg.n_layers,), 0, jnp.iinfo(jnp.int32).max,
            dtype=jnp.int32,
        )

    def block(x, layer, seed):
        x = _tp_attention(
            layer, x, cfg, positions, tp_size, sp_size, sp_attn,
            dropout_seed=seed,
        )
        return _tp_mlp(layer, x, cfg)

    block = jax.checkpoint(block)
    for i, layer in enumerate(params["layers"]):
        x = block(x, layer, None if seeds is None else seeds[i])
    x = rms_norm(x, params["final_norm"])
    logits = (x @ params["lm_head"].astype(cfg.dtype)).astype(jnp.float32)
    # logits: [B_loc, n_loc, V/tp]
    return vocab_sharded_ce(logits, tokens, sp_size)


def make_train_step(
    mesh: Mesh, cfg: ModelConfig, lr: float = 1e-2,
    sp_attn: str = "allgather", dropout: bool = False,
):
    """jit(shard_map(...)) SGD training step over a (dp, tp, sp) mesh.

    Returns ``step(params, tokens) -> (params, loss)`` where ``tokens`` is
    a global ``[B, N]`` int array (B % dp == 0, N % sp == 0) and params
    follow ``param_specs``.

    With ``dropout=True`` (requires ``cfg.attn_dropout > 0``) the step
    takes ``(params, tokens, dropout_key)`` — the key is replicated and
    the attention-dropout masks hash at global coordinates, so the loss
    is invariant to the mesh factorization and equals the single-device
    ``transformer.loss_fn`` run.
    """
    tp_size = mesh.shape["tp"]
    sp_size = mesh.shape["sp"]
    p_specs = param_specs(cfg)
    data_spec = P("dp", "sp")

    def step(params, tokens, *key):
        grads, loss = _sharded_grads(
            params, tokens, cfg, tp_size, sp_size, sp_attn, p_specs,
            dropout_key=key[0] if dropout else None,
        )
        params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
        return params, loss

    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(p_specs, data_spec) + ((P(),) if dropout else ()),
        out_specs=(p_specs, P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def _sharded_grads(
    params, tokens, cfg, tp_size, sp_size, sp_attn, p_specs,
    dropout_key=None,
):
    """Per-shard grads with the replica sums applied; runs IN shard_map."""
    loss, grads = jax.value_and_grad(
        lambda p: _sharded_loss(
            p, tokens, cfg, tp_size, sp_size, sp_attn, dropout_key
        )
    )(params)
    # Gradients for replicated params must be summed over the axes the
    # param does not use; sharded params already received their full
    # gradient through the loss's dp/sp psum (value_and_grad of a
    # psum-reduced scalar yields per-shard grads that still need the
    # dp/sp replica sum for replicated leaves).
    grads = jax.tree_util.tree_map(
        lambda g, s: jax.lax.psum(g, _replicated_axes(s))
        if _replicated_axes(s)
        else g,
        grads,
        p_specs,
        is_leaf=lambda x: isinstance(x, P),
    )
    return grads, loss


def make_optax_train_step(
    mesh: Mesh,
    cfg: ModelConfig,
    optimizer,
    sp_attn: str = "allgather",
):
    """Sharded optax training step (e.g. AdamW) over a (dp, tp, sp) mesh.

    The optimizer state is sharded exactly like the params it mirrors
    (optax state trees are param-shaped per leaf, plus replicated
    scalars like the step count).  Returns
    ``step(params, opt_state, tokens) -> (params, opt_state, loss)``;
    build the initial state with ``optimizer.init(params)`` and place it
    with ``opt_state_specs(optimizer, params, cfg)``.
    """
    tp_size = mesh.shape["tp"]
    sp_size = mesh.shape["sp"]
    p_specs = param_specs(cfg)
    data_spec = P("dp", "sp")
    example = jax.eval_shape(
        lambda: init_params(jax.random.PRNGKey(0), cfg)
    )
    o_specs = _opt_state_specs_from(optimizer, example, p_specs)

    def step(params, opt_state, tokens):
        grads, loss = _sharded_grads(
            params, tokens, cfg, tp_size, sp_size, sp_attn, p_specs
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        return params, opt_state, loss

    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(p_specs, o_specs, data_spec),
        out_specs=(p_specs, o_specs, P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def _opt_state_specs_from(optimizer, example_params, p_specs):
    """PartitionSpecs for an optax state: param-shaped leaves inherit the
    param's spec; everything else (counts, scalars) is replicated."""
    state_shape = jax.eval_shape(optimizer.init, example_params)
    params_treedef = jax.tree_util.tree_structure(example_params)

    def spec_for(subtree):
        # A state leaf-tree that matches the params' structure gets the
        # params' specs; anything else is replicated.
        if jax.tree_util.tree_structure(subtree) == params_treedef:
            return p_specs
        return jax.tree_util.tree_map(lambda _: P(), subtree)

    return jax.tree_util.tree_map(
        spec_for,
        state_shape,
        is_leaf=lambda t: t is not state_shape
        and jax.tree_util.tree_structure(t) == params_treedef,
    )


def opt_state_specs(optimizer, params, cfg: ModelConfig):
    """Public helper: PartitionSpecs for ``optimizer.init(params)``."""
    return _opt_state_specs_from(optimizer, params, param_specs(cfg))
