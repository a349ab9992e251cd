"""Mixture-of-Experts FlashLM with expert parallelism (ep).

The reference has no MoE (SURVEY.md §2 parallelism table: EP "N/A");
this module adds the fifth parallelism family, in the GShard/Switch
dense-dispatch style that turns routing into matrix products:

* **router**: fp32 top-k softmax gating per token, gates renormalized
  over the kept k; Switch-style load-balance auxiliary loss
  ``E * Σ_e f_e · p_e``.
* **dispatch**: capacity-bucketed one-hot dispatch/combine tensors
  ``[T, E, C]`` built with cumsum ranks — everything is a dense einsum
  (no scatter/gather, no dynamic shapes), which XLA hands to its
  matrix-product kernels.  Tokens past capacity are dropped from the MLP
  and ride the residual stream (standard Switch semantics).
* **expert parallelism**: experts shard over the ``ep`` mesh axis; the
  dispatched ``[E, C, d]`` blocks move with ONE tiled ``all_to_all``
  each way (device ↔ expert transpose between devices), the canonical MoE
  collective.  ``ep`` doubles as a data axis for the non-expert layers
  (tokens shard over ``dp × ep``), so no activation is replicated.
* **composition**: the mesh is ``('dp', 'ep', 'tp', 'sp')`` — the
  attention block is the Megatron tp layout from ``parallel_train``,
  expert FFN weights are additionally tp-sharded along the hidden
  width (column/row with one psum), and the CE is the shared
  vocab/sequence-sharded helper.

Single-device semantics (``moe_forward``) and the sharded step are the
same function — the all_to_all degenerates to identity at ep=1 — so the
ep tests assert sharded == oracle to fp tolerance at full capacity.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from .parallel_train import _tp_attention, vocab_sharded_ce
from .transformer import ModelConfig, Params, rms_norm

AXES = ("dp", "ep", "tp", "sp")


@dataclasses.dataclass(frozen=True)
class MoEConfig(ModelConfig):
    n_experts: int = 8
    top_k: int = 2
    # capacity per expert = ceil(top_k * T / E * capacity_factor),
    # rounded up to a multiple of 8.
    capacity_factor: float = 1.25
    # Switch load-balance aux loss weight.
    aux_loss_weight: float = 1e-2


def init_moe_params(key: jax.Array, cfg: MoEConfig) -> Params:
    """fp32 master params: dense attention + expert-stacked SwiGLU MLP."""
    keys = jax.random.split(key, cfg.n_layers + 2)

    def dense(k, fan_in, shape):
        return jax.random.normal(k, shape, jnp.float32) * (fan_in**-0.5)

    d, h, hk, hd, f, e = (
        cfg.d_model,
        cfg.n_heads,
        cfg.n_kv_heads,
        cfg.head_dim,
        cfg.d_ff,
        cfg.n_experts,
    )
    layers = []
    for i in range(cfg.n_layers):
        lk = jax.random.split(keys[i], 9)
        layers.append(
            {
                "attn_norm": jnp.ones((d,), jnp.float32),
                "wq": dense(lk[0], d, (d, h * hd)),
                "wk": dense(lk[1], d, (d, hk * hd)),
                "wv": dense(lk[2], d, (d, hk * hd)),
                "wo": dense(lk[3], h * hd, (h * hd, d)),
                "mlp_norm": jnp.ones((d,), jnp.float32),
                "w_router": dense(lk[4], d, (d, e)),
                "w_gate": dense(lk[5], d, (e, d, f)),
                "w_up": dense(lk[6], d, (e, d, f)),
                "w_down": dense(lk[7], f, (e, f, d)),
            }
        )
    return {
        "embed": jax.random.normal(keys[-2], (cfg.vocab_size, d), jnp.float32)
        * 0.02,
        "layers": layers,
        "final_norm": jnp.ones((d,), jnp.float32),
        "lm_head": dense(keys[-1], d, (d, cfg.vocab_size)),
    }


def moe_param_specs(cfg: MoEConfig) -> Params:
    """Megatron tp attention + ep-sharded, tp-width-sharded experts."""
    layer = {
        "attn_norm": P(),
        "wq": P(None, "tp"),
        "wk": P(None, "tp"),
        "wv": P(None, "tp"),
        "wo": P("tp", None),
        "mlp_norm": P(),
        "w_router": P(),
        "w_gate": P("ep", None, "tp"),
        "w_up": P("ep", None, "tp"),
        "w_down": P("ep", "tp", None),
    }
    return {
        "embed": P(),
        "layers": [dict(layer) for _ in range(cfg.n_layers)],
        "final_norm": P(),
        "lm_head": P(None, "tp"),
    }


def _replicated_axes(spec: P) -> Tuple[str, ...]:
    used = {
        a
        for part in spec
        for a in ((part,) if isinstance(part, str) else (part or ()))
    }
    return tuple(a for a in AXES if a not in used)


def _capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = -(-cfg.top_k * n_tokens * cfg.capacity_factor // cfg.n_experts)
    return int(-(-c // 8) * 8)


def topk_dispatch(probs: jax.Array, k: int, capacity: int):
    """Dense GShard dispatch from router probabilities.

    ``probs``: fp32 ``[T, E]``.  Returns ``(dispatch, combine, aux)``
    with ``dispatch`` one-hot ``[T, E, C]``, ``combine`` the gate-
    weighted version, and ``aux`` the Switch load-balance loss.  Slots
    are assigned in priority order (all rank-0 choices first), each
    expert fills at most ``capacity`` slots; overflow tokens get an
    all-zero row in both tensors.
    """
    t, e = probs.shape
    gate_vals, idx = jax.lax.top_k(probs, k)  # [T, k]
    gate_vals = gate_vals / jnp.maximum(
        jnp.sum(gate_vals, axis=-1, keepdims=True), 1e-9
    )

    dispatch = jnp.zeros((t, e, capacity), probs.dtype)
    combine = jnp.zeros((t, e, capacity), probs.dtype)
    counts = jnp.zeros((e,), jnp.int32)
    for s in range(k):  # k is 1-2: unrolled at trace time
        oh = jax.nn.one_hot(idx[:, s], e, dtype=jnp.int32)  # [T, E]
        rank = counts[None, :] + jnp.cumsum(oh, axis=0) - oh
        counts = counts + jnp.sum(oh, axis=0)
        keep = (rank < capacity) & (oh > 0)
        slot = jax.nn.one_hot(
            jnp.clip(rank, 0, capacity - 1), capacity, dtype=probs.dtype
        ) * keep[..., None].astype(probs.dtype)  # [T, E, C]
        dispatch = dispatch + slot
        combine = combine + slot * gate_vals[:, s][:, None, None]

    # Switch aux-loss statistics, returned as raw SUMS so the caller can
    # psum them over the data axes before forming the (quadratic)
    # f_e * p_e product — that makes the aux loss invariant to how the
    # token batch is sharded (a per-shard mean-of-products would differ
    # between mesh shapes).
    f_sum = jnp.sum(jax.nn.one_hot(idx[:, 0], e, dtype=probs.dtype), axis=0)
    p_sum = jnp.sum(probs, axis=0)
    return dispatch, combine, (f_sum, p_sum, jnp.float32(t))


def moe_mlp_dense(layer, x, cfg: MoEConfig) -> jax.Array:
    """Drop-free routed MoE MLP — the serving / teacher-forcing path.

    Exact top-k routing with NO capacity buckets: every expert runs over
    the full token set and the combine weight zeroes the unrouted pairs,
    so no token ever drops and decode matches the teacher-forced forward
    token-for-token.  Costs ``E×`` the dense-MLP FLOPs with no ``[T,E,C]``
    dispatch tensor — the right trade at decode batch sizes (attention +
    cache traffic dominate) and in oracles; training uses the
    capacity-bucketed ``_moe_mlp`` instead.  Equal to ``_moe_mlp`` at
    non-dropping capacity (same renormalized gates).
    """
    dt = cfg.dtype
    shape = x.shape
    h = rms_norm(x, layer["mlp_norm"]).reshape(-1, shape[-1])

    logits = h.astype(jnp.float32) @ layer["w_router"]
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, idx = jax.lax.top_k(probs, cfg.top_k)
    gate_vals = gate_vals / jnp.maximum(
        jnp.sum(gate_vals, axis=-1, keepdims=True), 1e-9
    )
    w = jnp.zeros_like(probs)
    for s in range(cfg.top_k):
        w = w + jax.nn.one_hot(idx[:, s], cfg.n_experts) * gate_vals[:, s:s + 1]

    gate = jax.nn.silu(jnp.einsum("td,edf->etf", h, layer["w_gate"].astype(dt)))
    up = jnp.einsum("td,edf->etf", h, layer["w_up"].astype(dt))
    y = jnp.einsum("etf,efd->etd", gate * up, layer["w_down"].astype(dt))
    out = jnp.einsum("etd,te->td", y, w.astype(dt))
    return x + out.reshape(shape)


def _moe_mlp(layer, x, cfg: MoEConfig, ep_size: int, tp_size: int):
    """Expert-parallel SwiGLU MoE block (runs inside shard_map).

    ``x``: local ``[B_loc, n_loc, d]``.  At ep_size=1 the all_to_alls
    are identities and this is the single-device oracle semantics.
    """
    dt = cfg.dtype
    b_loc, n_loc, d = x.shape
    t = b_loc * n_loc
    h = rms_norm(x, layer["mlp_norm"]).reshape(t, d)

    # fp32 router for stability; gates cast back to the compute dtype.
    logits = h.astype(jnp.float32) @ layer["w_router"]
    probs = jax.nn.softmax(logits, axis=-1)
    cap = _capacity(t, cfg)
    dispatch, combine, aux_stats = topk_dispatch(probs, cfg.top_k, cap)

    # [T, E, C] x [T, d] -> [E, C, d]: dense dispatch as one matmul.
    xe = jnp.einsum("tec,td->ecd", dispatch.astype(dt), h)

    if ep_size > 1:
        # Device <-> expert transpose: each shard keeps E/ep experts and
        # receives their capacity rows from every peer.
        xe = jax.lax.all_to_all(
            xe, "ep", split_axis=0, concat_axis=1, tiled=True
        )  # [E/ep, ep*C, d]

    gate = jax.nn.silu(jnp.einsum("ecd,edf->ecf", xe, layer["w_gate"].astype(dt)))
    up = jnp.einsum("ecd,edf->ecf", xe, layer["w_up"].astype(dt))
    ye = jnp.einsum("ecf,efd->ecd", gate * up, layer["w_down"].astype(dt))
    if tp_size > 1:
        ye = jax.lax.psum(ye, "tp")

    if ep_size > 1:
        ye = jax.lax.all_to_all(
            ye, "ep", split_axis=1, concat_axis=0, tiled=True
        )  # back to [E, C, d]

    out = jnp.einsum("ecd,tec->td", ye, combine.astype(dt))
    return x + out.reshape(b_loc, n_loc, d), aux_stats


def _moe_loss(
    params,
    tokens,
    cfg: MoEConfig,
    ep_size: int,
    tp_size: int,
    sp_size: int,
    sp_attn: str,
):
    """Per-shard MoE forward + CE + load-balance aux (inside shard_map)."""
    sp_idx = jax.lax.axis_index("sp")
    n_loc = tokens.shape[1]
    positions = sp_idx * n_loc + jnp.broadcast_to(
        jnp.arange(n_loc), tokens.shape
    )

    x = params["embed"][tokens].astype(cfg.dtype)

    def block(x, layer):
        x = _tp_attention(layer, x, cfg, positions, tp_size, sp_size, sp_attn)
        return _moe_mlp(layer, x, cfg, ep_size, tp_size)

    data_axes = ("dp", "ep", "sp")
    aux_total = 0.0
    for layer in params["layers"]:
        x, (f_sum, p_sum, t_loc) = jax.checkpoint(block)(x, layer)
        # Global Switch aux from psum'd raw counts: invariant to the
        # data sharding (a per-shard f_e*p_e mean would not be).
        t_g = jax.lax.psum(t_loc, data_axes)
        f_e = jax.lax.psum(f_sum, data_axes) / t_g
        p_e = jax.lax.psum(p_sum, data_axes) / t_g
        aux_total = aux_total + cfg.n_experts * jnp.sum(f_e * p_e)
    x = rms_norm(x, params["final_norm"])
    logits = (x @ params["lm_head"].astype(cfg.dtype)).astype(jnp.float32)

    ce = vocab_sharded_ce(logits, tokens, sp_size, reduce_axes=data_axes)
    return ce + cfg.aux_loss_weight * aux_total


def make_moe_train_step(
    mesh: Mesh,
    cfg: MoEConfig,
    lr: float = 1e-2,
    sp_attn: str = "allgather",
):
    """jit(shard_map(...)) SGD step over a ``(dp, ep, tp, sp)`` mesh.

    ``tokens`` is global ``[B, N]`` with ``B % (dp * ep) == 0`` — the
    ``ep`` axis carries data for the non-expert layers, so no activation
    is ever replicated.  Returns ``step(params, tokens) -> (params, loss)``.
    """
    ep_size = mesh.shape["ep"]
    tp_size = mesh.shape["tp"]
    sp_size = mesh.shape["sp"]
    if cfg.n_experts % ep_size:
        raise ValueError(
            f"n_experts={cfg.n_experts} not divisible by ep={ep_size}"
        )
    p_specs = moe_param_specs(cfg)
    data_spec = P(("dp", "ep"), "sp")

    def step(params, tokens):
        loss, grads = jax.value_and_grad(
            lambda p: _moe_loss(
                p, tokens, cfg, ep_size, tp_size, sp_size, sp_attn
            )
        )(params)
        grads = jax.tree_util.tree_map(
            lambda g, s: jax.lax.psum(g, _replicated_axes(s))
            if _replicated_axes(s)
            else g,
            grads,
            p_specs,
            is_leaf=lambda x: isinstance(x, P),
        )
        params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
        return params, loss

    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(p_specs, data_spec),
        out_specs=(p_specs, P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def make_moe_optax_step(
    mesh: Mesh,
    cfg: MoEConfig,
    optimizer,
    sp_attn: str = "allgather",
):
    """Sharded optax step over the (dp, ep, tp, sp) MoE mesh.

    Optimizer state shards like the params (expert moments live with
    their experts on the ep axis); returns
    ``step(params, opt_state, tokens) -> (params, opt_state, loss)``.
    """
    from .parallel_train import _opt_state_specs_from

    ep_size = mesh.shape["ep"]
    tp_size = mesh.shape["tp"]
    sp_size = mesh.shape["sp"]
    if cfg.n_experts % ep_size:
        raise ValueError(
            f"n_experts={cfg.n_experts} not divisible by ep={ep_size}"
        )
    p_specs = moe_param_specs(cfg)
    data_spec = P(("dp", "ep"), "sp")
    example = jax.eval_shape(
        lambda: init_moe_params(jax.random.PRNGKey(0), cfg)
    )
    o_specs = _opt_state_specs_from(optimizer, example, p_specs)

    def step(params, opt_state, tokens):
        loss, grads = jax.value_and_grad(
            lambda p: _moe_loss(
                p, tokens, cfg, ep_size, tp_size, sp_size, sp_attn
            )
        )(params)
        grads = jax.tree_util.tree_map(
            lambda g, s: jax.lax.psum(g, _replicated_axes(s))
            if _replicated_axes(s)
            else g,
            grads,
            p_specs,
            is_leaf=lambda x: isinstance(x, P),
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


def moe_opt_state_specs(optimizer, params: Params, cfg: MoEConfig):
    """PartitionSpecs for ``optimizer.init(moe_params)``."""
    from .parallel_train import _opt_state_specs_from

    return _opt_state_specs_from(optimizer, params, moe_param_specs(cfg))


def moe_forward(params, tokens, cfg: MoEConfig):
    """Single-device MoE forward to logits — the ep oracle.

    Same math as the sharded path at ep=tp=sp=1 (all collectives are
    identities), so sharded-vs-oracle tests compare against this.
    """
    import numpy as np

    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1, 1, 1), AXES)

    def fwd(params, tokens):
        positions = jnp.broadcast_to(
            jnp.arange(tokens.shape[1]), tokens.shape
        )
        x = params["embed"][tokens].astype(cfg.dtype)
        for layer in params["layers"]:
            x = _tp_attention(layer, x, cfg, positions, 1, 1, "allgather")
            x, _ = _moe_mlp(layer, x, cfg, 1, 1)
        x = rms_norm(x, params["final_norm"])
        return (x @ params["lm_head"].astype(cfg.dtype)).astype(jnp.float32)

    return jax.jit(
        jax.shard_map(
            fwd,
            mesh=mesh,
            in_specs=(
                jax.tree_util.tree_map(
                    lambda _: P(),
                    moe_param_specs(cfg),
                    is_leaf=lambda x: isinstance(x, P),
                ),
                P(),
            ),
            out_specs=P(),
            check_vma=False,
        )
    )(params, tokens)
