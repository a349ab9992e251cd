"""Pipeline-parallel (pp) FlashLM training, composed with dp / tp / sp.

The reference has no multi-device parallelism at all (SURVEY.md §2
parallelism table; pipeline parallel explicitly absent).  This module
adds the fourth mesh axis: a GPipe-style microbatch
pipeline expressed as ONE ``lax.scan`` over schedule ticks inside ONE
``shard_map`` over a ``('dp', 'pp', 'tp', 'sp')`` mesh —

* **layer placement**: the layer stack is stacked ``[n_layers, ...]``
  and sharded over ``pp`` (``n_layers/pp`` resident per stage); each
  stage runs its local layers with an inner ``lax.scan`` (rematerialized
  via ``jax.checkpoint``).
* **schedule**: ``T = n_micro + pp - 1`` ticks.  Every tick each stage
  processes its in-flight microbatch and hands the activation to the
  next stage with a ``ppermute`` — the device ring carries exactly one
  ``[mb, n_loc/sp, d]`` tensor per tick per stage boundary.  Stage 0
  injects microbatch ``t``; the last stage banks its result at tick
  ``t >= pp-1``.  Bubble ticks compute on garbage and are masked out —
  branchless SPMD, no ``lax.cond`` (compiler-friendly, same reasoning
  as the kernels' unconditional masked ops).
* **backward**: plain ``jax.grad`` through the scan + ppermute.  XLA's
  transpose of ``ppermute`` is the reversed ring and the transpose of
  the schedule scan is the reverse schedule, so autodiff *derives* the
  1F1B-shaped backward pipeline instead of hand-scheduling it.
* **loss**: every stage computes the vocab-sharded cross entropy
  SPMD-uniformly, but only the LAST stage's activations are real, so
  per-shard NLL is masked by ``pp_idx == pp-1`` and the scalar psum
  runs over ``('dp', 'pp', 'sp')``.  That keeps the replica-sum rule
  uniform: every param's gradient is psum'd over exactly the mesh axes
  its PartitionSpec does not use (embed grads live on stage 0, head
  grads on the last stage, layer grads on their own stage).

Within a stage the block body is the Megatron tp attention/mlp and the
sequence-parallel attention from ``parallel_train`` — pp composes with
all three existing axes in one jit.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from .parallel_train import (
    _tp_attention,
    _tp_mlp,
    param_specs,
    vocab_sharded_ce,
)
from .transformer import ModelConfig, Params, rms_norm

AXES = ("dp", "pp", "tp", "sp")


def stack_layer_params(params: Params) -> Params:
    """Convert ``layers: [dict]*L`` into ``layers: dict of [L, ...]``.

    The stacked form is what shards over the ``pp`` axis (leading layer
    dim) and what the per-stage ``lax.scan`` consumes.
    """
    layers = params["layers"]
    stacked = {
        name: jnp.stack([layer[name] for layer in layers])
        for name in layers[0]
    }
    out = dict(params)
    out["layers"] = stacked
    return out


def unstack_layer_params(params: Params) -> Params:
    """Inverse of :func:`stack_layer_params` (for checkpoint interop)."""
    stacked = params["layers"]
    n = next(iter(stacked.values())).shape[0]
    out = dict(params)
    out["layers"] = [
        {name: stacked[name][i] for name in stacked} for i in range(n)
    ]
    return out


def pp_param_specs(cfg: ModelConfig) -> Params:
    """PartitionSpecs for stacked params: layer leaves gain a leading
    ``pp`` dim on top of the Megatron tp layout."""
    base = param_specs(cfg)
    specs = dict(base)
    specs["layers"] = {
        name: P("pp", *spec) for name, spec in base["layers"][0].items()
    }
    return specs


def _replicated_axes(spec: P) -> Tuple[str, ...]:
    used = {
        a
        for part in spec
        for a in ((part,) if isinstance(part, str) else (part or ()))
    }
    return tuple(a for a in AXES if a not in used)


def _pp_loss(
    params,
    tokens,
    cfg: ModelConfig,
    pp_size: int,
    tp_size: int,
    sp_size: int,
    n_micro: int,
    sp_attn: str,
):
    """Per-shard pipelined forward + masked vocab-sharded CE.

    Runs INSIDE shard_map; ``tokens`` is the ``[B_loc, n_loc]`` local
    shard, ``params['layers']`` the ``[L/pp, ...]`` local stage stack.
    """
    pp_idx = jax.lax.axis_index("pp")
    sp_idx = jax.lax.axis_index("sp")
    b_loc, n_loc = tokens.shape
    if b_loc % n_micro:
        raise ValueError(
            f"local batch {b_loc} not divisible by n_micro={n_micro}"
        )
    mb = b_loc // n_micro

    tokens_mb = tokens.reshape(n_micro, mb, n_loc)
    positions = sp_idx * n_loc + jnp.broadcast_to(
        jnp.arange(n_loc), (mb, n_loc)
    )

    # Embedding for every microbatch up front (cheap gather; only stage
    # 0's copy flows into the pipeline, so only stage 0 gets embed grads).
    x_mb = params["embed"][tokens_mb].astype(cfg.dtype)

    def layer_body(x, layer):
        x = _tp_attention(layer, x, cfg, positions, tp_size, sp_size, sp_attn)
        return _tp_mlp(layer, x, cfg), None

    layer_body = jax.checkpoint(layer_body)

    def stage_fn(x):
        x, _ = jax.lax.scan(layer_body, x, params["layers"])
        return x

    n_ticks = n_micro + pp_size - 1
    zero_act = jnp.zeros_like(x_mb[0])

    def tick(carry, t):
        act, banked = carry
        # Stage 0 injects microbatch t (clipped index; extra reads are
        # masked by the bank-side guard).
        inject = jax.lax.dynamic_index_in_dim(
            x_mb, jnp.clip(t, 0, n_micro - 1), 0, keepdims=False
        )
        act = jnp.where(pp_idx == 0, inject, act)
        out = stage_fn(act)
        # Last stage banks its finished microbatch.
        out_idx = t - (pp_size - 1)
        cidx = jnp.clip(out_idx, 0, n_micro - 1)
        write = (pp_idx == pp_size - 1) & (out_idx >= 0)
        prev = jax.lax.dynamic_index_in_dim(banked, cidx, 0, keepdims=False)
        banked = jax.lax.dynamic_update_index_in_dim(
            banked, jnp.where(write, out, prev), cidx, 0
        )
        # Hand off to the next stage (stage 0 receives zeros, replaced
        # by the next inject; the last stage's send is dropped).
        act = jax.lax.ppermute(
            out, "pp", [(i, i + 1) for i in range(pp_size - 1)]
        )
        return (act, banked), None

    (_, banked), _ = jax.lax.scan(
        tick, (zero_act, jnp.zeros_like(x_mb)), jnp.arange(n_ticks)
    )

    # --- CE on the banked activations: real only on the last stage ---
    x = banked.reshape(b_loc, n_loc, -1)
    x = rms_norm(x, params["final_norm"])
    logits = (x @ params["lm_head"].astype(cfg.dtype)).astype(jnp.float32)

    # Only the last stage's NLL is real — weight by the stage mask and
    # psum over pp too, which makes the per-spec replica-sum rule exact
    # for every param.
    is_last = (pp_idx == pp_size - 1).astype(jnp.float32)
    return vocab_sharded_ce(
        logits,
        tokens,
        sp_size,
        reduce_axes=("dp", "pp", "sp"),
        nll_weight=is_last,
    )


def make_pp_train_step(
    mesh: Mesh,
    cfg: ModelConfig,
    n_micro: int,
    lr: float = 1e-2,
    sp_attn: str = "allgather",
):
    """jit(shard_map(...)) SGD step over a ``(dp, pp, tp, sp)`` mesh.

    Returns ``step(stacked_params, tokens) -> (stacked_params, loss)``
    where ``stacked_params = stack_layer_params(init_params(...))`` and
    ``tokens`` is global ``[B, N]`` (``B % (dp * n_micro) == 0``,
    ``N % sp == 0``).  ``n_micro`` microbatches flow through the
    ``pp``-stage pipeline per step; the pipeline bubble fraction is
    ``(pp - 1) / (n_micro + pp - 1)``, so pick ``n_micro >= 4 * pp`` in
    production (any ``n_micro >= 1`` is correct).
    """
    pp_size = mesh.shape["pp"]
    tp_size = mesh.shape["tp"]
    sp_size = mesh.shape["sp"]
    if cfg.n_layers % pp_size:
        raise ValueError(
            f"n_layers={cfg.n_layers} not divisible by pp={pp_size}"
        )
    p_specs = pp_param_specs(cfg)
    data_spec = P("dp", "sp")

    def step(params, tokens):
        loss, grads = jax.value_and_grad(
            lambda p: _pp_loss(
                p, tokens, cfg, pp_size, tp_size, sp_size, n_micro, sp_attn
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


def make_pp_optax_step(
    mesh: Mesh,
    cfg: ModelConfig,
    optimizer,
    n_micro: int,
    sp_attn: str = "allgather",
):
    """Sharded optax step over the 4-axis pipeline mesh.

    Same contract as ``make_pp_train_step`` but applying an optax
    optimizer (state sharded like the stacked params via
    ``pp_opt_state_specs``); returns
    ``step(params, opt_state, tokens) -> (params, opt_state, loss)``.
    """
    from .parallel_train import _opt_state_specs_from
    from .transformer import init_params

    pp_size = mesh.shape["pp"]
    tp_size = mesh.shape["tp"]
    sp_size = mesh.shape["sp"]
    if cfg.n_layers % pp_size:
        raise ValueError(
            f"n_layers={cfg.n_layers} not divisible by pp={pp_size}"
        )
    p_specs = pp_param_specs(cfg)
    data_spec = P("dp", "sp")
    example = jax.eval_shape(
        lambda: stack_layer_params(init_params(jax.random.PRNGKey(0), cfg))
    )
    o_specs = _opt_state_specs_from(optimizer, example, p_specs)

    def step(params, opt_state, tokens):
        loss, grads = jax.value_and_grad(
            lambda p: _pp_loss(
                p, tokens, cfg, pp_size, tp_size, sp_size, n_micro, sp_attn
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


def pp_opt_state_specs(optimizer, params: Params, cfg: ModelConfig):
    """PartitionSpecs for ``optimizer.init(stacked_params)``."""
    from .parallel_train import _opt_state_specs_from

    return _opt_state_specs_from(optimizer, params, pp_param_specs(cfg))
