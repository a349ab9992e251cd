"""LoRA — low-rank adapter fine-tuning for FlashLM.

The reference is a kernel study with no training story at all
(``project_narrative.md:42-53``); this module rounds out the framework's
training side with the standard parameter-efficient fine-tuning recipe
(LoRA, Hu et al. 2021): frozen base weights plus trainable rank-``r``
factors ``W + (alpha/r) * A @ B``, so a full pretrained checkpoint (e.g.
one loaded via ``models.convert``) can be adapted while touching only
~0.1-1% of its parameters.

Design choices:

* Adapters are a plain pytree mirroring the targeted weight names, so
  every existing tool — optax, ``utils.checkpoint``, the mesh sharding
  helpers — applies unchanged.
* The merged weight ``W + s*A@B`` is materialized *inside* jit: a
  ``(d, r) @ (r, d)`` matmul is a cheap rank-r update and
  XLA fuses the add into the consumer, so the forward stays the plain
  FlashLM forward (no per-call ``x@A@B`` detour, no second code path for
  attention/decode/serving — ``merge_lora`` output drops straight into
  ``DecodeEngine``).
* Gradients are taken w.r.t. the adapters only; the base params enter
  the loss as non-differentiated constants, so AdamW state is
  adapter-sized (rank-r), not model-sized.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from .transformer import ModelConfig, Params, loss_fn


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    """Rank/scale/targets of the adapter set.

    ``targets`` names per-layer weight matrices; the default covers the
    attention projections (the standard LoRA recipe). Any 2-D layer
    weight name works, e.g. ``("wq","wk","wv","wo","w_gate","w_up",
    "w_down")`` for full-model adaptation.
    """

    rank: int = 8
    alpha: float = 16.0
    targets: Tuple[str, ...] = ("wq", "wk", "wv", "wo")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


Adapters = Dict[str, Any]


def init_lora(key: jax.Array, params: Params, lcfg: LoRAConfig) -> Adapters:
    """Zero-initialized adapters: ``A ~ N(0, 1/fan_in)``, ``B = 0``.

    ``B = 0`` makes the merged model exactly equal the base model at
    step 0 (the standard LoRA init), so fine-tuning starts from the
    pretrained function.
    """
    layers = []
    for layer in params["layers"]:
        keys = jax.random.split(key, len(lcfg.targets) + 1)
        key = keys[-1]
        ad = {}
        for name, k in zip(lcfg.targets, keys):
            if name not in layer:
                continue  # e.g. MLP targets on an MoE layer
            din, dout = layer[name].shape
            ad[name] = {
                "a": jax.random.normal(k, (din, lcfg.rank), jnp.float32)
                * (din**-0.5),
                "b": jnp.zeros((lcfg.rank, dout), jnp.float32),
            }
        layers.append(ad)
    return {"layers": layers}


def merge_lora(
    params: Params, adapters: Adapters, lcfg: LoRAConfig
) -> Params:
    """Base params with ``W + (alpha/r) * A @ B`` folded in.

    Pure function of both pytrees; safe under jit (the rank-r update is
    a cheap matmul). The result is an ordinary FlashLM param tree —
    use it for training losses, serving engines, or checkpoint export.
    """
    s = lcfg.scale
    merged_layers = []
    for layer, ad in zip(params["layers"], adapters["layers"]):
        new = dict(layer)
        for name, fac in ad.items():
            w = layer[name]
            new[name] = (w + s * (fac["a"] @ fac["b"])).astype(w.dtype)
        merged_layers.append(new)
    out = dict(params)
    out["layers"] = merged_layers
    return out


def lora_loss_fn(
    adapters: Adapters,
    params: Params,
    tokens: jax.Array,
    cfg: ModelConfig,
    lcfg: LoRAConfig,
) -> jax.Array:
    """FlashLM next-token loss as a function of the adapters only."""
    return loss_fn(merge_lora(params, adapters, lcfg), tokens, cfg)


def make_lora_train_step(
    cfg: ModelConfig,
    lcfg: LoRAConfig,
    optimizer: Optional[optax.GradientTransformation] = None,
):
    """Jitted adapter-only optimizer step.

    Returns ``(step, opt_init)`` where
    ``step(adapters, opt_state, params, tokens) -> (adapters, opt_state,
    loss)`` differentiates only the adapters; base ``params`` ride along
    as unmodified inputs (donate-able, replicable under a mesh with the
    existing ``param_shardings``).
    """
    opt = optimizer if optimizer is not None else optax.adamw(1e-3)

    @jax.jit
    def step(adapters, opt_state, params, tokens):
        loss, grads = jax.value_and_grad(lora_loss_fn)(
            adapters, params, tokens, cfg, lcfg
        )
        updates, opt_state = opt.update(grads, opt_state, adapters)
        adapters = optax.apply_updates(adapters, updates)
        return adapters, opt_state, loss

    return step, opt.init


def lora_num_params(adapters: Adapters) -> int:
    """Trainable-parameter count of the adapter set."""
    return sum(
        x.size for x in jax.tree_util.tree_leaves(adapters)
    )
