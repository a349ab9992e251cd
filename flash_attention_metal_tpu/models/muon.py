"""Muon optimizer: orthogonalized-momentum updates for matrix weights.

Muon (Jordan et al. 2024, "Muon: an optimizer for the hidden layers of
neural networks") replaces each 2-D weight's momentum update with its
nearest orthogonal matrix, approximated by a quintic Newton-Schulz
iteration — all matmuls, so the whole optimizer step runs on the
matrix units (no SVD, no host round-trip).  Non-matrix parameters (embeddings, norms, the
lm_head) keep AdamW, following the reference implementation's split.

Exposed two ways:

* :func:`scale_by_muon` — a pure optax ``GradientTransformation`` for
  the matrix partition (momentum -> Newton-Schulz -> shape-aware scale).
* :func:`make_muon_optimizer` — the production split: Muon on hidden
  2-D weights, AdamW elsewhere, via ``optax.multi_transform`` with
  labels derived from the FlashLM param tree.  Drop-in for
  ``Trainer(optimizer=...)`` and the sharded steps.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import optax

from .transformer import Params


def newton_schulz_orthogonalize(
    g: jax.Array, steps: int = 5, eps: float = 1e-7
) -> jax.Array:
    """Quintic Newton-Schulz approximation of ``UV^T`` for ``g = USV^T``.

    Coefficients (3.4445, -4.7750, 2.0315) are the published tuning that
    maximizes the slope at zero; after ~5 iterations singular values land
    in roughly [0.7, 1.2] — "orthogonal enough" for the optimizer (exact
    orthogonality is not required, per the Muon derivation).  Runs in
    bf16 matmuls like the reference implementation, fp32 in/out.
    """
    if g.ndim != 2:
        raise ValueError(f"expected a 2-D matrix, got shape {g.shape}")
    a, b, c = 3.4445, -4.7750, 2.0315
    transpose = g.shape[0] > g.shape[1]
    x = g.T if transpose else g
    x = (x / (jnp.linalg.norm(x) + eps)).astype(jnp.bfloat16)

    def body(x, _):
        gram = x @ x.T
        quad = b * gram + c * (gram @ gram)
        return a * x + quad @ x, None

    x, _ = jax.lax.scan(body, x, None, length=steps)
    x = x.astype(jnp.float32)
    return x.T if transpose else x


class MuonState(NamedTuple):
    momentum: Any


def scale_by_muon(
    momentum: float = 0.95,
    *,
    nesterov: bool = True,
    ns_steps: int = 5,
) -> optax.GradientTransformation:
    """Optax transform: momentum -> orthogonalize -> shape-aware scale.

    Every leaf must be a 2-D matrix (partition with ``multi_transform``;
    see :func:`make_muon_optimizer`).  The update is scaled by
    ``sqrt(max(1, rows/cols))`` so wide/tall matrices keep a consistent
    RMS step size (the reference implementation's rule).
    """

    def init(params):
        return MuonState(
            momentum=jax.tree_util.tree_map(jnp.zeros_like, params)
        )

    def update(updates, state, params=None):
        del params
        bufs = jax.tree_util.tree_map(
            lambda m, g: momentum * m + g, state.momentum, updates
        )
        effective = (
            jax.tree_util.tree_map(
                lambda g, m: g + momentum * m, updates, bufs
            )
            if nesterov
            else bufs
        )

        def orth(u):
            scale = max(1.0, u.shape[0] / u.shape[1]) ** 0.5
            return newton_schulz_orthogonalize(u, steps=ns_steps) * scale

        out = jax.tree_util.tree_map(orth, effective)
        return out, MuonState(momentum=bufs)

    return optax.GradientTransformation(init, update)


def muon_label_tree(params: Params) -> Params:
    """"muon" for hidden 2-D layer weights, "adamw" for everything else.

    Embedding and lm_head stay on AdamW (they are lookup/classifier
    matrices, not hidden linear maps — the Muon paper's prescription),
    as do norms (1-D) and MoE expert stacks (3-D).
    """

    def label_layer(layer):
        return {
            name: "muon"
            if (not isinstance(w, dict) and getattr(w, "ndim", 0) == 2)
            else "adamw"
            for name, w in layer.items()
        }

    out = {k: "adamw" for k in params if k != "layers"}
    out["layers"] = [label_layer(layer) for layer in params["layers"]]
    return out


def make_muon_optimizer(
    params: Params,
    *,
    muon_lr: float = 0.02,
    momentum: float = 0.95,
    adamw_lr: float = 3e-4,
    weight_decay: float = 0.01,
    grad_clip: float = 1.0,
) -> optax.GradientTransformation:
    """Muon on hidden matrices + AdamW on the rest, for a FlashLM tree."""
    labels = muon_label_tree(params)
    return optax.chain(
        optax.clip_by_global_norm(grad_clip),
        optax.multi_transform(
            {
                "muon": optax.chain(
                    scale_by_muon(momentum),
                    optax.add_decayed_weights(weight_decay),
                    optax.scale(-muon_lr),
                ),
                "adamw": optax.adamw(
                    adamw_lr, b1=0.9, b2=0.95, weight_decay=weight_decay
                ),
            },
            labels,
        ),
    )
