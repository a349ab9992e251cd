"""Configuration layer for the flash-attention framework.

The Metal reference has no config system: tile sizes are hardwired kernel
constants (reference ``kernels.metal:69-70,188-189,617-619``), the problem
shape is a global compile-time constant (``main.mm:11-13``), and runtime
parameters travel as raw ``setBytes`` scalars (``main.mm:421-432``).  Here
those become typed dataclasses: block sizes are *parameters* that Pallas
specializes on at trace time (the analog of recompiling the ``.metal``
source with different constants), and the attention call signature is a
typed Python API instead of a positional buffer ABI.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax

# Default head dim mirrors the reference's structural D=64 assumption
# (reference ``main.mm:12``, ``kernels.metal:31``), but here it is a real
# parameter: any head dim works (the kernels pad it to a power of two).
DEFAULT_HEAD_DIM = 64


def _pow2_at_least_16(name: str, v: int) -> None:
    if v < 16 or v & (v - 1):
        raise ValueError(
            f"{name}={v} must be a power of two >= 16 (Triton block shapes "
            "are powers of two, and its dot needs 16 rows and columns)"
        )


@dataclasses.dataclass(frozen=True)
class BlockSizes:
    """Triton kernel tiles (the analog of the reference's Br/Bc constants).

    The reference studied 16x16 vs 32x32 threadgroup tiles and found the
    larger tile regressed from register spill (``README.md:25-28``).  On
    Hopper the same trade holds per thread block: the fp32 accumulator
    and score tile live in registers, so tiles stay small and many
    blocks run at once.  ``None`` fields are derived from the head dim
    and sequence lengths (``resolve``).

    * ``block_q`` / ``block_k``       -- forward: query rows per program,
                                         KV rows per loop step.
    * ``block_q_bwd`` / ``block_k_bwd`` -- backward: the tile both the
                                         dK/dV and the dQ kernel use.
    """

    block_q: Optional[int] = None
    block_k: Optional[int] = None
    block_q_bwd: Optional[int] = None
    block_k_bwd: Optional[int] = None

    def __post_init__(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is not None:
                _pow2_at_least_16(f.name, v)

    def resolve(self, n_q: int, n_kv: int, head_dim: int) -> "BlockSizes":
        """Fill unset tiles: 128x64 forward, 64x64 backward (64 x 32 at
        head dim 256, where registers run out), shrunk to the next power
        of two of short sequences (never below 16)."""

        def fit(v, n):
            return max(16, min(v, 1 << max(n - 1, 1).bit_length()))

        wide = head_dim > 128
        return BlockSizes(
            block_q=self.block_q or fit(64 if wide else 128, n_q),
            block_k=self.block_k or fit(32 if wide else 64, n_kv),
            block_q_bwd=self.block_q_bwd or fit(64, n_q),
            block_k_bwd=self.block_k_bwd or fit(32 if wide else 64, n_kv),
        )


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class SegmentIds:
    """Packed-sequence segment ids for Q and KV (splash/flash convention).

    Tokens attend only within equal ids.  ``q``: [B, N_q] int32;
    ``kv``: [B, N_kv] int32.  Composes with causal/windowed masking.
    """

    q: "jax.Array"
    kv: "jax.Array"

    def tree_flatten(self):
        return (self.q, self.kv), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    """Top-level attention op configuration.

    The reference passes (N, D, scale, strides, is_causal) as Metal
    ``setBytes`` scalars (``main.mm:421-432``); here they are a typed config.
    """

    causal: bool = False
    sm_scale: Optional[float] = None  # default: 1/sqrt(head_dim)
    block_sizes: Optional[BlockSizes] = None
    # Numerics policy: inputs may be bf16/fp16; softmax statistics are always
    # fp32 (the analog of the reference's fp32 m/l registers inside the fp16
    # kernels, ``kernels.metal:633-638``).
    save_lse: bool = False


def default_scale(head_dim: int) -> float:
    return float(1.0 / (head_dim**0.5))
