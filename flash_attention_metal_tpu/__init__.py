"""Flash-attention framework in JAX for NVIDIA GPUs.

A JAX/Pallas re-design of the capabilities of
``2thleZ/flash_attention_metal`` (see SURVEY.md): a flash-attention
forward and FA-2 backward as Triton-route Pallas kernels (with causal,
window, segments, softcap, ALiBi, dropout, 8-bit and paged KV), checks
of every kernel against a golden oracle, and — beyond the reference's
single-device scope — ring/sequence-parallel attention over device
meshes, sharded training and a continuous-batching decode runtime.
"""

from .config import AttentionConfig, BlockSizes
from .ops.attention import flash_attention, mha

__version__ = "0.1.0"

__all__ = [
    "AttentionConfig",
    "BlockSizes",
    "flash_attention",
    "mha",
    "__version__",
]
