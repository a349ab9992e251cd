"""Pallas attention kernels on the Triton route (SURVEY.md §2)."""

from .flash_fwd import flash_attention_fwd
from .flash_bwd import flash_attention_bwd
from .paged import flash_attention_paged, flash_attention_paged_quant
from .quant import (
    QuantizedKV,
    dequantize_kv,
    flash_attention_quant,
    quantize_kv,
)

__all__ = [
    "flash_attention_fwd",
    "flash_attention_bwd",
    "flash_attention_paged",
    "flash_attention_paged_quant",
    "QuantizedKV",
    "quantize_kv",
    "dequantize_kv",
    "flash_attention_quant",
]
