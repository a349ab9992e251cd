"""Utilities: roofline accounting, timing, checkpoints, data."""

from .roofline import (
    attention_bytes,
    attention_flops,
    chip_spec,
    roofline_fraction,
    roofline_time,
)
from .timing import measure

__all__ = [
    "attention_bytes",
    "attention_flops",
    "chip_spec",
    "roofline_fraction",
    "roofline_time",
    "measure",
]
