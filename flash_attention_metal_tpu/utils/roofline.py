"""Roofline model for attention kernels on the GPU.

The reference only reports *relative* speedup vs its naive kernel
(``main.mm:862-865``); a roofline share needs the card's peak rates and
the attention FLOP/byte model, both kept here.

Peaks are NVIDIA's published data-sheet numbers (dense, without
sparsity), keyed by the ``device_kind`` JAX reports.  They assume the
card's full power limit; ``nvidia-smi --query-gpu=power.limit`` says
whether it has one.  A device that is not in the table is an error, not
a default.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    # Dense tensor-core peak for bf16/fp16 operands, FLOP/s.
    peak_bf16_flops: float
    # fp32 peak outside the tensor cores, FLOP/s.
    peak_fp32_flops: float
    # Device memory bandwidth, bytes/s, and capacity, bytes.
    hbm_bw: float
    hbm_bytes: float


# NVIDIA H100 data sheet (SXM part): 989 TFLOP/s dense bf16, 67 TFLOP/s
# fp32, 3.35 TB/s and 80 GB of HBM3.
CHIP_SPECS = {
    "NVIDIA H100 80GB HBM3": ChipSpec(
        "H100 SXM", 989e12, 67e12, 3.35e12, 80e9
    ),
}


def chip_spec(device_kind: Optional[str] = None) -> ChipSpec:
    """Peak table entry for ``device_kind`` (default: the first device)."""
    if device_kind is None:
        device_kind = jax.devices()[0].device_kind
    try:
        return CHIP_SPECS[device_kind]
    except KeyError:
        raise KeyError(
            f"no peak rates for device kind {device_kind!r}; add its data "
            f"sheet values to utils/roofline.py CHIP_SPECS"
        ) from None


def attention_flops(
    batch: int,
    heads: int,
    n_q: int,
    n_kv: int,
    head_dim: int,
    *,
    causal: bool = False,
    backward: bool = False,
) -> float:
    """Model FLOP count for one attention call.

    Forward: 2 matmuls (QK^T and PV), 2*N_q*N_kv*D MACs each -> 4*N_q*N_kv*D
    FLOPs per (batch, head).  Causal halves the score area.  Backward does
    5 block matmuls (S recompute, dV, dP, dQ, dK) ~= 2.5x the forward FLOPs.
    """
    f = 4.0 * batch * heads * n_q * n_kv * head_dim
    if causal:
        f *= 0.5
    if backward:
        f *= 2.5
    return f


def attention_bytes(
    batch: int,
    heads: int,
    n_q: int,
    n_kv: int,
    head_dim: int,
    itemsize: int,
) -> float:
    """Minimal HBM traffic: read Q, K, V once; write O once."""
    return float(
        batch * heads * (2 * n_q + 2 * n_kv) * head_dim * itemsize
    )


def roofline_time(
    flops: float,
    bytes_moved: float,
    spec: Optional[ChipSpec] = None,
    dtype_bits: int = 16,
) -> float:
    """Least seconds the card could take: the larger of compute and
    memory time."""
    if spec is None:
        spec = chip_spec()
    peak = spec.peak_bf16_flops if dtype_bits <= 16 else spec.peak_fp32_flops
    return max(flops / peak, bytes_moved / spec.hbm_bw)


def roofline_fraction(
    measured_s: float,
    flops: float,
    bytes_moved: float,
    spec: Optional[ChipSpec] = None,
    dtype_bits: int = 16,
) -> float:
    """Fraction of speed-of-light achieved (1.0 == at the roofline)."""
    ideal = roofline_time(flops, bytes_moved, spec, dtype_bits)
    return ideal / measured_s if measured_s > 0 else 0.0
