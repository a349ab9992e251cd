"""Device-mesh construction helpers.

The reference is strictly single-device (one Metal GPU with unified memory
as its only "interconnect", ``main.mm:104-115``); everything in this
package is the multi-device scaling layer the reference scoped out
(``project_narrative.md:50-53``): ``jax.sharding.Mesh`` over the cards,
named axes for data (dp), heads/tensor (tp), and sequence (sp)
parallelism, with XLA collectives (`ppermute`, `all_gather`, `psum`,
`all_to_all`) as the communication backend.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

AXIS_DATA = "dp"
AXIS_TENSOR = "tp"
AXIS_SEQUENCE = "sp"


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = (AXIS_DATA, AXIS_TENSOR, AXIS_SEQUENCE),
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a mesh over the available devices.

    Default: all devices on a 1-D ``sp`` ring if no shape given, otherwise
    the requested (dp, tp, sp) grid.  Axis sizes of 1 are legal, so a
    single chip still builds a valid 3-axis mesh — code written against
    the named axes runs unchanged from 1 chip to a pod.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (n,)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, axis_names=tuple(axis_names))


def attention_shardings(
    mesh: Mesh,
    *,
    data_axis: Optional[str] = AXIS_DATA,
    head_axis: Optional[str] = AXIS_TENSOR,
    seq_axis: Optional[str] = None,
) -> Tuple[NamedSharding, NamedSharding, NamedSharding]:
    """(q, k, v) NamedShardings for ``[B, H, N, D]`` tensors.

    Batch on ``data_axis``, heads on ``head_axis``, and (optionally, for
    sequence/context parallelism) the KV sequence on ``seq_axis``.
    """
    q_spec = PartitionSpec(data_axis, head_axis, seq_axis, None)
    kv_spec = PartitionSpec(data_axis, head_axis, seq_axis, None)
    return (
        NamedSharding(mesh, q_spec),
        NamedSharding(mesh, kv_spec),
        NamedSharding(mesh, kv_spec),
    )
