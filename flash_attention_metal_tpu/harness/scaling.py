"""Sequence-parallel scaling benchmark (tokens/s, 1 -> N shards).

BASELINE.json's north star asks for >=85% tokens/s scaling efficiency
from 1 host to N hosts on the ring/sequence-parallel decode path.  This
harness measures attention throughput for a fixed *global* problem at
increasing sequence-shard counts over whatever devices exist:

* on several GPUs it reports scaling efficiency over their interconnect;
* on a virtual CPU mesh it is a functional smoke of the same code path
  (numbers are not efficiency claims there — the "interconnect" is host
  memory).

Run: ``python -m flash_attention_metal_tpu.harness.scaling``
"""

from __future__ import annotations

import json
from typing import List, Optional

import jax
import jax.numpy as jnp

from ..parallel import make_mesh, make_ring_attention
from ..reference import make_qkv
from ..utils.timing import measure_compiled


def run_scaling(
    n_global: int = 8192,
    heads: int = 8,
    head_dim: int = 64,
    shard_counts: Optional[List[int]] = None,
    *,
    causal: bool = True,
    log=print,
) -> List[dict]:
    n_dev = len(jax.devices())
    if shard_counts is None:
        shard_counts = [c for c in (1, 2, 4, 8, 16) if c <= n_dev]

    on_gpu = jax.default_backend() == "gpu"
    iters = 10
    if not on_gpu:
        # CPU virtual mesh runs the kernels in interpreter mode: shrink
        # the problem so this stays a functional smoke, not an hour-long
        # interpreted crawl.
        n_global = min(n_global, 1024)
        iters = 2

    q, k, v = make_qkv(
        jax.random.PRNGKey(0), (1, heads, n_global, head_dim), dtype=jnp.bfloat16
    )
    results = []
    base_tps = None
    for c in shard_counts:
        mesh = make_mesh((1, 1, c), devices=jax.devices()[:c])
        ring = make_ring_attention(mesh, "sp", causal=causal)
        r = measure_compiled(ring, (q, k, v), iters=iters)
        tokens_per_s = n_global / r["median_s"]
        if base_tps is None:
            base_tps = tokens_per_s
        eff = tokens_per_s / (base_tps * c)
        row = {
            "shards": c,
            "ms": r["median_s"] * 1e3,
            "tokens_per_s": tokens_per_s,
            "scaling_efficiency": eff,
        }
        results.append(row)
        log(
            f"sp={c}: {row['ms']:.3f} ms, {tokens_per_s:,.0f} tok/s, "
            f"efficiency {eff:.0%}"
        )
    return results


def main() -> int:
    print(f"devices: {len(jax.devices())} x {jax.devices()[0].device_kind}")
    rows = run_scaling()
    backend = jax.default_backend()
    meaningful = backend == "gpu" and len(jax.devices()) > 1
    payload = {
        "backend": backend,
        "devices": len(jax.devices()),
        # Scaling efficiency is only meaningful across real cards.  A virtual
        # CPU mesh shares one socket's memory bandwidth across all
        # "devices", so its efficiency numbers measure host contention,
        # not the framework — mark them so nobody reads them as results.
        "meaningful": meaningful,
        "note": (
            "functional smoke on a virtual single-host mesh; "
            "efficiency numbers are NOT meaningful"
            if not meaningful
            else "measured across GPUs"
        ),
        "rows": rows,
    }
    with open("scaling_results.json", "w") as f:
        json.dump(payload, f, indent=2)
    print("wrote scaling_results.json")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
