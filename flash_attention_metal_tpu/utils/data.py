"""Training data pipeline: memmapped token shards -> prefetched device batches.

The reference generates fixtures in-process (``main.mm:24-30``) and has
no data path at all; a training framework needs one.  Design:

* **storage**: flat binary token shards (`.bin`, little-endian uint16 or
  uint32) + a tiny JSON header — ``np.memmap`` gives zero-copy,
  page-cached reads with no deserialization on the hot path.
* **batching**: the corpus is cut into fixed ``seq_len + 1`` windows
  (static shapes — XLA never recompiles); window order is a
  deterministic per-epoch permutation from a seeded PRNG, so runs are
  reproducible and resumable from ``(epoch, step)`` alone — the loader
  itself is stateless, which is what makes checkpoint/resume exact.
* **host sharding**: each host reads only the windows of its
  data-parallel slice (``host_id / num_hosts``); no coordination, no
  duplicate IO.
* **prefetch**: ``prefetch_to_device`` keeps N batches in flight with
  async ``device_put`` (optionally against a ``NamedSharding``), hiding
  host IO and dispatch behind device compute — the data
  path's analog of the kernels' double-buffered DMA.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Iterator, Optional, Sequence, Tuple

import jax
import numpy as np

_MAGIC = "fam_tokens_v1"


def write_token_shard(path: str, tokens: np.ndarray) -> None:
    """Write a 1-D token array as a memmappable shard (+ JSON header)."""
    tokens = np.ascontiguousarray(tokens)
    if tokens.ndim != 1:
        raise ValueError(f"tokens must be 1-D, got shape {tokens.shape}")
    if tokens.min() < 0:
        raise ValueError("tokens must be non-negative")
    dtype = np.uint16 if tokens.max() < 2**16 else np.uint32
    tokens.astype(dtype).tofile(path)
    with open(path + ".json", "w") as f:
        json.dump(
            {
                "magic": _MAGIC,
                "dtype": np.dtype(dtype).name,
                "n_tokens": int(tokens.size),
            },
            f,
        )


class TokenDataset:
    """Memmapped view over one or more token shards.

    ``windows(seq_len)`` exposes the corpus as fixed-size overlapping-
    free ``seq_len + 1`` windows (input/target pairs share the +1).
    """

    def __init__(self, paths: Sequence[str]):
        if isinstance(paths, (str, os.PathLike)):
            paths = [paths]
        self._maps = []
        for p in paths:
            with open(str(p) + ".json") as f:
                hdr = json.load(f)
            if hdr.get("magic") != _MAGIC:
                raise ValueError(f"{p}: not a {_MAGIC} shard")
            self._maps.append(
                np.memmap(p, dtype=np.dtype(hdr["dtype"]), mode="r")
            )
        self._sizes = [m.size for m in self._maps]

    @property
    def n_tokens(self) -> int:
        return int(sum(self._sizes))

    def n_windows(self, seq_len: int) -> int:
        # Windows never straddle shard boundaries (keeps reads contiguous).
        return sum(s // (seq_len + 1) for s in self._sizes)

    def window(self, idx: int, seq_len: int) -> np.ndarray:
        w = seq_len + 1
        for m, s in zip(self._maps, self._sizes):
            n = s // w
            if idx < n:
                return np.asarray(m[idx * w : (idx + 1) * w])
            idx -= n
        raise IndexError(idx)


def batch_iterator(
    dataset: TokenDataset,
    batch_size: int,
    seq_len: int,
    *,
    seed: int = 0,
    start_epoch: int = 0,
    start_step: int = 0,
    host_id: int = 0,
    num_hosts: int = 1,
    epochs: Optional[int] = None,
) -> Iterator[Tuple[np.ndarray, Tuple[int, int]]]:
    """Deterministic shuffled ``[batch, seq_len + 1]`` batches.

    Yields ``(tokens, (epoch, step))``; restarting with
    ``start_epoch/start_step`` from a checkpoint reproduces the stream
    exactly (the permutation is a pure function of ``seed`` + epoch).
    Each host sees a disjoint interleaved slice of every epoch.
    """
    n = dataset.n_windows(seq_len)
    per_host = n // num_hosts
    steps_per_epoch = per_host // batch_size
    if steps_per_epoch == 0:
        raise ValueError(
            f"{n} windows / {num_hosts} hosts < batch_size={batch_size}"
        )
    epoch = start_epoch
    while epochs is None or epoch < epochs:
        perm = np.random.default_rng((seed, epoch)).permutation(n)
        local = perm[host_id::num_hosts]
        first = start_step if epoch == start_epoch else 0
        for step in range(first, steps_per_epoch):
            idx = local[step * batch_size : (step + 1) * batch_size]
            out = np.stack([dataset.window(i, seq_len) for i in idx])
            yield out.astype(np.int32), (epoch, step)
        epoch += 1


def prefetch_to_device(
    it: Iterator,
    size: int = 2,
    sharding: Optional[jax.sharding.Sharding] = None,
):
    """Keep ``size`` batches in flight on the device.

    ``device_put`` is async under jit-style dispatch; pulling the next
    host batch and enqueueing its transfer before the consumer needs it
    hides IO + PCIe latency behind compute (double-buffered DMA,
    host edition).  Non-array leaves (e.g. the (epoch, step) tag) pass
    through untouched.
    """

    def put(x):
        return jax.tree_util.tree_map(
            lambda a: jax.device_put(a, sharding)
            if isinstance(a, np.ndarray)
            else a,
            x,
        )

    queue = collections.deque()
    for item in it:
        queue.append(put(item))
        if len(queue) >= size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
