"""Continuous-batching decode engine (BASELINE.json config 5 runtime).

Host-side scheduler over the jitted prefill/decode steps: a fixed pool of
batch slots, a FIFO admission queue, and per-step retirement of finished
sequences.  The device programs never change shape — admission and
retirement only flip the ``active`` mask and per-slot lengths — so the
whole serving loop runs on exactly two compiled executables (prefill,
decode) regardless of traffic.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from typing import Tuple

from ..models.transformer import ModelConfig, Params
from .decode import (
    admit_update,
    decode_and_sample,
    decode_and_sample_multi,
    prefill_slot,
)
from .kv_cache import (
    init_cache,
    init_quant_cache,
    init_rolling_cache,
    init_rolling_quant_cache,
    reset_slot,
)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 64
    temperature: float = 0.0
    top_k: int = 0  # <= 0: disabled
    top_p: float = 1.0  # >= 1: disabled
    # OpenAI-style repetition control over GENERATED tokens (prompt
    # tokens are not counted): logits -= presence*(count>0) + freq*count.
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    min_p: float = 0.0  # <= 0: disabled (post-temperature min-p filter)
    # Stop sequences: finish (and truncate) when the generation ends
    # with any of these token lists.  Host-side check at harvest (the
    # device never needs them), so multi-token stops are exact.
    stop: List[List[int]] = dataclasses.field(default_factory=list)
    # Filled by the engine:
    generated: List[int] = dataclasses.field(default_factory=list)
    # Log-probability of each generated token under the model's raw
    # softmax (empty on the speculative path).
    logprobs: List[float] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False


def _pad_to(x: List[int], multiple: int) -> np.ndarray:
    n = len(x)
    pad = (-n) % multiple
    return np.asarray(x + [0] * pad, np.int32)


def _prefix_chain_keys(prompt: List[int], page_size: int) -> List[str]:
    """Chained content keys for each full prompt page.

    Key i digests ALL tokens up to the end of page i (not just the
    page's own): a page's KV depends on its entire prefix, so equal
    keys <=> bit-identical KV through the same jitted prefill.
    """
    h = hashlib.sha256()
    keys = []
    for i in range(len(prompt) // page_size):
        h.update(
            np.asarray(
                prompt[i * page_size : (i + 1) * page_size], np.int64
            ).tobytes()
        )
        keys.append(h.hexdigest())
    return keys


class DecodeEngine:
    """Continuous batching over a fixed slot pool.

    Usage::

        eng = DecodeEngine(params, cfg, max_batch=8, max_len=2048, eos_id=2)
        eng.submit(Request(uid=1, prompt=[...]))
        while eng.pending():
            finished = eng.step()
    """

    def __init__(
        self,
        params: Params,
        cfg: ModelConfig,
        *,
        max_batch: int,
        max_len: int,
        eos_id: int = -1,
        seed: int = 0,
        harvest_lag: int = 16,
        multi_step: int = 1,
        draft: Optional[Tuple[Params, ModelConfig]] = None,
        spec_gamma: int = 4,
        kv_quant: Optional[str] = None,
        rolling: bool = False,
        paged: bool = False,
        page_size: int = 128,
        n_pages: Optional[int] = None,
        prefix_share: bool = False,
        mesh: Optional[Mesh] = None,
        batch_axis: str = "dp",
        seq_axis: Optional[str] = None,
        head_axis: Optional[str] = None,
    ):
        self.params = params
        self.cfg = cfg
        self.eos_id = eos_id
        self.max_len = max_len
        # Multi-token dispatch: scan ``multi_step`` decode+sample steps
        # per device program, amortizing the per-dispatch host cost.
        # Trades admission granularity (and up to multi_step-1 discarded
        # overshoot tokens per retirement) for per-token latency.
        if multi_step < 1:
            raise ValueError(f"multi_step={multi_step} must be >= 1")
        self._multi_step = multi_step
        # Speculative serving: a (params, cfg) draft model proposes
        # spec_gamma tokens per round; the target verifies them in one
        # chunked decode (runtime/speculative.py).  Greedy requests
        # receive exactly the target-only greedy tokens.
        self._draft = draft
        self._spec_gamma = spec_gamma
        # Tokens a retired slot may still decode before bookkeeping lands
        # (harvest runs ``harvest_lag`` dispatches behind; each dispatch
        # emits up to multi_step / gamma+1 tokens — and a speculative
        # VERIFY WINDOW writes up to the 8-row-padded gamma+1 rows past
        # the true length, which is also how far the paged host-length
        # tracker may run ahead between harvest resyncs).
        spec_pad = -(-(spec_gamma + 1) // 8) * 8 if draft else 0
        window = max(multi_step, spec_pad if draft else 1)
        self._zombie_margin = harvest_lag * window + window
        if draft is not None:
            if multi_step > 1 or rolling:
                raise ValueError(
                    "draft= (speculative serving) composes with the dense, "
                    "quantized, and paged caches (dp/sp/tp mesh sharding "
                    "included); rolling caches have no sound O(1) rollback "
                    "(wrapped slots are overwritten) and multi_step is the "
                    "same dispatch-amortization axis"
                )
            if paged and prefix_share:
                raise NotImplementedError(
                    "draft= with prefix_share=True is not wired (a verify "
                    "window may not overwrite an adopted shared page)"
                )
        self._spec_pad = spec_pad
        # Sequence-sharded serving (BASELINE config 5): the KV cache's
        # length dim splits over ``seq_axis`` and decode runs the
        # lse-combine path (runtime.sp_decode).  Composes with dp slot
        # sharding on the same mesh.
        self._sp_size = (
            mesh.shape[seq_axis]
            if (mesh is not None and seq_axis is not None)
            else 1
        )
        self._seq_axis = seq_axis if self._sp_size > 1 else None
        # Tensor-parallel serving: KV heads + Megatron weight shards over
        # ``head_axis`` (runtime.sp_decode handles both axes together).
        self._tp_size = (
            mesh.shape[head_axis]
            if (mesh is not None and head_axis is not None)
            else 1
        )
        self._head_axis = head_axis if self._tp_size > 1 else None
        if self._seq_axis is not None or self._head_axis is not None:
            if rolling:
                raise ValueError(
                    "rolling caches are dp-only (no contiguous shard "
                    "ownership under a wrapped position map)"
                )
        if self._head_axis is not None and cfg.n_kv_heads % self._tp_size:
            raise ValueError(
                f"n_kv_heads={cfg.n_kv_heads} must divide over "
                f"{head_axis}={self._tp_size}"
            )
        if self._seq_axis is not None:
            maxloc = max_len // self._sp_size
            if max_len % self._sp_size or maxloc % 128:
                raise ValueError(
                    f"max_len={max_len} must split into 128-aligned "
                    f"shards over {seq_axis}={self._sp_size}"
                )
        self._paged = paged
        self._allocator = None
        self._host_len = [0] * max_batch
        if paged:
            # vLLM-style paged pool (ROADMAP item 7): slots share a page
            # pool instead of each reserving max_len contiguous tokens.
            # Admission is gated by worst-case page reservation, so the
            # pool can be sized to real traffic (sum of per-request
            # prompt+max_new footprints) rather than max_batch * max_len.
            if rolling:
                raise ValueError(
                    "paged=True does not compose with rolling (a wrapped "
                    "position map has no stable page ownership)"
                )
            if mesh is not None:
                raise ValueError(
                    "paged=True is single-device (a shared physical pool "
                    "has no batch dim to shard)"
                )
            from .paged_kv import (
                PageAllocator,
                init_paged_cache,
                init_paged_quant_cache,
            )

            if n_pages is None:
                # Default: no oversubscription (full dense equivalent)
                # plus the reserved placeholder page 0.
                n_pages = max_batch * (max_len // page_size) + 1
            if kv_quant:
                # 8-bit paged pool (BASELINE config 5: 8-bit KV x
                # continuous batching x paging).
                qdt = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}[kv_quant]
                self.cache = init_paged_quant_cache(
                    cfg.n_layers,
                    max_batch,
                    cfg.n_kv_heads,
                    max_len,
                    cfg.head_dim,
                    n_pages=n_pages,
                    page_size=page_size,
                    dtype=qdt,
                )
            else:
                self.cache = init_paged_cache(
                    cfg.n_layers,
                    max_batch,
                    cfg.n_kv_heads,
                    max_len,
                    cfg.head_dim,
                    n_pages=n_pages,
                    page_size=page_size,
                    dtype=cfg.dtype,
                )
            self._allocator = PageAllocator(n_pages, max_batch)
            self._prefill_chunk = None
        elif rolling:
            # O(window) rolling cache for sliding-window models.
            if cfg.attn_window is None:
                raise ValueError("rolling=True requires cfg.attn_window")
            cap = -(-(cfg.attn_window + cfg.attn_sinks) // 128) * 128 + 128
            # Rolling prefill must go in chunks of <= capacity - window
            # so every chunk row's window is still resident when computed.
            self._prefill_chunk = 128
            if kv_quant:
                qdt = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}[kv_quant]
                self.cache = init_rolling_quant_cache(
                    cfg.n_layers,
                    max_batch,
                    cfg.n_kv_heads,
                    cap,
                    cfg.head_dim,
                    dtype=qdt,
                    sinks=cfg.attn_sinks,
                )
            else:
                self.cache = init_rolling_cache(
                    cfg.n_layers,
                    max_batch,
                    cfg.n_kv_heads,
                    cap,
                    cfg.head_dim,
                    dtype=cfg.dtype,
                    sinks=cfg.attn_sinks,
                )
        elif kv_quant:
            # 8-bit KV cache (BASELINE config 5): "int8", or "fp8" (e4m3).
            qdt = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}[kv_quant]
            self.cache = init_quant_cache(
                cfg.n_layers,
                max_batch,
                cfg.n_kv_heads,
                max_len,
                cfg.head_dim,
                dtype=qdt,
            )
        else:
            self.cache = init_cache(
                cfg.n_layers,
                max_batch,
                cfg.n_kv_heads,
                max_len,
                cfg.head_dim,
                dtype=cfg.dtype,
            )
        if not rolling:
            self._prefill_chunk = None
        self.draft_cache = None
        if draft is not None:
            self.draft_cache = init_cache(
                draft[1].n_layers,
                max_batch,
                draft[1].n_kv_heads,
                max_len,
                draft[1].head_dim,
                dtype=draft[1].dtype,
            )
        if prefix_share and not paged:
            raise ValueError("prefix_share=True requires paged=True")
        self._prefix_share = prefix_share
        # Retained prefix registry: chain-key -> physical page, LRU
        # ordered.  Entries hold a pin on their page so shared prompt
        # prefixes survive slot turnover; evicted under pool pressure.
        self._prefix_registry: OrderedDict[str, int] = OrderedDict()
        self.slots: List[Optional[Request]] = [None] * max_batch
        # Device-resident per-slot state: the decode chain never
        # round-trips tokens through the host.
        self.next_token = jnp.zeros((max_batch,), jnp.int32)
        self.temps = jnp.zeros((max_batch,), jnp.float32)
        self.top_ks = jnp.zeros((max_batch,), jnp.int32)
        self.top_ps = jnp.ones((max_batch,), jnp.float32)
        self.presences = jnp.zeros((max_batch,), jnp.float32)
        self.frequencies = jnp.zeros((max_batch,), jnp.float32)
        self.min_ps = jnp.zeros((max_batch,), jnp.float32)
        # Per-slot generated-token counts for the presence/frequency
        # penalties; updated device-side inside the fused step.
        self.pen_counts = jnp.zeros(
            (max_batch, cfg.vocab_size), jnp.int32
        )
        self.queue: deque[Request] = deque()
        self.key = jax.random.PRNGKey(seed)
        # Pre-split key block: one 65-way ``jax.random.split`` per 64
        # consumptions instead of a synchronous split per step.
        self._key_block = None
        self._key_idx = 0
        self.steps = 0
        # Throughput accounting (host wall clock around step()).
        self._t_started = None
        self._step_seconds = 0.0
        self._tokens_emitted = 0
        self.finished: Dict[int, Request] = {}
        # Fetch-behind pipeline: device->host token transfers are issued
        # asynchronously and bookkeeping runs ``harvest_lag`` steps behind
        # the decode chain, so the fetch latency overlaps subsequent
        # decode steps instead of serializing the loop.  Retirement/admission lag by <= harvest_lag steps;
        # tokens decoded for an already-retired occupant are discarded.
        self.harvest_lag = max(harvest_lag, 0)
        self._inflight: deque = deque()  # (toks_dev, [uid or None per slot])
        self._active_dev = jnp.zeros((max_batch,), bool)
        self._occupancy_dirty = True
        # Multi-device serving: shard the slot pool over the mesh's batch
        # axis (params replicated); jit partitions decode_and_sample SPMD
        # across devices -- each device serves max_batch/dp slots.  The
        # host scheduler is unchanged.
        self._mesh = mesh
        self._sp = None
        if mesh is not None:
            if max_batch % mesh.shape[batch_axis]:
                raise ValueError(
                    f"max_batch={max_batch} must divide over "
                    f"{batch_axis}={mesh.shape[batch_axis]}"
                )
            repl = NamedSharding(mesh, PartitionSpec())
            seq = self._seq_axis
            head = self._head_axis

            def shard_for(leaf):
                # Batch is dim 0 for rank-1/2 leaves (lengths/positions/
                # tokens), dim 1 for [n_layers, B, ...] cache leaves; the
                # length dim additionally splits over sp and the KV-head
                # dim over tp when enabled.
                if leaf.ndim <= 2:
                    return NamedSharding(mesh, PartitionSpec(batch_axis))
                if seq is not None or head is not None:
                    from .sp_decode import cache_pspec

                    return NamedSharding(
                        mesh, cache_pspec(leaf, batch_axis, seq, head)
                    )
                return NamedSharding(
                    mesh, PartitionSpec(None, batch_axis)
                )

            if self._head_axis is not None:
                from .sp_decode import param_pspecs

                pspecs = param_pspecs(self.params, self._head_axis)
                self.params = jax.device_put(
                    self.params,
                    jax.tree_util.tree_map(
                        lambda sp_: NamedSharding(mesh, sp_),
                        pspecs,
                        is_leaf=lambda x: isinstance(x, PartitionSpec),
                    ),
                )
            else:
                self.params = jax.device_put(self.params, repl)
            self.cache = jax.tree_util.tree_map(
                lambda x: jax.device_put(x, shard_for(x)), self.cache
            )
            if self.draft_cache is not None:
                # The draft cache stays dense: slots over dp only (its
                # decode runs dp-locally, replicated across sp/tp).
                self.draft_cache = jax.tree_util.tree_map(
                    lambda x: jax.device_put(
                        x,
                        NamedSharding(
                            mesh,
                            PartitionSpec(batch_axis)
                            if x.ndim <= 2
                            else PartitionSpec(None, batch_axis),
                        ),
                    ),
                    self.draft_cache,
                )
            self.next_token = jax.device_put(
                self.next_token, shard_for(self.next_token)
            )
            self.temps = jax.device_put(self.temps, shard_for(self.temps))
            self.top_ks = jax.device_put(self.top_ks, shard_for(self.top_ks))
            self.top_ps = jax.device_put(self.top_ps, shard_for(self.top_ps))
            self.presences = jax.device_put(
                self.presences, shard_for(self.presences)
            )
            self.frequencies = jax.device_put(
                self.frequencies, shard_for(self.frequencies)
            )
            self.pen_counts = jax.device_put(
                self.pen_counts, shard_for(self.pen_counts)
            )
            self.min_ps = jax.device_put(self.min_ps, shard_for(self.min_ps))
            self._active_dev = jax.device_put(
                self._active_dev, shard_for(self._active_dev)
            )
            if self._seq_axis is not None or self._head_axis is not None:
                from .sp_decode import SpStepFns

                self._sp = SpStepFns(
                    mesh,
                    cfg,
                    batch_axis=batch_axis,
                    seq_axis=self._seq_axis,
                    head_axis=self._head_axis,
                )
                # sp prefill goes in chunks that each land in ONE shard.
                self._prefill_chunk = min(128, max_len // self._sp_size)

    # ------------------------------------------------------------------
    def submit(self, request: Request) -> None:
        if len(request.prompt) >= self.max_len:
            raise ValueError("prompt longer than cache capacity")
        self.queue.append(request)

    def pending(self) -> bool:
        return (
            bool(self.queue)
            or any(r is not None for r in self.slots)
            or bool(self._inflight)
        )

    def _next_key(self) -> jax.Array:
        """Next PRNG subkey from the pre-split block (see __init__)."""
        if self._key_block is None or self._key_idx >= 64:
            keys = jax.random.split(self.key, 65)
            self.key = keys[0]
            self._key_block = keys[1:]
            self._key_idx = 0
        sub = self._key_block[self._key_idx]
        self._key_idx += 1
        return sub

    # ------------------------------------------------------------------
    def _admit(self) -> None:
        """Prefill queued requests into free slots."""
        for slot, occupant in enumerate(self.slots):
            if occupant is not None or not self.queue:
                continue
            req = self.queue.popleft()
            tokens = _pad_to(req.prompt, 128)
            shared_tokens = 0
            prefix_keys: List[str] = []
            if self._paged:
                # Memory-based admission control: reserve the request's
                # worst-case page footprint (padded prompt for prefill
                # writes, or prompt + generation + zombie-step margin)
                # so mid-flight growth can never exhaust the pool.
                ps = self.cache.page_size
                worst = max(
                    len(tokens),
                    len(req.prompt)
                    + req.max_new_tokens
                    + self._zombie_margin
                    + 1,
                )
                need = -(-min(worst, self.max_len) // ps)
                while (
                    not self._allocator.can_reserve(need)
                    and self._prefix_registry
                ):
                    # Evict retained prefixes (LRU) before refusing work.
                    key, phys = self._prefix_registry.popitem(last=False)
                    self._allocator.unpin(phys)
                if not self._allocator.can_reserve(need):
                    # Pool full: requeue and wait for retirements.
                    self.queue.appendleft(req)
                    break
                self._allocator.reserve(slot, need)
                if self._prefix_share:
                    prefix_keys = _prefix_chain_keys(req.prompt, ps)
                    # Adopt the longest registered chain prefix, capped
                    # strictly below prompt_len so the tail prefill
                    # always runs (it produces the first sample's
                    # logits) and decode never writes a shared page.
                    adoptable = (len(req.prompt) - 1) // ps
                    for key in prefix_keys[:adoptable]:
                        phys = self._prefix_registry.get(key)
                        if phys is None:
                            break
                        self.cache = self._allocator.adopt(
                            self.cache, slot, phys
                        )
                        self._prefix_registry.move_to_end(key)
                        shared_tokens += ps
                self.cache = self._allocator.grow(
                    self.cache, slot, len(tokens)
                )
                self._host_len[slot] = len(req.prompt)
            if shared_tokens:
                # Prefill only past the shared prefix: its KV is already
                # resident through the adopted pages.
                from .decode import prefill_chunk

                logits, self.cache = prefill_chunk(
                    self.params,
                    self.cfg,
                    self.cache,
                    jnp.asarray(tokens[shared_tokens:]),
                    jnp.int32(shared_tokens),
                    jnp.int32(len(req.prompt)),
                    slot,
                )
            elif self._sp is not None:
                logits, self.cache = self._sp.prefill_slot(
                    self.params,
                    self.cache,
                    jnp.asarray(tokens),
                    jnp.int32(len(req.prompt)),
                    slot,
                    chunk=self._prefill_chunk,
                )
            else:
                logits, self.cache = prefill_slot(
                    self.params,
                    self.cfg,
                    self.cache,
                    jnp.asarray(tokens),
                    jnp.int32(len(req.prompt)),
                    slot,
                    chunk=self._prefill_chunk,
                )
            if self._draft is not None:
                # Speculative serving: the draft model must hold the same
                # prompt context before it can propose.
                _, self.draft_cache = prefill_slot(
                    self._draft[0],
                    self._draft[1],
                    self.draft_cache,
                    jnp.asarray(tokens),
                    jnp.int32(len(req.prompt)),
                    slot,
                )
            if self._prefix_share:
                # Register this prompt's fully-true pages (adopted ones
                # are already present) for future admissions to share.
                full = len(req.prompt) // self.cache.page_size
                owned = self._allocator._owned[slot]
                for i, key in enumerate(prefix_keys[:full]):
                    if key not in self._prefix_registry:
                        self._allocator.pin(owned[i])
                        self._prefix_registry[key] = owned[i]
            # One fused device program installs the occupant: admission
            # sampling + logprob + every per-slot parameter + the penalty
            # count reset (decode.admit_update) — replaces ~8 eager state
            # updates and two synchronous fetches per admission.
            (
                tok_dev,
                logp_dev,
                self.next_token,
                self.temps,
                self.top_ks,
                self.top_ps,
                self.presences,
                self.frequencies,
                self.min_ps,
                self.pen_counts,
            ) = admit_update(
                jnp.asarray(logits, jnp.float32).reshape(-1),
                self._next_key(),
                jnp.int32(slot),
                jnp.float32(req.temperature),
                jnp.int32(req.top_k),
                jnp.float32(req.top_p),
                jnp.float32(req.min_p),
                jnp.float32(req.presence_penalty),
                jnp.float32(req.frequency_penalty),
                self.next_token,
                self.temps,
                self.top_ks,
                self.top_ps,
                self.presences,
                self.frequencies,
                self.min_ps,
                self.pen_counts,
            )
            # The admission token is only needed on the host for
            # bookkeeping (generated list / stop checks); fetching it here
            # would block on every in-flight decode step ahead of it in
            # the device queue (~0.15 s at harvest_lag=16, measured).  The
            # device-side state is already installed, so defer the fetch
            # through the same lagged pipeline as decode tokens.
            for leaf in (tok_dev, logp_dev):
                try:
                    leaf.copy_to_host_async()
                except AttributeError:  # pragma: no cover - older jax
                    pass
            self._inflight.append(("admit", tok_dev, logp_dev, req))
            req.slot = slot
            self.slots[slot] = req
            self._occupancy_dirty = True

    def _maybe_finish(self, req: Request) -> None:
        hit_stop = False
        for seq in req.stop:
            n = len(seq)
            if n and len(req.generated) >= n and req.generated[-n:] == list(
                seq
            ):
                # Truncate the stop sequence itself (vLLM convention);
                # logprobs stay aligned with the surviving tokens.
                del req.generated[-n:]
                del req.logprobs[len(req.generated):]
                hit_stop = True
                break
        hit_eos = req.generated and req.generated[-1] == self.eos_id
        # Margin covers the up-to-harvest_lag zombie steps that may still
        # advance this slot's write head before retirement lands.
        full = (
            len(req.prompt) + len(req.generated)
            >= self.max_len - 1 - self._zombie_margin
        )
        if (
            hit_stop
            or hit_eos
            or len(req.generated) >= req.max_new_tokens
            or full
        ):
            req.done = True
            self.slots[req.slot] = None
            self._occupancy_dirty = True
            if self._paged:
                # Zeroing the table row redirects any still-in-flight
                # zombie writes to the reserved page 0, so the freed
                # pages are immediately safe to re-grant.
                self.cache = self._allocator.release(self.cache, req.slot)
                self._host_len[req.slot] = 0
            else:
                self.cache = reset_slot(self.cache, req.slot)
            if self.draft_cache is not None:
                # The draft cache is always dense, whatever the target
                # cache type.
                self.draft_cache = reset_slot(self.draft_cache, req.slot)
            self.finished[req.uid] = req

    # ------------------------------------------------------------------
    def _harvest_one(self) -> List[Request]:
        """Apply bookkeeping for the oldest in-flight decode step."""
        entry = self._inflight.popleft()
        finished: List[Request] = []
        if isinstance(entry[0], str):  # ("admit", tok, logp, req)
            # Lagged admission bookkeeping: the occupant was installed
            # device-side at admission; its first token lands here, in
            # queue order (before any of its decode tokens).
            _, tok_dev, logp_dev, req = entry
            req.generated.append(int(np.asarray(tok_dev)))
            if self._draft is None:
                req.logprobs.append(float(np.asarray(logp_dev)))
            self._maybe_finish(req)
            if req.done:
                finished.append(req)
            return finished
        toks_dev, lps_dev, uids = entry
        if isinstance(toks_dev, tuple):  # speculative (out, n_emit) round
            out, n_emit = (np.asarray(x) for x in toks_dev)
            for slot, uid in enumerate(uids):
                req = self.slots[slot]
                if uid is None or req is None or req.uid != uid or req.done:
                    continue
                for j in range(int(n_emit[slot])):
                    if req.done:
                        break
                    req.generated.append(int(out[slot, j]))
                    self._maybe_finish(req)
                if self._paged and not req.done:
                    # Re-sync the paged write-head tracker to the true
                    # length: between harvests it advanced one full
                    # verify window per round while the device emitted
                    # only n_emit tokens (see the grow loop in step()).
                    self._host_len[slot] = len(req.prompt) + len(
                        req.generated
                    )
                if req.done:
                    finished.append(req)
            return finished
        toks = np.asarray(toks_dev)  # async copy usually already landed
        rows = toks if toks.ndim == 2 else toks[None]  # multi-step window
        lps = None
        if lps_dev is not None:
            lps = np.asarray(lps_dev)
            lps = lps if lps.ndim == 2 else lps[None]
        for i, row in enumerate(rows):
            for slot, uid in enumerate(uids):
                req = self.slots[slot]
                if uid is None or req is None or req.uid != uid or req.done:
                    continue  # retired/reused, or stopped mid-window
                req.generated.append(int(row[slot]))
                if lps is not None:
                    req.logprobs.append(float(lps[i, slot]))
                self._maybe_finish(req)
                if req.done:
                    finished.append(req)
        return finished

    def step(self) -> List[Request]:
        """Admit, enqueue one decode step, harvest lagged bookkeeping."""
        t0 = time.perf_counter()
        if self._t_started is None:
            self._t_started = t0
        self._admit()
        active_reqs = [r for r in self.slots if r is not None]
        if active_reqs:
            if self._occupancy_dirty:
                # Host->device occupancy transfer only when it changed.
                self._active_dev = jnp.asarray(
                    [r is not None for r in self.slots], dtype=bool
                )
                self._occupancy_dirty = False
            active = self._active_dev
            if self._paged:
                # Grant pages ahead of the dispatch: each active slot is
                # about to append ``multi_step`` tokens — or, on the
                # speculative path, up to the 8-row-padded verify window
                # — from _host_len.  The speculative tracker runs ahead
                # of the true length by up to one window per un-harvested
                # round (it cannot know n_emit yet) and is re-synced to
                # the true length at harvest; the admission reservation's
                # zombie margin covers exactly that drift.
                advance = (
                    self._spec_pad if self._draft is not None
                    else self._multi_step
                )
                for slot, r in enumerate(self.slots):
                    if r is not None:
                        self.cache = self._allocator.grow(
                            self.cache,
                            slot,
                            min(
                                self._host_len[slot] + advance,
                                self.max_len,
                            ),
                        )
                        self._host_len[slot] += advance
            # One fused device program (decode + batched sample, KV cache
            # donated/in-place) per step; the token fetch is issued
            # asynchronously and consumed ``harvest_lag`` steps later.
            sub = self._next_key()
            lps_dev = None
            if self._sp is not None and self._draft is not None:
                # Speculative round on the sp/tp-sharded target cache
                # (sp_decode.SpStepFns.speculative_step): dp-local draft
                # proposals, one multi-row sharded verify, shared
                # acceptance rule.
                (
                    out,
                    n_emit,
                    new_tok,
                    self.cache,
                    self.draft_cache,
                    self.pen_counts,
                ) = self._sp.speculative_step(
                    self.params,
                    self.cache,
                    self._draft[0],
                    self.draft_cache,
                    self.next_token,
                    active,
                    sub,
                    self.temps,
                    self.top_ks,
                    self.top_ps,
                    self.min_ps,
                    self.pen_counts,
                    self.presences,
                    self.frequencies,
                    cfg_d=self._draft[1],
                    gamma=self._spec_gamma,
                )
                toks_dev = (out, n_emit)
                self.next_token = new_tok
            elif self._sp is not None and self._multi_step > 1:
                toks_dev, lps_dev, self.cache, self.pen_counts = (
                    self._sp.decode_and_sample_multi(
                        self.params,
                        self.cache,
                        self.next_token,
                        active,
                        sub,
                        self.temps,
                        self.top_ks,
                        self.top_ps,
                        self.pen_counts,
                        self.presences,
                        self.frequencies,
                        self.min_ps,
                        n_steps=self._multi_step,
                    )
                )  # [multi_step, B]
                self.next_token = toks_dev[-1]
            elif self._sp is not None:
                toks_dev, lps_dev, self.cache, self.pen_counts = (
                    self._sp.decode_and_sample(
                        self.params,
                        self.cache,
                        self.next_token,
                        active,
                        sub,
                        self.temps,
                        self.top_ks,
                        self.top_ps,
                        self.pen_counts,
                        self.presences,
                        self.frequencies,
                        self.min_ps,
                    )
                )
            elif self._draft is not None:
                from .speculative import speculative_step

                (
                    out,
                    n_emit,
                    new_tok,
                    self.cache,
                    self.draft_cache,
                    self.pen_counts,
                ) = speculative_step(
                    self.params,
                    self.cfg,
                    self.cache,
                    self._draft[0],
                    self._draft[1],
                    self.draft_cache,
                    self.next_token,
                    active,
                    sub,
                    self.temps,
                    self.top_ks,
                    self.top_ps,
                    self.min_ps,
                    self.pen_counts,
                    self.presences,
                    self.frequencies,
                    gamma=self._spec_gamma,
                )
                toks_dev = (out, n_emit)
                self.next_token = new_tok
            elif self._multi_step > 1:
                toks_dev, lps_dev, self.cache, self.pen_counts = (
                    decode_and_sample_multi(
                        self.params,
                        self.cfg,
                        self.cache,
                        self.next_token,
                        active,
                        sub,
                        self.temps,
                        self.top_ks,
                        self.top_ps,
                        self.pen_counts,
                        self.presences,
                        self.frequencies,
                        self.min_ps,
                        n_steps=self._multi_step,
                    )
                )  # [multi_step, B]
                self.next_token = toks_dev[-1]
            else:
                toks_dev, lps_dev, self.cache, self.pen_counts = decode_and_sample(
                    self.params,
                    self.cfg,
                    self.cache,
                    self.next_token,
                    active,
                    sub,
                    self.temps,
                    self.top_ks,
                    self.top_ps,
                    self.pen_counts,
                    self.presences,
                    self.frequencies,
                    self.min_ps,
                )
            if self._draft is None and self._multi_step == 1:
                self.next_token = toks_dev
            leaves = toks_dev if isinstance(toks_dev, tuple) else (toks_dev,)
            if lps_dev is not None:
                leaves = leaves + (lps_dev,)
            for leaf in leaves:
                try:
                    leaf.copy_to_host_async()
                except AttributeError:  # pragma: no cover - older jax
                    pass
            self._inflight.append(
                (toks_dev, lps_dev,
                 [r.uid if r else None for r in self.slots])
            )
            self.steps += 1 if self._draft is not None else self._multi_step

        finished: List[Request] = []
        while self._inflight and (
            len(self._inflight) > self.harvest_lag or not active_reqs
        ):
            finished.extend(self._harvest_one())
        self._step_seconds += time.perf_counter() - t0
        self._tokens_emitted = sum(
            len(r.generated) for r in self.finished.values()
        ) + sum(
            len(r.generated) for r in self.slots if r is not None
        )
        return finished

    def stats(self) -> Dict[str, float]:
        """Serving throughput counters (host wall clock).

        ``tokens``: emitted so far (finished + in-flight);
        ``tokens_per_s``: tokens / cumulative step() seconds;
        ``ms_per_step``: mean dispatch cadence.  Dispatch and fetch costs
        are included — these are end-to-end numbers, matching
        harness/serving.py's methodology.
        """
        steps = max(self.steps, 1)
        secs = max(self._step_seconds, 1e-9)
        return {
            "steps": float(self.steps),
            "seconds": self._step_seconds,
            "tokens": float(self._tokens_emitted),
            "tokens_per_s": self._tokens_emitted / secs,
            "ms_per_step": 1e3 * self._step_seconds / steps,
        }

    def run(self) -> Dict[int, List[int]]:
        """Drain the queue; returns {uid: generated tokens}."""
        while self.pending():
            self.step()
        return {uid: r.generated for uid, r in self.finished.items()}

    # ------------------------------------------------------------------
    # Crash/restart recovery (SURVEY.md §5: the decode loop tolerates
    # restart from a KV-cache snapshot — the serving-scale generalization
    # of the reference persisting its logsumexp as re-entry state,
    # kernels.metal:861-864).
    def snapshot(self) -> dict:
        """Consistent serving state: drain lagged bookkeeping, then copy.

        The returned dict round-trips through ``utils.checkpoint``
        (pure arrays + plain metadata).
        """
        while self._inflight:
            self._harvest_one()
        paged_state = None
        if self._paged:
            paged_state = {
                "owned": [list(x) for x in self._allocator._owned],
                "reserved": list(self._allocator._reserved),
                "refs": list(self._allocator._refs),
                "registry": list(self._prefix_registry.items()),
                "host_len": list(self._host_len),
            }
        return {
            "paged": paged_state,
            "cache": self.cache,
            "draft_cache": self.draft_cache,
            "next_token": self.next_token,
            "temps": self.temps,
            "top_ks": self.top_ks,
            "top_ps": self.top_ps,
            "presences": self.presences,
            "frequencies": self.frequencies,
            "pen_counts": self.pen_counts,
            "min_ps": self.min_ps,
            "key": self.key,
            "key_block": self._key_block,
            "key_idx": self._key_idx,
            "steps": self.steps,
            "slots": [
                None
                if r is None
                else {
                    "uid": r.uid,
                    "prompt": list(r.prompt),
                    "max_new_tokens": r.max_new_tokens,
                    "temperature": r.temperature,
                    "top_k": r.top_k,
                    "top_p": r.top_p,
                    "presence_penalty": r.presence_penalty,
                    "frequency_penalty": r.frequency_penalty,
                    "min_p": r.min_p,
                    "stop": [list(x) for x in r.stop],
                    "generated": list(r.generated),
                    "logprobs": list(r.logprobs),
                    "slot": r.slot,
                }
                for r in self.slots
            ],
            "queue": [
                {
                    "uid": r.uid,
                    "prompt": list(r.prompt),
                    "max_new_tokens": r.max_new_tokens,
                    "temperature": r.temperature,
                    "top_k": r.top_k,
                    "top_p": r.top_p,
                    "presence_penalty": r.presence_penalty,
                    "frequency_penalty": r.frequency_penalty,
                    "min_p": r.min_p,
                    "stop": [list(x) for x in r.stop],
                }
                for r in self.queue
            ],
        }

    def restore(self, snap: dict) -> None:
        """Resume from a ``snapshot()`` (e.g. after a crash/restart)."""
        self.cache = snap["cache"]
        if self.draft_cache is not None and snap.get("draft_cache") is not None:
            self.draft_cache = snap["draft_cache"]
        self.next_token = jnp.asarray(snap["next_token"])
        self.temps = jnp.asarray(snap["temps"])
        self.top_ks = jnp.asarray(
            snap.get("top_ks", jnp.zeros_like(self.temps, jnp.int32))
        )
        self.top_ps = jnp.asarray(
            snap.get("top_ps", jnp.ones_like(self.temps))
        )
        if snap.get("presences") is not None:
            self.presences = jnp.asarray(snap["presences"])
            self.frequencies = jnp.asarray(snap["frequencies"])
            self.pen_counts = jnp.asarray(snap["pen_counts"])
        if snap.get("min_ps") is not None:
            self.min_ps = jnp.asarray(snap["min_ps"])
        self.key = jnp.asarray(snap["key"])
        kb = snap.get("key_block")
        self._key_block = None if kb is None else jnp.asarray(kb)
        self._key_idx = int(snap.get("key_idx", 0))
        self.steps = int(snap["steps"])
        self.slots = [
            None
            if meta is None
            else Request(
                uid=meta["uid"],
                prompt=list(meta["prompt"]),
                max_new_tokens=meta["max_new_tokens"],
                temperature=meta["temperature"],
                top_k=meta.get("top_k", 0),
                top_p=meta.get("top_p", 1.0),
                presence_penalty=meta.get("presence_penalty", 0.0),
                frequency_penalty=meta.get("frequency_penalty", 0.0),
                min_p=meta.get("min_p", 0.0),
                stop=[list(x) for x in meta.get("stop", [])],
                generated=list(meta["generated"]),
                logprobs=list(meta.get("logprobs", [])),
                slot=meta["slot"],
            )
            for meta in snap["slots"]
        ]
        self.queue = deque(
            Request(
                uid=meta["uid"],
                prompt=list(meta["prompt"]),
                max_new_tokens=meta["max_new_tokens"],
                temperature=meta["temperature"],
                top_k=meta.get("top_k", 0),
                top_p=meta.get("top_p", 1.0),
                presence_penalty=meta.get("presence_penalty", 0.0),
                frequency_penalty=meta.get("frequency_penalty", 0.0),
                min_p=meta.get("min_p", 0.0),
                stop=[list(x) for x in meta.get("stop", [])],
            )
            for meta in snap["queue"]
        )
        self._inflight.clear()
        self._occupancy_dirty = True
        if self._paged and snap.get("paged") is not None:
            meta = snap["paged"]
            alloc = self._allocator
            alloc._owned = [list(x) for x in meta["owned"]]
            alloc._reserved = list(meta["reserved"])
            alloc._refs = list(meta["refs"])
            alloc._committed = sum(alloc._reserved)
            alloc._pinned = len(meta["registry"])
            alloc._free = [
                p
                for p in range(self.cache.n_pages - 1, 0, -1)
                if alloc._refs[p] == 0
            ]
            self._prefix_registry = OrderedDict(
                (k, int(v)) for k, v in meta["registry"]
            )
            self._host_len = list(meta["host_len"])
