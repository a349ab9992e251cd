"""Shared kernel helpers: the route decision and the dropout hash."""

import os

import numpy as np

import jax
import jax.numpy as jnp


def _i32(x: int) -> np.int32:
    """A uint32 literal as its two's-complement int32 bit pattern."""
    return np.int32(np.uint32(x))


# Mixing constants: golden-ratio increment + murmur3/lowbias32 multipliers.
_MIX_A = _i32(0x9E3779B9)
_MIX_B = _i32(0x85EBCA6B)
_MIX_C = _i32(0x7FEB352D)
_MIX_D = _i32(0x846CA68B)
_MASK31 = np.int32(0x7FFFFFFF)

# The one switch that lets Pallas kernels run without a GPU.
INTERPRET_ENV = "FLASH_ATTENTION_INTERPRET"


def pallas_interpret() -> bool:
    """Route decision for every ``pallas_call`` in the package.

    On the GPU the kernels compile through Triton and never interpret.
    Elsewhere they run in the Pallas interpreter only when the caller
    asked for it by setting ``FLASH_ATTENTION_INTERPRET=1`` (the test
    suite and the CPU recipe do); otherwise this raises, so a CPU run
    never passes silently through the interpreter.
    """
    backend = jax.default_backend()
    if backend == "gpu":
        return False
    if os.environ.get(INTERPRET_ENV) == "1":
        return True
    raise RuntimeError(
        f"the Pallas attention kernels compile only for the GPU, and the "
        f"backend is {backend!r}; set {INTERPRET_ENV}=1 to run them in "
        f"interpret mode, or pass impl='xla'"
    )


def _mix32(x: jax.Array) -> jax.Array:
    """'lowbias32'-style avalanche finalizer on int32 (wraparound mul).

    int32 two's-complement multiply/xor/shift produce the same bits as
    the canonical uint32 formulation, and every op here lowers through
    Triton, in interpret mode and in XLA identically — which is the
    whole point: the dropout mask must be reproducible bit-for-bit
    across the forward kernel, both backward kernels, and the pure-jnp
    oracle, regardless of block sizes.
    """
    x = x ^ jax.lax.shift_right_logical(x, 16)
    x = x * _MIX_C
    x = x ^ jax.lax.shift_right_logical(x, 15)
    x = x * _MIX_D
    x = x ^ jax.lax.shift_right_logical(x, 16)
    return x


def pack_dropout_seed(seed, offsets=None) -> jax.Array:
    """Pack the dropout seed + global-coordinate offsets into the int32
    vector the kernels consume.

    Layout: ``[seed, row_off, col_off, batch_off, head_off]``.  The
    offsets translate the kernels' shard-local grid coordinates into
    GLOBAL logical coordinates, so any mesh factorization (ring/allgather
    sequence shards, dp batch shards, tp head shards) regenerates the
    exact single-device mask — sharding-invariant dropout, not just
    seed-folded decorrelation.  ``offsets`` is a 4-tuple of int scalars
    (traced OK), default all-zero; a pre-packed length-5 vector passes
    through untouched (op-layer custom_vjp convenience).
    """
    seed = jnp.asarray(seed, jnp.int32).reshape(-1)
    if seed.shape[0] == 5:
        if offsets is not None:
            raise ValueError("pre-packed dropout seed with extra offsets")
        return seed
    if seed.shape[0] != 1:
        raise ValueError(
            f"dropout_seed must be a scalar or packed [5], got {seed.shape}"
        )
    if offsets is None:
        offs = jnp.zeros((4,), jnp.int32)
    else:
        if len(offsets) != 4:
            raise ValueError(
                "dropout_offsets must be (row, col, batch, head), got "
                f"{len(offsets)} entries"
            )
        offs = jnp.stack(
            [jnp.asarray(o, jnp.int32).reshape(()) for o in offsets]
        )
    return jnp.concatenate([seed, offs])


def dropout_keep(
    seed: jax.Array,
    bh: jax.Array,
    rows: jax.Array,
    cols: jax.Array,
    rate: float,
) -> jax.Array:
    """Counter-based attention-dropout keep mask: {0, 1/(1-rate)} fp32.

    A stateless Philox-style construction: the mask at score position
    ``(bh, row, col)`` is a pure function of the int32 seed and the
    *absolute* coordinates, so the forward and the two FA-2 backward
    kernels regenerate identical masks from nothing but their program
    indices — no mask tensor is ever materialized in HBM, and the
    kernels' block sizes don't have to agree (the reference's backward
    has no dropout at all; this mirrors FlashAttention-2's in-kernel
    dropout).

    All arguments broadcast: kernels pass scalar ``bh`` with [bq, 1] /
    [1, bk] index vectors; the oracle passes (B, H, 1, 1) / (1, 1, N, 1) /
    (1, 1, 1, N) arrays.  ``rate`` is trace-time; keep probability is
    ``1 - rate`` on a 31-bit uniform lattice.
    """
    seed = jnp.asarray(seed, jnp.int32)
    bh = jnp.asarray(bh, jnp.int32)
    rows = jnp.asarray(rows, jnp.int32)
    cols = jnp.asarray(cols, jnp.int32)
    threshold = np.int32(min(int(round(rate * 2.0**31)), 2**31 - 1))
    inv_keep = np.float32(1.0 / (1.0 - rate))
    h = _mix32(seed ^ (bh * _MIX_A))
    h = _mix32(h + rows * _MIX_B)
    h = _mix32(h + cols * _MIX_A)
    keep = (h & _MASK31) >= threshold
    return jnp.where(keep, inv_keep, np.float32(0.0))
