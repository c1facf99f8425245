"""The device-op dispatch layer of the port (counterpart of the
reference's ``runtime/dispatch.py``).

The reference pads the leading row dimension of every device-op input up
to a bucket of a geometric schedule and memoizes one compiled executable
per bucket, because under XLA a new batch size costs a retrace and a
recompile. On CUDA a new batch size costs a kernel launch, not a compile
(the reference's own module docstring says so), so the port keeps none
of that machinery: no padding, no executable cache, no persistent
compilation cache, no ``call``/``rowwise`` wrapper. An op runs its
function directly, which is the reference's inline path (``_inline``),
bit-identical to its bucketed one by contract. Capturing a region as a
CUDA graph (or ``torch.compile`` of it) would be this layer's job; no
caller asks for it yet. ``sharded_call`` runs its closure directly: the
reference memoizes a compiled ``shard_map`` executable there, and the
port's distributed steps (``parallel/``) are bulk-synchronous Python over
the executors, with nothing to compile.

What stays is the bucket schedule as pure arithmetic (``bucket_for``,
``quantize_capacity``) with the reference's defaults (``dispatch.*``
options on, 16 rows, waste 1.0): the shuffle's capacities
(``parallel/shuffle.py``) and the exchange's (ROADMAP.md Queue 1 entry
12b) are sized by ``quantize_capacity``, and those capacities change
outputs.
"""

from __future__ import annotations

__all__ = ["BUCKET_BASE", "MAX_WASTE_FRAC", "bucket_for",
           "quantize_capacity", "sharded_call"]

BUCKET_BASE = 16       # the reference's dispatch.bucket_base default
MAX_WASTE_FRAC = 1.0   # the reference's dispatch.max_waste_frac default


def bucket_for(n: int, base: int = BUCKET_BASE,
               max_waste_frac: float = MAX_WASTE_FRAC) -> int:
    """Smallest bucket >= n. Buckets are multiples of ``base`` growing
    geometrically by ``min(1 + max_waste_frac, 2)``: waste_frac 1.0
    gives power-of-two-style buckets (at most ~50% padded rows), 0.0
    degenerates to linear base-multiple rounding."""
    base = max(1, int(base))
    waste = max(0.0, float(max_waste_frac))
    n = max(int(n), 1)
    if n <= base:
        return base
    growth = min(1.0 + waste, 2.0)
    if growth <= 1.0:
        return ((n + base - 1) // base) * base
    b = base
    while b < n:
        nxt = ((int(b * growth) + base - 1) // base) * base
        b = max(nxt, b + base)
    return b


def quantize_capacity(capacity: int, base: int = BUCKET_BASE,
                      max_waste_frac: float = MAX_WASTE_FRAC) -> int:
    """Bucket-quantize a derived output capacity (the shuffle's
    per-device slot count): growing a capacity is always safe, extra
    slots are padding."""
    return bucket_for(int(capacity), base, max_waste_frac)


def sharded_call(op: str, build, args: tuple, statics: tuple = ()):
    """``build()(*args)``: the reference's signature, whose executable
    memoization keys on ``op`` and ``statics``; the port has no
    executable to cache, so the closure runs directly."""
    return build()(*args)
