"""The all-to-all shuffle (counterpart of ``spark_rapids_jni_tpu/parallel/
shuffle.py``): repartition the executors' tables by key hash.

Each executor packs its rows into a ``(D, capacity)`` send buffer (rows
sorted by destination partition, one gather) with an occupancy mask, and
one all-to-all over the mesh moves every block (``ExecutorMesh.
all_to_all``). Unoccupied receive slots surface as null rows, which every
downstream operator skips. The default capacity ``ceil(n/D) * 2`` covers
2x skew; overflow is detected and reported per executor
(``ShuffleResult.overflowed``), never silently dropped.

The reference's ``hash_shuffle`` runs on one device inside ``shard_map``.
The port's takes the mesh and the list of the executors' tables this
process holds and returns one ``ShuffleResult`` per executor: the send
side is a loop over the executors, then one collective per buffer, then
the receive side. Row order is the reference's: each executor's output
is its ``D * capacity`` slots, the blocks laid out by source executor.

String columns travel in the padded layout: int32 lengths on the
fixed-width path and the (n, W) char matrix as W byte lanes of the same
exchange. DECIMAL128 travels as its two int64 limbs; masks as uint8.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch

from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.columnar.column import take
from spark_rapids_jni_tpu_torch.ops.hash import partition_hash
from spark_rapids_jni_tpu_torch.parallel.wire import (
    BitPack,
    pack_bits,
    unpack_bits,
)
from spark_rapids_jni_tpu_torch.types import TypeId
from spark_rapids_jni_tpu_torch.utils.tracing import func_range

__all__ = ["ShuffleResult", "hash_shuffle", "shuffle_by_partition",
           "classify_overflow", "report_shuffle_telemetry"]


class ShuffleResult(NamedTuple):
    table: Table                # D*capacity rows, null-masked where empty
    row_valid: torch.Tensor     # bool[D*capacity]: slot holds a real row
    overflowed: torch.Tensor    # 0-d bool: this executor dropped rows
    # 0-d bool: a wire-narrowed value did not survive the round trip
    # (the planner declared a too-narrow wire type)
    narrowing_overflow: torch.Tensor


class _SendPlan(NamedTuple):
    """Inverted send-buffer mapping: output slot s takes input row
    ``src[s]`` when ``hit[s]`` (else the slot is empty). Computed once a
    shuffle and reused by every column."""

    src: torch.Tensor  # int64[size], rows of the input table
    hit: torch.Tensor  # bool[size]


def _plan_send(dst_mono: torch.Tensor, in_cap: torch.Tensor,
               size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Invert the monotone row->slot map into a slot->row search.

    ``dst_mono`` is non-decreasing over the partition-sorted rows (slots
    increase within a partition, partitions across runs; dropped rows are
    capped at the partition boundary so monotonicity survives overflow).
    Ties (capped overflow rows, phantom rows sharing a slot) go to the
    LAST row of a tie group, the real in-capacity row always sorting
    after its capped or phantom shadows, and ``in_cap[src]`` rejects
    groups with no real member. Returns (src, hit) over sorted rows."""
    n = dst_mono.shape[0]
    device = dst_mono.device
    slots = torch.arange(size, dtype=torch.int64, device=device)
    if not n:
        return (torch.zeros((size,), dtype=torch.int64, device=device),
                torch.zeros((size,), dtype=torch.bool, device=device))
    pos = torch.searchsorted(dst_mono, slots, right=True) - 1
    src = pos.clamp(0, n - 1)
    hit = (pos >= 0) & (dst_mono[src] == slots) & in_cap[src]
    return src, hit


def _pack_send(data: torch.Tensor, plan: _SendPlan) -> torch.Tensor:
    """Rows laid out in send-buffer order through the inverted plan (pure
    gathers); 1-D columns and 2-D row matrices (padded chars, DECIMAL128
    limbs, padded list elements) alike. Empty slots hold zeros."""
    size = plan.hit.shape[0]
    if data.shape[0] == 0:
        return torch.zeros((size,) + tuple(data.shape[1:]),
                           dtype=data.dtype, device=data.device)
    g = take(data, plan.src)
    hit = plan.hit.view((size,) + (1,) * (g.ndim - 1))
    if g.dtype == torch.bool:
        return g & hit
    return torch.where(hit, g, torch.zeros((), dtype=g.dtype,
                                           device=g.device))


def _prepare(part: torch.Tensor, row_valid: Optional[torch.Tensor],
             capacity: int, d: int) -> tuple[_SendPlan, torch.Tensor]:
    """One executor's send plan (over its input rows) and its overflow
    flag, as the reference computes them over the partition-sorted rows."""
    n = part.shape[0]
    device = part.device
    part = part.to(torch.int64)
    # stable: rows keep their input order within a partition
    order = torch.argsort(part, stable=True)
    part_sorted = part[order]
    real_sorted = (torch.ones((n,), dtype=torch.bool, device=device)
                   if row_valid is None else row_valid[order])
    real = real_sorted.to(torch.int64)
    csum = torch.cumsum(real, 0)
    rank_excl = csum - real  # real rows strictly before this row
    if n:
        part_start = torch.searchsorted(
            part_sorted, torch.arange(d, dtype=torch.int64, device=device))
        base = rank_excl[part_start.clamp(0, n - 1)]
        offsets = torch.where(part_start < n, base, csum[-1])
    else:
        offsets = torch.zeros((d,), dtype=torch.int64, device=device)
    # slot = real rows of the same partition before this row; the
    # exclusive rank makes a phantom row tie with the NEXT real row (and
    # sort before it), so the last row of a tie group is the real one
    slot = rank_excl - offsets[part_sorted] if n else rank_excl
    in_cap = (slot < capacity) & real_sorted
    overflowed = ((slot >= capacity) & real_sorted).any()
    dst_mono = part_sorted * capacity + slot.clamp(0, capacity)
    src, hit = _plan_send(dst_mono, in_cap, d * capacity)
    return _SendPlan(order[src] if n else src, hit), overflowed


@func_range("hash_shuffle")
def hash_shuffle(
    mesh,
    tables: Sequence[Table],
    keys: Sequence[int],
    capacity: Optional[int] = None,
    row_valid: Optional[Sequence[torch.Tensor]] = None,
    wire_dtypes: Optional[Sequence] = None,
) -> list[ShuffleResult]:
    """Exchange rows so row r lands on executor ``hash(keys(r)) % D``.

    The port's signature takes the mesh and the executors' tables this
    process holds (and their ``row_valid`` masks), where the reference's
    takes one device's table and the axis name inside ``shard_map``; it
    returns one result per executor, each padded to ``D * capacity``
    rows. ``row_valid`` False rows (padding) are dropped before the
    exchange and never count as overflow; a real row with a NULL key
    still shuffles, to the null-hash partition."""
    parts = [partition_hash(t, list(keys), mesh.size) for t in tables]
    return shuffle_by_partition(mesh, tables, parts, capacity=capacity,
                                row_valid=row_valid, wire_dtypes=wire_dtypes)


def _common_width(cols: list) -> list:
    """String columns of the executors padded to one width (the local
    transport concatenates their blocks); in a process group every rank
    already holds the global width (``shard_table``)."""
    from spark_rapids_jni_tpu_torch.ops.strings import pad_to_common_width

    for c in cols:
        if not c.is_padded_string:
            raise NotImplementedError(
                "hash_shuffle needs string columns in the padded device "
                "layout (ops.strings.pad_strings / shard_table do this)")
    return pad_to_common_width(cols) if len(cols) > 1 else cols


@func_range("shuffle_by_partition")
def shuffle_by_partition(
    mesh,
    tables: Sequence[Table],
    parts: Sequence[torch.Tensor],
    capacity: Optional[int] = None,
    row_valid: Optional[Sequence[torch.Tensor]] = None,
    wire_dtypes: Optional[Sequence] = None,
) -> list[ShuffleResult]:
    """Exchange rows by a caller-computed partition id (int32[n] in
    [0, D)) per executor: ``hash_shuffle`` routes by key hash, the
    distributed sort by splitter bucket. Takes and returns the
    per-executor lists, as :func:`hash_shuffle` does."""
    tables = list(tables)
    d = mesh.size
    k = len(tables)
    n = max(t.num_rows for t in tables)
    if any(t.num_rows != n for t in tables):
        raise ValueError("the executors' tables must hold equal row counts "
                         "(shard_table pads them)")
    if capacity is None:
        # bucket-quantized, as the reference's derived capacity: part of
        # the output's shape, so it must be the reference's
        from spark_rapids_jni_tpu_torch.runtime import dispatch

        capacity = dispatch.quantize_capacity(max(1, math.ceil(n / d) * 2))
    capacity = int(capacity)
    size = d * capacity
    rvs = [None] * k if row_valid is None else list(row_valid)
    prep = [_prepare(p, rv, capacity, d) for p, rv in zip(parts, rvs)]
    plans = [p for p, _ in prep]
    overflowed = [o for _, o in prep]

    def exchange(bufs):
        # the bytes this process's executors hand to the all-to-all
        # (masks one byte a slot): ``shuffle_wire_bytes``'s wire bytes
        telemetry.count("shuffle.wire_bytes", sum(b.nbytes for b in bufs))
        return mesh.all_to_all(bufs)

    recv_occ = exchange([p.hit for p in plans])

    if wire_dtypes is not None and len(wire_dtypes) != tables[0].num_columns:
        raise ValueError("wire_dtypes must match the column count")

    narrowing = [torch.zeros((), dtype=torch.bool, device=p.hit.device)
                 for p in plans]
    out_cols: list[list] = [[] for _ in range(k)]
    for i in range(tables[0].num_columns):
        cols = [t.column(i) for t in tables]
        col = cols[0]
        wire = None if wire_dtypes is None else wire_dtypes[i]
        valid = exchange([_pack_send(c.valid_mask(), p)
                          for c, p in zip(cols, plans)])
        valid = [v & o for v, o in zip(valid, recv_occ)]
        if col.dtype.is_string:
            if wire is not None:
                raise ValueError(
                    "wire narrowing does not apply to string columns "
                    f"(column {i}); pass None for its wire dtype")
            cols = _common_width(cols)
            lens = exchange([_pack_send(c.data, p)
                             for c, p in zip(cols, plans)])
            mats = exchange([_pack_send(c.chars, p)
                             for c, p in zip(cols, plans)])
            for e in range(k):
                out_cols[e].append(Column(col.dtype, lens[e], valid[e],
                                          chars=mats[e]))
            continue
        if col.dtype.type_id == TypeId.LIST:
            if not col.is_padded_list:
                raise NotImplementedError(
                    "hash_shuffle needs LIST columns in the padded wire "
                    "layout (ops.lists.pad_lists before the shuffle)")
            if wire is not None:
                raise ValueError(
                    "wire narrowing does not apply to LIST columns "
                    f"(column {i}); pass None for its wire dtype")
            lens = exchange([_pack_send(c.data, p)
                             for c, p in zip(cols, plans)])
            mats = exchange([_pack_send(c.children[0].data, p)
                             for c, p in zip(cols, plans)])
            evs = exchange([_pack_send(c.children[0].validity, p)
                            for c, p in zip(cols, plans)])
            elem = col.children[0]
            for e in range(k):
                occ = recv_occ[e]
                # unoccupied slots read as EMPTY lists, not stale rows
                out_cols[e].append(Column(
                    col.dtype, torch.where(occ, lens[e], 0), valid[e],
                    children=[Column(elem.dtype, mats[e],
                                     evs[e] & occ[:, None])]))
            continue
        if not (col.dtype.is_fixed_width or col.dtype.is_decimal128):
            raise NotImplementedError(
                "hash_shuffle supports fixed-width columns only (reference "
                "row_conversion.cu:515 has the same restriction)")
        if wire is not None and col.dtype.is_decimal128:
            raise ValueError(
                f"wire narrowing does not apply to DECIMAL128 (column {i}); "
                "pass None for its wire dtype")
        if isinstance(wire, BitPack):
            # frame-of-reference bit-packing: null and unoccupied slots
            # hold the reference value so they always pack; out-of-range
            # real values set narrowing_overflow
            if col.dtype.storage_dtype.kind not in ("i", "u"):
                raise TypeError(
                    f"BitPack wire spec needs integral storage (column {i})")
            words = []
            for e, (c, p) in enumerate(zip(cols, plans)):
                ref = torch.full((), wire.reference, dtype=c.data.dtype,
                                 device=c.device)
                sent = _pack_send(torch.where(c.valid_mask(), c.data, ref),
                                  p)
                sent = torch.where(p.hit, sent, ref)
                packed, ovf = pack_bits(sent.reshape(d, capacity), wire)
                narrowing[e] = narrowing[e] | ovf
                words.append(packed.reshape(-1))
            recv = [unpack_bits(w.reshape(d, -1), capacity, wire,
                                col.data.dtype).reshape(size)
                    for w in exchange(words)]
        elif wire is not None:
            # a narrower wire dtype declared by the planner; nulls are
            # zeroed first, so garbage payloads cannot trip the check
            sends = []
            for e, (c, p) in enumerate(zip(cols, plans)):
                clean = torch.where(c.valid_mask(), c.data,
                                    torch.zeros_like(c.data))
                sent = _pack_send(clean, p)
                narrow = sent.to(wire.torch_dtype)
                narrowing[e] = narrowing[e] | \
                    (narrow.to(c.data.dtype) != sent).any()
                sends.append(narrow)
            recv = [r.to(col.data.dtype) for r in exchange(sends)]
        else:
            recv = exchange([_pack_send(c.data, p)
                             for c, p in zip(cols, plans)])
        for e in range(k):
            out_cols[e].append(Column(col.dtype, recv[e], valid[e]))

    return [ShuffleResult(Table(out_cols[e]), recv_occ[e], overflowed[e],
                          narrowing[e]) for e in range(k)]


def classify_overflow(*, op: str = "hash_shuffle",
                      capacity: int | None = None,
                      rows: int | None = None,
                      partition: int | None = None,
                      required: int | None = None,
                      seam: str = "shuffle.transport",
                      **context):
    """The classified error of a tripped shuffle or exchange capacity
    flag: a ``resilience.CapacityOverflow`` carrying the partition and
    capacity context, so the host boundary that reads the flag raises
    something ``resilience.escalate`` (and every classified handler
    above it) can act on, never a bare boolean."""
    from spark_rapids_jni_tpu_torch.runtime import resilience

    where = "" if partition is None else f" (hot partition {partition})"
    need = "" if required is None else f"; {required} slots required"
    return resilience.CapacityOverflow(
        f"{op}: partition capacity overflow{where}: a destination "
        f"received more rows than its "
        f"{capacity if capacity is not None else 'derived'} send-buffer "
        f"slots{need}",
        seam=seam,
        **{k: v for k, v in dict(
            capacity=capacity, rows=rows, partition=partition,
            required=required, **context).items() if v is not None})


def _any_set(flag) -> bool:
    if flag is None:
        return False
    if isinstance(flag, (list, tuple)):
        return any(bool(f) for f in flag)
    return bool(torch.as_tensor(flag).any())


def report_shuffle_telemetry(result=None,
                             op: str = "hash_shuffle",
                             rows: int | None = None, *,
                             overflowed=None,
                             narrowing_overflow=None,
                             capacity: int | None = None,
                             partition: int | None = None,
                             raise_on_overflow: bool = False) -> None:
    """Host-side overflow accounting for a shuffle's results (one
    ``ShuffleResult``, the per-executor list, or just the flags).

    A tripped capacity flag is recorded as a fallback event stamped
    ``CapacityOverflow`` and, with ``raise_on_overflow``, raised
    classified (:func:`classify_overflow`); a tripped narrowing flag is
    a ``MalformedInputError`` (a contract breach, not a capacity
    problem). With neither, a dispatch is recorded. The port records
    these events whether or not ``telemetry.enabled`` is on (its
    in-process events always are)."""
    from spark_rapids_jni_tpu_torch.runtime import resilience

    if result is not None:
        results = result if isinstance(result, list) else [result]
        overflowed = [r.overflowed for r in results]
        narrowing_overflow = [r.narrowing_overflow for r in results]
    ovf = _any_set(overflowed)
    nvf = _any_set(narrowing_overflow)
    if ovf:
        telemetry.record_fallback(
            op, "partition capacity overflow: a device dropped rows "
            "(re-plan with larger capacity)", rows=rows,
            error_kind="CapacityOverflow",
            **({} if capacity is None else {"capacity": capacity}))
    if nvf:
        telemetry.record_fallback(
            op, "wire narrowing overflow: a narrowed value did not "
            "survive the round trip (planner declared too-narrow wire "
            "type)", rows=rows, error_kind="MalformedInputError")
    if not (ovf or nvf):
        telemetry.record_dispatch(op, rows=rows)
    if raise_on_overflow:
        if ovf:
            raise classify_overflow(op=op, capacity=capacity, rows=rows,
                                    partition=partition)
        if nvf:
            raise resilience.MalformedInputError(
                f"{op}: wire narrowing overflow: a narrowed value did not "
                "survive the round trip (planner declared a too-narrow "
                "wire type)", seam="shuffle.transport",
                **({} if rows is None else {"rows": rows}))
