"""The general-cardinality exchange: hash-partitioned all-to-all
repartitioning between processes (counterpart of the reference's
``runtime/exchange.py``), the Spark exchange operator.

Three halves, each on a discipline the port already has:

* **Device half**: ``partition_hash``, then a destination-sorted pack
  into one contiguous ``(parts, capacity)`` send buffer through the
  shuffle's inverted send plan (``parallel/shuffle.py``'s ``_prepare``
  and ``_pack_send``, imported, not copied). Capacities are quantized
  through the bucket schedule (``runtime/dispatch.py``); destination
  p's rows are exactly the first ``counts[p]`` slots of its run, so the
  host trims real rows with plain slices.

* **Wire half**: per-destination buffers ship as codec frames under the
  integrity seal through ``dcn.send_framed`` / ``dcn.recv_framed``
  (verify, then decode, with NAK refetch); injected corruption is
  scoped to the ``exchange.wire`` seam. Inside the cluster the wire
  form is one table per source (slices flight-major, then part-major)
  whose ``row_counts`` ride as plain meta.

* **Overflow half**: an overflowing pack escalates geometrically
  through ``resilience.escalate`` up to ``exchange.max_capacity_rows``,
  then demotes to chunked flights (each chunk packed at a capacity that
  cannot overflow), and the receive side merges flights through
  ``outofcore.run_chunked_aggregate`` with a SpillStore, so skewed keys
  degrade into host spill instead of failing. An overflow that escapes
  the ladder is a classified ``CapacityOverflow``.

On top sit ``partitioned_groupby`` and ``partitioned_join`` (hash
co-partition, the operator per partition, concatenate) and the
``Exchange`` plan node (``runtime/fusion.py``), which the cluster's
``submit_exchange`` drives end to end.

Where the port differs: the reference runs the pack through
``dispatch.call`` (an executable cached per bucket); the port calls it
directly (``runtime/dispatch.py`` keeps no executable cache). The
pack reads its destination counts to the host once (the overflow check
and the trims need them there).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.ops.hash import partition_hash
from spark_rapids_jni_tpu_torch.ops.table_ops import _slice_rows, concatenate
from spark_rapids_jni_tpu_torch.parallel.shuffle import (
    _pack_send,
    _prepare,
    classify_overflow,
)
from spark_rapids_jni_tpu_torch.runtime import dispatch, faults, resilience
from spark_rapids_jni_tpu_torch.runtime.memory import (
    MemoryLimiter,
    SpillStore,
    table_nbytes,
)
from spark_rapids_jni_tpu_torch.telemetry import spans
from spark_rapids_jni_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_jni_tpu_torch.types import TypeId
from spark_rapids_jni_tpu_torch.utils.config import get_option
from spark_rapids_jni_tpu_torch.utils.log import get_logger
from spark_rapids_jni_tpu_torch.utils.tracing import func_range

__all__ = [
    "PackResult",
    "build_wire",
    "choose_parts",
    "exchange_local",
    "execute_exchange_root",
    "flight_slices",
    "merge_flights",
    "pack_flights",
    "partitioned_groupby",
    "partitioned_join",
    "recv_flight",
    "resolve_auto_parts",
    "send_flight",
    "send_flight_blob",
    "serialize_flight",
    "split_wire",
    "stats",
]

_log = get_logger(__name__)


class PackResult(NamedTuple):
    """One packed flight: ``parts * capacity`` destination-sorted rows;
    ``counts[p]`` is destination p's true row count (host int64), and
    p's rows are slots ``[p * capacity, p * capacity + counts[p])``."""

    table: Table
    counts: np.ndarray
    capacity: int


def _pack_columns(table: Table, plan) -> Table:
    """Every column laid out in send-buffer order; empty slots are null
    (and empty lists)."""
    occupied = plan.hit
    out = []
    for col in table.columns:
        valid = _pack_send(col.valid_mask(), plan) & occupied
        if col.dtype.is_string:
            if not col.is_padded_string:
                raise NotImplementedError(
                    "exchange pack needs string columns in the padded "
                    "device layout (ops.strings.pad_strings)")
            out.append(Column(col.dtype, _pack_send(col.data, plan), valid,
                              chars=_pack_send(col.chars, plan)))
            continue
        if col.dtype.type_id == TypeId.LIST:
            if not col.is_padded_list:
                raise NotImplementedError(
                    "exchange pack needs LIST columns in the padded wire "
                    "layout (ops.lists.pad_lists)")
            elem = col.children[0]
            lens = torch.where(occupied, _pack_send(col.data, plan),
                               torch.zeros((), dtype=col.data.dtype,
                                           device=col.data.device))
            ev = _pack_send(elem.validity, plan) & occupied[:, None]
            out.append(Column(col.dtype, lens, valid, children=[
                Column(elem.dtype, _pack_send(elem.data, plan), ev)]))
            continue
        if not (col.dtype.is_fixed_width or col.dtype.is_decimal128):
            raise NotImplementedError(
                "exchange pack supports fixed-width columns only (the "
                "shuffle shares this restriction)")
        out.append(Column(col.dtype, _pack_send(col.data, plan), valid))
    return Table(out)


def _pack_once(table: Table, keys: Sequence[int], parts: int,
               capacity: int) -> tuple[PackResult, bool]:
    parts, capacity = int(parts), int(capacity)
    part = partition_hash(table, [int(k) for k in keys], parts)
    plan, _ = _prepare(part, None, capacity, parts)
    counts = torch.bincount(part.to(torch.int64), minlength=parts)
    res = PackResult(_pack_columns(table, plan),
                     counts.cpu().numpy().astype(np.int64), capacity)
    return res, bool(res.counts.max(initial=0) > capacity)


@func_range("exchange_pack")
def pack_flights(table: Table, keys: Sequence[int], parts: int, *,
                 capacity: Optional[int] = None, op: str = "exchange",
                 cancel_token=None) -> list[PackResult]:
    """Pack ``table`` into per-destination send buffers: the spill-aware
    overflow ladder.

    Rung 1: geometric capacity escalation through ``resilience.escalate``
    (from ``ceil(n/parts) * 2`` quantized, or the caller's capacity),
    each overflow naming its exact requirement. Rung 2: at
    ``exchange.max_capacity_rows`` the pack demotes to chunked flights:
    the source is sliced into chunks of at most that many rows, each
    packed at a capacity no smaller than the chunk (so no chunk can
    overflow), and the receive side absorbs the extra flights
    (:func:`merge_flights`)."""
    if cancel_token is not None:
        cancel_token.check(op)
    n = table.num_rows
    parts = int(parts)
    if parts < 1:
        raise ValueError(f"{op}: parts must be >= 1, got {parts}")
    max_cap = max(1, dispatch.quantize_capacity(
        int(get_option("exchange.max_capacity_rows"))))
    if capacity is None:
        initial = dispatch.quantize_capacity(
            max(1, math.ceil(max(n, 1) / parts) * 2))
    else:
        initial = max(1, int(capacity))
    initial = min(initial, max_cap)
    tries = [0]

    def attempt(cap: int):
        # the seam of an injected pack failure (ordinal: the attempt)
        tries[0] += 1
        faults.fire("exchange.pack", tries[0], rows=n, capacity=cap, op=op)
        res, overflowed = _pack_once(table, keys, parts, cap)
        if overflowed:
            REGISTRY.counter("exchange.overflow_escalations").inc()
            telemetry.record_exchange(
                op, "overflow_escalate", rows=n, capacity=cap,
                partition=int(res.counts.argmax()),
                required=int(res.counts.max()))
            return None, True, int(res.counts.max())
        return res, False, None

    try:
        return [resilience.escalate(
            f"{op}.pack", attempt, seam="exchange.pack",
            initial=initial, max_capacity=max_cap,
            quantize=dispatch.quantize_capacity,
            exhaust=lambda cap, steps: classify_overflow(
                op=f"{op}.pack", capacity=cap, rows=n,
                seam="exchange.pack", steps=steps),
            rows=n)]
    except resilience.CapacityOverflow:
        # rung 2: a chunk's hottest destination receives at most the
        # chunk's rows, packed at a capacity >= the chunk's rows
        if cancel_token is not None:
            cancel_token.check(op)
        flights: list[PackResult] = []
        for lo in range(0, n, max_cap):
            chunk = _slice_rows(table, lo, min(lo + max_cap, n))
            cap = max(chunk.num_rows,
                      dispatch.quantize_capacity(chunk.num_rows))
            res, overflowed = _pack_once(chunk, keys, parts, cap)
            if overflowed:  # pragma: no cover - see the invariant above
                raise classify_overflow(
                    op=f"{op}.pack", capacity=cap, rows=chunk.num_rows,
                    seam="exchange.pack")
            flights.append(res)
        REGISTRY.counter("exchange.chunked_flights").inc()
        telemetry.record_exchange(
            op, "chunked_flights", rows=n, flights=len(flights),
            capacity=max_cap)
        _log.info("%s: demoted to %d chunked flights (max capacity %d)",
                  op, len(flights), max_cap)
        return flights


def flight_slices(res: PackResult) -> list[Table]:
    """Per-destination trim of one packed flight (plain slices)."""
    return [_slice_rows(res.table, p * res.capacity,
                        p * res.capacity + int(c))
            for p, c in enumerate(res.counts)]


def build_wire(flights: Sequence[PackResult]) -> tuple[Table, list]:
    """The cluster wire form: ONE table of the per-destination slices,
    flight-major then part-major, and the flat ``row_counts`` (length
    ``flights * parts``, plain Python) that invert it."""
    slices: list[Table] = []
    row_counts: list[int] = []
    for res in flights:
        for s in flight_slices(res):
            row_counts.append(int(s.num_rows))
            slices.append(s)
    nonempty = [s for s in slices if s.num_rows]
    if nonempty:
        wire = nonempty[0] if len(nonempty) == 1 else concatenate(nonempty)
    else:
        wire = _slice_rows(flights[0].table, 0, 0)
    return wire, row_counts


def split_wire(wire: Table, row_counts: Sequence[int],
               parts: int) -> list[list[Table]]:
    """Inverse of :func:`build_wire`: ``parts`` lists (by destination),
    each holding that destination's non-empty flights in flight
    order. Malformed counts are a classified ``MalformedInputError``."""
    parts = int(parts)
    if len(row_counts) % parts:
        raise resilience.MalformedInputError(
            f"exchange wire row_counts length {len(row_counts)} is not a "
            f"multiple of parts={parts}", seam="exchange.wire")
    per_dest: list[list[Table]] = [[] for _ in range(parts)]
    lo = 0
    for i, c in enumerate(row_counts):
        hi = lo + int(c)
        if hi > lo:
            per_dest[i % parts].append(_slice_rows(wire, lo, hi))
        lo = hi
    if lo != wire.num_rows:
        raise resilience.MalformedInputError(
            f"exchange wire table has {wire.num_rows} rows but row_counts "
            f"sum to {lo}", seam="exchange.wire")
    return per_dest


def choose_parts(plan_name: str, label: str, rows: int, *,
                 fallback: int = 1) -> int:
    """The partition count of an auto-parts (``parts=0``) Exchange, from
    the learned-selectivity store: the EMA of the fraction of the
    region's input rows that entered the exchange (its group density),
    times ``rows``, over ``exchange.target_rows_per_part``, at most
    ``exchange.max_parts``; no history falls back to ``fallback``.
    Every choice is recorded with its reason."""
    from spark_rapids_jni_tpu_torch.runtime import rtfilter

    rows = int(rows)
    ema = rtfilter.learned_pass_frac(plan_name, f"xparts.{label}")
    if ema is None:
        parts, reason = int(fallback), "no_history"
    else:
        target = max(1, int(get_option("exchange.target_rows_per_part")))
        est = max(1, int(rows * float(ema)))
        parts = max(1, min(int(get_option("exchange.max_parts")),
                           -(-est // target)))
        reason = "learned_density"
    REGISTRY.counter("exchange.parts_chosen").inc()
    telemetry.record_exchange(
        f"exchange.{label}", "parts_decision", parts=parts, rows=rows,
        reason=reason, pass_frac_ema=ema)
    return parts


def resolve_auto_parts(plan_name: str, node, bindings: dict):
    """An Exchange node with ``parts=0`` resolved to a concrete count
    (:func:`choose_parts` over the bound input rows); a concrete node
    comes back unchanged."""
    if int(node.parts) != 0:
        return node
    rows = sum(int(t.num_rows) for t in bindings.values())
    return node._replace(parts=choose_parts(plan_name, node.label, rows))


def execute_exchange_root(plan, bindings: dict, *, cancel_token=None):
    """Run a Plan rooted at an ``Exchange``: the child region through
    ``fusion.execute``, its padding trimmed by ``valid_meta`` (one host
    read), then the overflow ladder's pack. Returns the wire form with
    routing meta (``<label>.parts/.capacity/.flights/.row_counts/.rows``,
    plain Python) over the child's."""
    from spark_rapids_jni_tpu_torch.runtime import fusion, rtfilter

    root = resolve_auto_parts(plan.name, plan.root, bindings)
    inner = fusion.execute(fusion.Plan(plan.name, root.child), bindings,
                           cancel_token=cancel_token)
    tbl = inner.table
    if root.valid_meta is not None:
        if root.valid_meta not in inner.meta:
            raise KeyError(
                f"exchange {root.label!r}: valid_meta {root.valid_meta!r} "
                f"is not a child meta key (have {sorted(inner.meta)})")
        tbl = _slice_rows(tbl, 0, int(inner.meta[root.valid_meta]))
    rows = tbl.num_rows
    # the region's group density, which sizes later auto-parts exchanges
    rtfilter.observe(plan.name, f"xparts.{root.label}",
                     sum(int(t.num_rows) for t in bindings.values()), rows)
    cap = fusion._resolve(root.capacity,
                          {k: v.num_rows for k, v in bindings.items()})
    op = f"exchange.{root.label}"
    with spans.span(op, parts=int(root.parts), rows=rows):
        flights = pack_flights(tbl, root.keys, root.parts, capacity=cap,
                               op=op, cancel_token=cancel_token)
        wire, row_counts = build_wire(flights)
    REGISTRY.counter("exchange.rows_routed").inc(int(sum(row_counts)))
    telemetry.record_exchange(
        op, "pack", rows=rows, parts=int(root.parts),
        flights=len(flights), capacity=int(flights[0].capacity))
    meta = dict(inner.meta)
    meta[f"{root.label}.parts"] = int(root.parts)
    meta[f"{root.label}.capacity"] = int(flights[0].capacity)
    meta[f"{root.label}.flights"] = len(flights)
    meta[f"{root.label}.row_counts"] = [int(c) for c in row_counts]
    meta[f"{root.label}.rows"] = int(rows)
    return fusion.FusedResult(wire, meta)


@func_range("exchange_local")
def exchange_local(table: Table, keys: Sequence[int], parts: int, *,
                   capacity: Optional[int] = None,
                   op: str = "exchange.local") -> list[Table]:
    """The exchange within one process, the oracle of the distributed
    one: ``parts`` tables, destination p holding the rows whose key
    hash lands on p, in (flight, input) order."""
    flights = pack_flights(table, keys, parts, capacity=capacity, op=op)
    per_dest: list[list[Table]] = [[] for _ in range(int(parts))]
    for res in flights:
        for p, s in enumerate(flight_slices(res)):
            if s.num_rows:
                per_dest[p].append(s)
    empty = _slice_rows(flights[0].table, 0, 0)
    return [ds[0] if len(ds) == 1 else (concatenate(ds) if ds else empty)
            for ds in per_dest]


def merge_flights(flights: Sequence[Table],
                  partial_fn: Callable[[Table], Table],
                  merge_fn: Callable[[Table], Table], *,
                  budget_bytes: Optional[int] = None,
                  limiter: Optional[MemoryLimiter] = None,
                  spill: Optional[SpillStore] = None,
                  op: str = "exchange.merge", cancel_token=None):
    """The receive side's spill-aware merge: a destination's flights
    stream through ``outofcore.run_chunked_aggregate`` under a device
    budget (``exchange.merge_budget_bytes``), partials demoting into the
    SpillStore past it; no reservation outlives the call. Returns the
    ``OutOfCoreResult``."""
    from spark_rapids_jni_tpu_torch.runtime import outofcore

    flights = list(flights)
    if not flights:
        raise ValueError(f"{op}: no flights to merge")
    budget = int(budget_bytes if budget_bytes is not None
                 else get_option("exchange.merge_budget_bytes"))
    if limiter is None:
        limiter = MemoryLimiter(budget)
    if spill is None:
        spill = SpillStore(budget)
    res = outofcore.run_chunked_aggregate(
        flights, partial_fn, merge_fn, limiter=limiter, spill=spill,
        cancel_token=cancel_token)
    spilled = int(res.spill_stats.get("spills", 0))
    if spilled:
        REGISTRY.counter("exchange.spill_demotions").inc(spilled)
        telemetry.record_exchange(
            op, "spill_demote", spilled=spilled, chunks=res.chunks,
            peak_bytes=res.peak_bytes)
    telemetry.record_exchange(op, "merge", rows=res.table.num_rows,
                              chunks=res.chunks, peak_bytes=res.peak_bytes)
    return res


def serialize_flight(table: Table, *,
                     op: str = "exchange.serialize_flight", **ctx) -> bytes:
    """One flight's wire frame (``dcn.serialize_table``), counted once
    at first seal: ``exchange.flights`` / ``bytes_raw`` / ``bytes_wire``
    count unique payloads, so a refetch or a re-send on another lane
    never counts twice (the lanes are :func:`send_flight_blob`'s)."""
    from spark_rapids_jni_tpu_torch.parallel import dcn

    blob = dcn.serialize_table(table)
    raw = int(table_nbytes(table))
    REGISTRY.counter("exchange.flights").inc()
    REGISTRY.counter("exchange.bytes_raw").inc(raw)
    REGISTRY.counter("exchange.bytes_wire").inc(len(blob))
    telemetry.record_exchange(op, "flight", rows=table.num_rows,
                              wire_bytes=len(blob), raw_bytes=raw, **ctx)
    return blob


def send_flight_blob(sock, blob: bytes, seq: int, *,
                     lane: str = "direct",
                     op: str = "exchange.send_flight", **ctx) -> int:
    """Ship one serialized flight through ``dcn.send_framed`` with
    corruption scoped to ``exchange.wire``. ``lane`` is the path the
    bytes took, ``"direct"`` (host to host) or ``"routed"`` (through the
    supervisor): ``exchange.bytes_direct`` / ``bytes_routed``."""
    from spark_rapids_jni_tpu_torch.parallel import dcn

    lane = str(lane)
    if lane not in ("direct", "routed"):
        raise ValueError(f"exchange flight lane must be 'direct' or "
                         f"'routed', got {lane!r}")
    REGISTRY.counter(f"exchange.bytes_{lane}").inc(len(blob))
    return dcn.send_framed(sock, blob, seq, op=op,
                           corrupt_seam="exchange.wire", lane=lane, **ctx)


def send_flight(sock, table: Table, seq: int, *, lane: str = "direct",
                op: str = "exchange.send_flight", **ctx) -> int:
    """:func:`serialize_flight` then :func:`send_flight_blob`."""
    blob = serialize_flight(table, op=op, **ctx)
    return send_flight_blob(sock, blob, seq, lane=lane, op=op,
                            rows=table.num_rows, **ctx)


def recv_flight(sock, seq: int, *, op: str = "exchange.recv_flight",
                device=None) -> Table:
    """Receive one flight, verified before it is decoded (onto
    ``device``; None: the card)."""
    from spark_rapids_jni_tpu_torch.parallel import dcn

    return dcn.deserialize_table(dcn.recv_framed(sock, seq, op=op),
                                 device=device)


@func_range("partitioned_groupby")
def partitioned_groupby(table: Table, keys: Sequence[int],
                        aggs: Sequence[tuple], *, parts: int,
                        capacity: Optional[int] = None) -> Table:
    """Hash-partitioned groupby with no slot table: exchange by key
    hash, then the unbounded groupby per partition (one host read of its
    group count). Keys are disjoint across partitions, so the
    concatenation is the result (partition-major, key-sorted within)."""
    from spark_rapids_jni_tpu_torch.ops.groupby import groupby_aggregate

    out: list[Table] = []
    for dest in exchange_local(table, keys, parts, capacity=capacity):
        if not dest.num_rows:
            continue
        g = groupby_aggregate(dest, list(keys), list(aggs), max_groups=None)
        out.append(_slice_rows(g.table, 0, int(g.num_groups)))
    if not out:
        g = groupby_aggregate(table, list(keys), list(aggs), max_groups=None)
        return _slice_rows(g.table, 0, 0)
    return out[0] if len(out) == 1 else concatenate(out)


@func_range("partitioned_join")
def partitioned_join(left: Table, right: Table, left_on, right_on, *,
                     parts: int, how: str = "inner") -> Table:
    """Hash-partitioned equi-join: both sides co-partitioned by the same
    key hash, ``join_auto`` per partition (the probe kernel), the
    matches of each (``maps.total`` rows) concatenated."""
    from spark_rapids_jni_tpu_torch.ops.join import join_auto

    lks = [left_on] if isinstance(left_on, int) else list(left_on)
    rks = [right_on] if isinstance(right_on, int) else list(right_on)
    ldests = exchange_local(left, lks, parts, op="exchange.join_left")
    rdests = exchange_local(right, rks, parts, op="exchange.join_right")
    out: list[Table] = []
    for ld, rd in zip(ldests, rdests):
        if not ld.num_rows:
            continue
        if not rd.num_rows and how == "inner":
            continue
        maps, joined = join_auto(ld, rd, left_on, right_on, how=how)
        joined = _slice_rows(joined, 0, int(maps.total))
        if joined.num_rows:
            out.append(joined)
    if not out:
        maps, joined = join_auto(left, right, left_on, right_on, how=how)
        return _slice_rows(joined, 0, 0)
    return out[0] if len(out) == 1 else concatenate(out)


def stats() -> dict:
    """The ``exchange.*`` transport counters: rows routed, flights, raw
    and wire bytes, the direct and routed lanes, escalations, chunked
    flights, spill demotions."""
    c = REGISTRY.counters("exchange.")
    return {
        "rows_routed": c.get("exchange.rows_routed", 0),
        "flights": c.get("exchange.flights", 0),
        "bytes_raw": c.get("exchange.bytes_raw", 0),
        "bytes_wire": c.get("exchange.bytes_wire", 0),
        "bytes_direct": c.get("exchange.bytes_direct", 0),
        "bytes_routed": c.get("exchange.bytes_routed", 0),
        "overflow_escalations": c.get("exchange.overflow_escalations", 0),
        "chunked_flights": c.get("exchange.chunked_flights", 0),
        "spill_demotions": c.get("exchange.spill_demotions", 0),
    }
