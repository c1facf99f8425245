"""Distributed operators (counterpart of ``spark_rapids_jni_tpu/parallel/
distributed.py``): shard tables over the executor mesh and run
shuffle-backed relational operators across it.

Each executor owns a partition of rows and runs the same operator
pipeline; the only inter-executor steps are the collectives of
:class:`~.mesh.ExecutorMesh` (the all-to-all of ``parallel/shuffle.py``
and the slot-table reductions). A sharded table is the list of the
per-executor ``Table``\\ s this process holds (all of them on the local
transport, its rank's alone in a process group), with each one's
``row_valid``. Where the reference runs a step inside ``jax.shard_map``,
the port runs it bulk-synchronously: each local stage a loop over the
executors, each collective a mesh method; the reference's function names
stay, and every function takes the mesh and the per-executor lists.

Phantom rows (unoccupied shuffle slots) carry null keys and null values,
so aggregates skip them by construction; their only observable artifact
is a possible all-null key group in the padded output, which callers
discard as they discard a local groupby's padding.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch

from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.ops.groupby import groupby_aggregate
from spark_rapids_jni_tpu_torch.ops.sort import gather
from spark_rapids_jni_tpu_torch.parallel.shuffle import hash_shuffle
from spark_rapids_jni_tpu_torch.utils.tracing import func_range

__all__ = [
    "head_table", "shard_table", "shard_table_multiprocess", "collect",
    "global_table", "any_executor", "DistributedGroupBy",
    "distributed_groupby_aggregate", "DistributedBoundedGroupBy",
    "distributed_groupby_bounded", "distributed_groupby_percentile",
    "DistributedWindow", "distributed_window", "DistributedJoin",
    "distributed_join", "DistributedCollectList",
    "distributed_groupby_collect", "table_to",
]


def head_table(table: Table, k: int) -> Table:
    """First k rows — groupby outputs put real groups first."""
    cols = []
    for c in table.columns:
        if c.dtype.is_string and not c.is_padded_string:
            raise NotImplementedError(
                "head_table needs string columns in the padded device layout "
                "(ops.strings.pad_strings); Arrow offsets cannot be sliced "
                "like row data")
        validity = None if c.validity is None else c.validity[:k]
        chars = c.chars[:k] if c.is_padded_string else None
        cols.append(Column(c.dtype, c.data[:k], validity, chars=chars))
    return Table(cols)


def _padded_rows(x: torch.Tensor, lo: int, hi: int, rows: int,
                 device) -> torch.Tensor:
    """Rows [lo, hi) of ``x`` followed by zero rows up to ``rows``, on
    ``device`` (a view when nothing is padded and the device is x's)."""
    part = x[lo:hi]
    if hi - lo < rows:
        pad = torch.zeros((rows - (hi - lo),) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        part = torch.cat([part, pad])
    return part.to(device)


def _sharded_column(c: Column) -> Column:
    if c.dtype.is_string:
        from spark_rapids_jni_tpu_torch.ops.strings import pad_strings

        return pad_strings(c)
    if not (c.dtype.is_fixed_width or c.dtype.is_decimal128):
        raise NotImplementedError(
            "shard_table: fixed-width and string columns only")
    return c


def shard_table(table: Table, mesh, return_row_valid: bool = False):
    """Distribute a table row-wise across the mesh's executors: a list
    of per-executor tables, each of ``ceil(n/D)`` rows (rows split
    contiguously, the last executors padded with null rows, as the
    reference's sharded array splits), on each executor's device. With
    ``return_row_valid=True`` also the per-executor bool masks marking
    real rows — needed where a padding row is not a null-key row (left
    joins emit unmatched null-key rows but must not emit padding).

    In a process group ``table`` is this rank's own rows and the call is
    :func:`shard_table_multiprocess` (every row real)."""
    if mesh.group is not None:
        out = shard_table_multiprocess(table, mesh)
        if not return_row_valid:
            return out
        rv = torch.ones((out[0].num_rows,), dtype=torch.bool,
                        device=mesh.local_devices[0])
        return out, [rv]
    d = mesh.size
    n = table.num_rows
    per = -(-n // d) if n else 0
    cols = [_sharded_column(c) for c in table.columns]
    shards, valids = [], []
    for e, dev in enumerate(mesh.devices):
        lo, hi = min(e * per, n), min((e + 1) * per, n)
        out = []
        for c in cols:
            valid = _padded_rows(c.valid_mask(), lo, hi, per, dev)
            data = _padded_rows(c.data, lo, hi, per, dev)
            chars = (_padded_rows(c.chars, lo, hi, per, dev)
                     if c.dtype.is_string else None)
            out.append(Column(c.dtype, data, valid, chars=chars))
        shards.append(Table(out))
        valids.append(torch.arange(per, device=dev) < (hi - lo))
    if not return_row_valid:
        return shards
    return shards, valids


def shard_table_multiprocess(local: Table, mesh) -> list:
    """Process-group form of :func:`shard_table`: every rank contributes
    its own row chunk and holds it as its executor's table (a one-entry
    list, on its device). Every rank must call this collectively with
    the SAME number of rows (checked with an all-gather, so a mismatch
    fails loudly instead of hanging in the next collective); string
    columns are padded to the GLOBAL widest row (also all-gathered), so
    every rank's exchange has the same shape."""
    dev = mesh.local_devices[0]
    counts = mesh.all_gather([torch.tensor(
        [local.num_rows], dtype=torch.int64, device=dev)])[0].reshape(-1)
    if not bool((counts == local.num_rows).all()):
        raise ValueError(
            f"shard_table_multiprocess needs the SAME row count in every "
            f"process (static shapes); got per-process counts "
            f"{counts.tolist()} — pad with null rows to a common size "
            f"first")
    out = []
    for c in local.columns:
        c = _sharded_column(c)
        chars = None
        if c.dtype.is_string:
            local_w = int(c.chars.shape[1])
            widths = mesh.all_gather([torch.tensor(
                [local_w], dtype=torch.int64, device=dev)])[0]
            target_w = int(widths.max())
            chars = torch.nn.functional.pad(
                c.chars, (0, target_w - local_w)).to(dev)
        out.append(Column(c.dtype, c.data.to(dev), c.valid_mask().to(dev),
                          chars=chars))
    return [Table(out)]


def any_executor(mesh, flags) -> bool:
    """True when any executor's flag is set — across every rank of a
    process group too, so all ranks take the same branch after it."""
    dev = mesh.local_devices[0]
    local = torch.stack([torch.as_tensor(f, device=dev).any()
                         for f in flags]).any().to(torch.int32).reshape(1)
    if mesh.group is None:
        return bool(local)
    return bool(mesh.pmax([local])[0])


def global_table(mesh, tables: Sequence[Table]) -> Table:
    """The executors' tables concatenated in executor order on this
    process's first device: the reference's sharded array seen whole
    (a process group all-gathers every rank's table)."""
    tables = list(tables)
    dev = mesh.local_devices[0]
    if mesh.group is None:
        from spark_rapids_jni_tpu_torch.ops.strings import pad_to_common_width

        cols = []
        for i, c in enumerate(tables[0].columns):
            parts = [t.column(i) for t in tables]
            if c.dtype.is_string:
                parts = pad_to_common_width(parts)
            data = torch.cat([p.data.to(dev) for p in parts])
            valid = torch.cat([p.valid_mask().to(dev) for p in parts])
            chars = (torch.cat([p.chars.to(dev) for p in parts])
                     if c.dtype.is_string else None)
            cols.append(Column(c.dtype, data, valid, chars=chars))
        return Table(cols)

    def gathered(x):
        g = mesh.all_gather([x])[0]
        return g.reshape((-1,) + tuple(g.shape[2:]))

    return Table([
        Column(c.dtype, gathered(c.data), gathered(c.valid_mask()),
               chars=gathered(c.chars) if c.dtype.is_string else None)
        for c in tables[0].columns])


def _counts(mesh, num_rows_per_device) -> torch.Tensor:
    """Per-executor counts as one int64[D] tensor on the first device."""
    dev = mesh.local_devices[0]
    local = torch.stack([torch.as_tensor(c, device=dev).reshape(())
                         .to(torch.int64) for c in num_rows_per_device])
    if mesh.group is None:
        return local
    return mesh.all_gather([local])[0].reshape(-1)


class DistributedGroupBy(NamedTuple):
    table: list              # per-executor padded results
    num_groups: list         # per-executor 0-d group counts
    overflowed: list         # per-executor shuffle capacity overflow
    # per-executor DECIMAL128 SUM 128-bit overflow (the group is nulled
    # locally; this flag tells an overflowed group from an all-null one)
    sum_overflow: list


@func_range("distributed_groupby_aggregate")
def distributed_groupby_aggregate(
    table: Sequence[Table],
    keys: Sequence[int],
    aggs: Sequence[tuple[int, str]],
    mesh,
    capacity: Optional[int] = None,
) -> DistributedGroupBy:
    """Global groupby: shuffle rows by key hash, then one local groupby
    per executor. After the exchange each executor owns a disjoint key
    range, so the per-executor results ARE the global answer,
    partitioned. ``table`` is the sharded table (:func:`shard_table`)."""
    aggs = list(aggs)
    return _distributed_groupby(
        table, list(keys), mesh, capacity,
        lambda sh_tbl, ks: groupby_aggregate(sh_tbl, ks, aggs))


class DistributedBoundedGroupBy(NamedTuple):
    """Replicated global result of the shuffle-free bounded plan: the
    same m-slot table on every executor (this is the first held
    executor's copy)."""

    table: Table
    present: torch.Tensor      # bool[m]: some row anywhere hit the slot
    domain_miss: torch.Tensor  # 0-d bool: any executor saw an OOD key


@func_range("distributed_groupby_bounded")
def distributed_groupby_bounded(
    table: Sequence[Table],
    keys: Sequence[int],
    aggs: Sequence[tuple[int, str]],
    domains: Sequence,
    mesh,
    budget: int = 4096,
    row_valid: Optional[Sequence[torch.Tensor]] = None,
) -> DistributedBoundedGroupBy:
    """SHUFFLE-FREE distributed groupby for planner-bounded keys.

    The bounded plan's output is a static slot table (one row per domain
    combination) whose sum/count/min/max aggregates are associative per
    slot, so the cross-executor merge is one reduction over the m-row
    partials (psum / pmin / pmax), never a row shuffle. Each executor's
    partial is kernel A's one accumulate (``plan_groupby``'s bounded
    lowering).

    Scope: sum/count/min/max (mean decomposes to sum+count); no
    DECIMAL128 aggregate columns (limb-pair sums have no carry merge —
    use the shuffle path). String keys are fine."""
    from spark_rapids_jni_tpu_torch.ops.groupby import minmax_sentinel
    from spark_rapids_jni_tpu_torch.ops.planner import plan_groupby

    tables = list(table)
    aggs = list(aggs)
    for _, op in aggs:
        if op not in ("sum", "count", "min", "max"):
            raise ValueError(
                f"distributed bounded groupby supports sum/count/min/max "
                f"(decompose mean to sum+count), not {op!r}")
    for col_idx, _ in aggs:
        if tables[0].column(col_idx).dtype.is_decimal128:
            raise NotImplementedError(
                "DECIMAL128 aggregates need carry-aware merges — use "
                "distributed_groupby_aggregate")
    # checked eagerly (NOT an assert: an unbounded plan summed across
    # executors would add rows of DIFFERENT keys, silently wrong)
    domains = list(domains)
    if any(d is None for d in domains):
        raise ValueError(
            "every key needs a declared Domain for the shuffle-free "
            "bounded plan; use distributed_groupby_aggregate otherwise")
    slots = math.prod(len(d.values) + 1 for d in domains)
    if slots > budget:
        raise ValueError(
            f"domain cross product ({slots} slots) exceeds the bounded "
            f"budget ({budget}); use distributed_groupby_aggregate")
    nk = len(keys)
    rvs = ([torch.ones((t.num_rows,), dtype=torch.bool, device=t.columns[0]
                       .device) for t in tables]
           if row_valid is None else list(row_valid))
    res = [plan_groupby(t, list(keys), aggs, domains, budget=budget,
                        row_valid=rv) for t, rv in zip(tables, rvs)]
    if any(r.lowered != "bounded" for r in res):
        raise RuntimeError("the bounded lowering was refused")

    def flag(xs):
        return mesh.psum([x.to(torch.int32) for x in xs])[0] > 0

    present = flag([r.present for r in res])
    miss = flag([r.domain_miss.reshape(1) for r in res])[0]
    out_cols: list[Column] = []
    for pos, c in enumerate(res[0].table.columns):
        valid = flag([r.table.column(pos).valid_mask() for r in res])
        if pos < nk:
            # key data is static, identical on every executor: only the
            # validity combines
            out_cols.append(Column(c.dtype, c.data, valid, chars=c.chars))
            continue
        op = aggs[pos - nk][1]
        cols = [r.table.column(pos) for r in res]
        if op in ("sum", "count"):
            # absent slots hold the 0 neutral already
            data = mesh.psum([x.data for x in cols])[0]
        else:
            sentinel = minmax_sentinel(c.dtype, op)
            guarded = [torch.where(
                x.valid_mask(), x.data,
                torch.full((), sentinel, dtype=x.data.dtype,
                           device=x.device)) for x in cols]
            data = (mesh.pmin(guarded) if op == "min"
                    else mesh.pmax(guarded))[0]
        out_cols.append(Column(c.dtype, data, valid))
    return DistributedBoundedGroupBy(Table(out_cols), present, miss)


def _shuffle_retry_capacity(table: Sequence[Table], mesh,
                            capacity: Optional[int]) -> int:
    """Capacity for the overflow retry: double the EFFECTIVE per-executor
    slot count (the shuffle's derived default when the caller passed
    None) and re-quantize through the dispatch bucket schedule."""
    from spark_rapids_jni_tpu_torch.runtime import dispatch

    if capacity is None:
        d = mesh.size
        n_local = max(1, list(table)[0].num_rows)
        capacity = dispatch.quantize_capacity(
            max(1, math.ceil(n_local / d) * 2))
    return dispatch.quantize_capacity(max(int(capacity), 1) * 2)


def _distributed_groupby(table, keys, mesh, capacity, local_groupby):
    """Shared shuffle-then-local-groupby scaffold: hash-exchange rows so
    each executor owns whole key groups, run ``local_groupby(shuffled,
    keys)`` per executor, and pack the per-executor results.

    Shuffle capacity overflow recovers here: the flags are read on the
    host after the exchange (every rank reads all of them), where a
    bigger capacity can be chosen. Escalation is bounded geometric
    through the shared resilience policy, the final allowed attempt
    jumping to the quantized global row count (always sufficient); still
    overflowing there, or past ``resilience.max_attempts``, raises a
    classified ``FatalExecutionError``. ``resilience.enabled=false``
    turns off only the replay of transient faults: the capacity ladder
    runs either way. Each attempt fires the ``shuffle.transport`` seam."""
    from spark_rapids_jni_tpu_torch.runtime import dispatch, faults, resilience

    tables = list(table)
    rows = sum(t.num_rows for t in tables) * (
        1 if mesh.group is None else mesh.size)

    def run(cap):
        shuffled = hash_shuffle(mesh, tables, keys, capacity=cap)
        out = [local_groupby(sh.table, keys) for sh in shuffled]
        return DistributedGroupBy(
            [r.table for r in out], [r.num_groups for r in out],
            [sh.overflowed for sh in shuffled],
            [r.sum_overflow for r in out])

    pol = resilience.policy()
    max_cap = dispatch.quantize_capacity(max(rows, 1))
    cap = capacity  # None on attempt 1: the shuffle derives it

    def _run(c):
        faults.fire("shuffle.transport", 0, rows=rows)
        return run(c)

    attempt = 1
    while True:
        res = resilience.retrying(
            "distributed_groupby", lambda: _run(cap),
            seam="shuffle.transport", pol=pol, rows=rows)
        if not any_executor(mesh, res.overflowed):
            if attempt > 1:
                telemetry.record_resilience(
                    "distributed_groupby", "recovered",
                    seam="shuffle.transport", attempt=attempt,
                    rung="grow_capacity", rows=rows)
            return res
        at_max = cap is not None and int(cap) >= max_cap
        if attempt >= pol.max_attempts or at_max:
            telemetry.record_resilience(
                "distributed_groupby", "fatal", seam="shuffle.transport",
                attempt=attempt, rung="grow_capacity", rows=rows)
            raise resilience.FatalExecutionError(
                "distributed_groupby: shuffle capacity escalation "
                "exhausted with the overflow flag still set",
                rows=rows,
                capacity=int(cap) if cap is not None else "derived",
                max_capacity=max_cap, attempts=attempt)
        # the final allowed attempt jumps straight to the quantized row
        # count (always sufficient); earlier steps double and quantize
        if attempt + 1 >= pol.max_attempts:
            retry_cap = max_cap
        else:
            retry_cap = min(_shuffle_retry_capacity(tables, mesh, cap),
                            max_cap)
        telemetry.record_fallback(
            "distributed_groupby",
            "shuffle capacity overflow: a device received more rows than "
            "its send-buffer slots; escalating quantized capacity",
            rows=rows, retry_capacity=retry_cap)
        telemetry.record_resilience(
            "distributed_groupby", "escalate", seam="shuffle.transport",
            attempt=attempt, rung="grow_capacity", rows=rows,
            capacity=retry_cap)
        cap = retry_cap
        attempt += 1


def distributed_groupby_percentile(
    table: Sequence[Table],
    keys: Sequence[int],
    value_col: int,
    qs: Sequence[float],
    mesh,
    capacity: Optional[int] = None,
) -> DistributedGroupBy:
    """Global exact percentiles: shuffle rows by key hash (whole groups
    co-locate), then one local sort-based ``groupby_percentile`` per
    executor: order statistics are group-local, so co-location makes the
    per-executor answers globally exact."""
    from spark_rapids_jni_tpu_torch.ops.groupby import groupby_percentile

    qs = [float(q) for q in qs]
    return _distributed_groupby(
        table, list(keys), mesh, capacity,
        lambda sh_tbl, ks: groupby_percentile(sh_tbl, ks, value_col, qs))


def _compact_to_front(table: Table, counts: torch.Tensor) -> Table:
    """Compaction of a per-executor-padded global table: every executor's
    first counts[i] rows gathered into a contiguous prefix, one
    searchsorted-driven gather. Rows past the real total are repeats of
    row 0 — the caller slices them off."""
    d = counts.shape[0]
    n = table.num_rows
    per_dev = n // d
    device = counts.device
    off = torch.cat([torch.zeros((1,), dtype=torch.int64, device=device),
                     torch.cumsum(counts.to(torch.int64), 0)])
    j = torch.arange(n, dtype=torch.int64, device=device)
    dev = torch.searchsorted(off[1:], j, right=True).clamp(0, d - 1)
    src = dev * per_dev + (j - off[dev])
    src = torch.where(j < off[-1], src, 0)
    return gather(table, src)


def collect(table: Sequence[Table], num_rows_per_device, mesh) -> Table:
    """Driver-side collect of a per-executor-padded result into one
    compact table on this process's first device: the executors'
    first ``num_rows_per_device[i]`` rows, in executor order. On the
    local transport each executor's real rows are sliced first, so only
    they move; a process group gathers every rank's padded table and
    compacts it with :func:`_compact_to_front`, the reference's one
    gather (every rank gets the whole result). String columns come back
    in the Arrow layout."""
    from spark_rapids_jni_tpu_torch.ops.strings import unpad_strings

    counts = _counts(mesh, num_rows_per_device)
    d = mesh.size
    if counts.shape[0] != d:
        raise ValueError(
            f"collect: {counts.shape[0]} per-device counts for a "
            f"{d}-device mesh")
    total = int(counts.sum())
    if mesh.group is None:
        compacted = global_table(mesh, [
            head_table(t, int(k)) for t, k in zip(table, counts.tolist())])
    else:
        compacted = _compact_to_front(global_table(mesh, table), counts)
    out = []
    for c in compacted.columns:
        valid = c.valid_mask()[:total]
        if c.dtype.is_string:
            s = unpad_strings(Column(c.dtype, c.data[:total], valid,
                                     chars=c.chars[:total]))
            nbytes = int(s.data[-1])
            if nbytes > torch.iinfo(torch.int32).max:
                raise ValueError(
                    f"collected string column holds {nbytes} bytes, over "
                    "the int32 Arrow offset bound (2^31-1); collect in "
                    "batches")
            out.append(Column(c.dtype, s.data, valid,
                              chars=s.chars[:nbytes].clone()))
            continue
        out.append(Column(c.dtype, c.data[:total], valid))
    return Table(out)


class DistributedWindow(NamedTuple):
    table: list        # per-executor shuffled input rows (padded)
    results: list      # per-executor tables: one column per window spec,
    #                    aligned row for row with ``table``
    row_valid: list    # per-executor bool[D*capacity]: slot holds a row
    overflowed: list   # per-executor shuffle capacity overflow


def _window_columns(w, specs) -> list:
    out_cols = []
    for spec in specs:
        kind = spec[0]
        if kind in ("row_number", "rank", "dense_rank", "percent_rank",
                    "cume_dist"):
            out_cols.append(getattr(w, kind)())
        elif kind in ("lag", "lead"):
            out_cols.append(getattr(w, kind)(spec[1] + 1, spec[2]))
        elif kind in ("running_sum", "running_min", "running_max",
                      "first_value", "last_value"):
            out_cols.append(getattr(w, kind)(spec[1] + 1))
        elif kind == "nth_value":
            out_cols.append(w.nth_value(spec[1] + 1, spec[2]))
        elif kind == "ntile":
            out_cols.append(w.ntile(spec[1]))
        elif kind in ("rolling_sum", "rolling_count", "rolling_mean",
                      "rolling_min", "rolling_max"):
            out_cols.append(getattr(w, kind)(spec[1] + 1, spec[2], spec[3]))
        elif kind in ("rolling_sum_range", "rolling_count_range",
                      "rolling_mean_range", "rolling_min_range",
                      "rolling_max_range"):
            out_cols.append(getattr(w, kind[:-6])(
                spec[1] + 1, spec[2], spec[3], frame="range"))
        elif kind in ("rolling_var", "rolling_std"):
            # optional trailing ddof (default 1 = sample)
            out_cols.append(getattr(w, kind)(
                spec[1] + 1, spec[2], spec[3],
                spec[4] if len(spec) > 4 else 1))
        else:
            raise ValueError(f"unknown window spec {spec!r}")
    return out_cols


@func_range("distributed_window")
def distributed_window(
    table: Sequence[Table],
    partition_by: Sequence[int],
    order_by: Sequence[int],
    specs: Sequence,
    mesh,
    row_valid: Sequence[torch.Tensor],
    capacity: Optional[int] = None,
) -> DistributedWindow:
    """Global window functions: shuffle rows by partition-key hash so
    each executor owns whole partitions, then evaluate partition-local
    windows. ``specs`` are the reference's static tuples
    (``("row_number",)``, ``("lag", col, k)``, ``("rolling_sum", col,
    preceding, following)``, ``("rolling_max_range", ...)``, ...).
    Results come back per executor, aligned to the shuffled rows; filter
    them by the returned ``row_valid``.

    ``row_valid`` is REQUIRED (``shard_table(..., return_row_valid=
    True)``): window functions give null-key rows real results, so a
    padding row taken for a real row would pollute the genuine null-key
    partition. Phantom shuffle slots are kept out of every real partition
    by a leading occupancy pseudo-key."""
    from spark_rapids_jni_tpu_torch import types as t_
    from spark_rapids_jni_tpu_torch.ops.window import Window

    pkeys = list(partition_by)
    okeys = list(order_by)
    specs = [tuple(s) for s in specs]
    shuffled = hash_shuffle(mesh, list(table), pkeys, capacity=capacity,
                            row_valid=list(row_valid))
    results = []
    for sh in shuffled:
        occ = Column(t_.INT8, (~sh.row_valid).to(torch.int8))
        wtbl = Table([occ] + list(sh.table.columns))
        w = Window(wtbl, partition_by=[0] + [k + 1 for k in pkeys],
                   order_by=[k + 1 for k in okeys])
        results.append(Table(_window_columns(w, specs)))
    return DistributedWindow([sh.table for sh in shuffled], results,
                             [sh.row_valid for sh in shuffled],
                             [sh.overflowed for sh in shuffled])


class DistributedJoin(NamedTuple):
    table: list        # per-executor joined rows (padded)
    total: list        # per-executor 0-d true match counts
    overflowed: list   # per-executor shuffle capacity overflow


@func_range("distributed_join")
def distributed_join(
    left: Sequence[Table],
    right: Sequence[Table],
    left_on: int | Sequence[int],
    right_on: int | Sequence[int],
    mesh,
    out_size_per_device: int,
    how: str = "inner",
    left_capacity: Optional[int] = None,
    right_capacity: Optional[int] = None,
    left_row_valid: Optional[Sequence[torch.Tensor]] = None,
    right_row_valid: Optional[Sequence[torch.Tensor]] = None,
) -> DistributedJoin:
    """Repartitioned equi-join: both sides exchange rows by key hash,
    after which equal keys live on one executor, and an executor-local
    join finishes (``ops/join.py``: kernel D once per executor on the
    card). Routing is identical for both sides because
    ``partition_hash`` depends only on the key value and its storage
    type. Pass the ``row_valid`` masks of ``shard_table(...,
    return_row_valid=True)`` so padding rows drop before the exchange:
    under a left join a padding row would otherwise emit output. The
    exchange fires the ``shuffle.transport`` seam, and a transient fault
    there replays the (idempotent) step."""
    from spark_rapids_jni_tpu_torch.ops.join import apply_join_maps, join
    from spark_rapids_jni_tpu_torch.runtime import faults, resilience

    lefts, rights = list(left), list(right)
    left_keys = [left_on] if isinstance(left_on, int) else list(left_on)
    right_keys = [right_on] if isinstance(right_on, int) else list(right_on)

    def ones(tables):
        return [torch.ones((t.num_rows,), dtype=torch.bool,
                           device=t.columns[0].device) for t in tables]

    lrv = ones(lefts) if left_row_valid is None else list(left_row_valid)
    rrv = ones(rights) if right_row_valid is None else list(right_row_valid)
    rows = sum(t.num_rows for t in lefts) + sum(t.num_rows for t in rights)

    def _exchange():
        faults.fire("shuffle.transport", 0, rows=rows)
        ls = hash_shuffle(mesh, lefts, left_keys, capacity=left_capacity,
                          row_valid=lrv)
        rs = hash_shuffle(mesh, rights, right_keys, capacity=right_capacity,
                          row_valid=rrv)
        out, totals, overflowed = [], [], []
        for e in range(len(ls)):
            lse, rse = ls[e], rs[e]
            ls[e] = rs[e] = None  # each executor's inputs freed after use
            # phantom (unoccupied) slots must not emit outer-join rows
            maps = join(lse.table, rse.table, left_keys, right_keys,
                        out_size_per_device, how=how,
                        left_row_valid=lse.row_valid,
                        right_row_valid=rse.row_valid)
            out.append(apply_join_maps(lse.table, rse.table, maps))
            totals.append(maps.total)
            overflowed.append(lse.overflowed | rse.overflowed)
        return DistributedJoin(out, totals, overflowed)

    return resilience.retrying("distributed_join", _exchange,
                               seam="shuffle.transport", rows=rows)


class DistributedCollectList(NamedTuple):
    table: Table       # keys then one LIST column, assembled
    overflowed: list   # per-executor shuffle capacity overflow


@func_range("distributed_groupby_collect")
def distributed_groupby_collect(
    table: Sequence[Table],
    keys: Sequence[int],
    value_col: int,
    mesh,
    capacity: int,
    distinct: bool = False,
) -> DistributedCollectList:
    """Global collect_list / collect_set: hash-shuffle rows so whole key
    groups co-locate (the shared scaffold), one local ``groupby_collect``
    per executor, then the per-executor LIST results trimmed and
    concatenated in executor order (the LIST analogue of
    :func:`collect`; in a process group each rank assembles its own
    executor's groups). Shard padding rows surface as one all-null-key
    group (with an empty list) that callers discard."""
    from spark_rapids_jni_tpu_torch.ops.groupby import GroupByResult
    from spark_rapids_jni_tpu_torch.ops.lists import groupby_collect
    from spark_rapids_jni_tpu_torch.ops.table_ops import (
        concatenate,
        trim_table,
    )

    def local_collect(sh_tbl: Table, kss):
        res = groupby_collect(sh_tbl, kss, value_col, distinct=distinct)
        return GroupByResult(res.table, res.num_groups)

    dist = _distributed_groupby(table, list(keys), mesh, capacity,
                                local_collect)
    dev = mesh.local_devices[0]
    per_exec = [table_to(trim_table(tbl, int(ng)), dev)
                for tbl, ng in zip(dist.table, dist.num_groups)]
    return DistributedCollectList(concatenate(per_exec), dist.overflowed)


def _column_to(c: Column, dev) -> Column:
    return Column(c.dtype, c.data.to(dev),
                  None if c.validity is None else c.validity.to(dev),
                  chars=None if c.chars is None else c.chars.to(dev),
                  children=None if c.children is None
                  else [_column_to(k, dev) for k in c.children])


def table_to(table: Table, device) -> Table:
    """``table`` on ``device`` (the same tensors where it already lives):
    how a small dimension table is replicated to an executor, the
    broadcast side of a broadcast join."""
    return Table([_column_to(c, device) for c in table.columns])
