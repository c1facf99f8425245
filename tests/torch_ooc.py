"""Shared inputs of the port's memory and out-of-core tests: Parquet files
of q1's and q3's lineitem (bench.py's parquet_q1 layout, written by
pyarrow from the generators' columns), a q1-shaped chunk probe in both
packages (the partial and merge algebra of the reference's
``tests/test_resilience.py``), and the classified events of both
packages' telemetry in one shape. Everything here is seeded; the JAX
package is imported inside the helpers only."""

from __future__ import annotations

import torch

from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from torch_parity import to_port


def write_q1_file(path, n: int, rows_per_group: int, seed: int = 0):
    """SF-shaped lineitem as Parquet in bench.py's parquet_q1 layout: the
    7 q1 columns, money as unscaled INT64, the flags INT8, l_shipdate
    DATE. Returns the port's in-memory lineitem (CPU)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from spark_rapids_jni_tpu_torch.models import tpch

    li = tpch.lineitem_table(n, seed=seed, device="cpu")
    h = [c.data.numpy() for c in li.columns]
    pq.write_table(pa.table({
        "l_quantity": pa.array(h[0], pa.int64()),
        "l_extendedprice": pa.array(h[1], pa.int64()),
        "l_discount": pa.array(h[2], pa.int64()),
        "l_tax": pa.array(h[3], pa.int64()),
        "l_returnflag": pa.array(h[4], pa.int8()),
        "l_linestatus": pa.array(h[5], pa.int8()),
        "l_shipdate": pa.array(h[6]).cast(pa.date32()),
    }), str(path), compression="snappy", row_group_size=rows_per_group)
    return li


def write_q3_file(path, lineitem, rows_per_group: int) -> None:
    """q3's lineitem (``lineitem_q3_table``) as Parquet: l_orderkey,
    l_extendedprice, l_discount as INT64, l_shipdate as DATE."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    h = [c.data.numpy() for c in lineitem.columns]
    pq.write_table(pa.table({
        "l_orderkey": pa.array(h[0], pa.int64()),
        "l_extendedprice": pa.array(h[1], pa.int64()),
        "l_discount": pa.array(h[2], pa.int64()),
        "l_shipdate": pa.array(h[3]).cast(pa.date32()),
    }), str(path), row_group_size=rows_per_group)


# ---- the q1-shaped chunk probe ----------------------------------------------

PROBE_CHUNKS = 4
PROBE_ROWS = 300


def reference_chunks(n_chunks: int = PROBE_CHUNKS, rows: int = PROBE_ROWS):
    """Equal row slices of the reference's lineitem (seed 11)."""
    from spark_rapids_jni_tpu.columnar import Column as JColumn
    from spark_rapids_jni_tpu.columnar import Table as JTable
    from spark_rapids_jni_tpu.models.tpch import lineitem_table

    li = lineitem_table(n_chunks * rows, seed=11)
    return [JTable([JColumn(c.dtype, c.data[a:a + rows],
                            None if c.validity is None
                            else c.validity[a:a + rows])
                    for c in li.columns])
            for a in range(0, n_chunks * rows, rows)]


def port_chunks(jchunks=None) -> list:
    """The probe's chunks in the port: of ``jchunks`` when given, else
    sliced from the port's own lineitem, the same rows."""
    if jchunks is not None:
        return [to_port(c) for c in jchunks]
    from spark_rapids_jni_tpu_torch.models.tpch import lineitem_table

    rows = PROBE_ROWS
    li = lineitem_table(PROBE_CHUNKS * rows, seed=11, device="cpu")
    return [Table([Column(c.dtype, c.data[a:a + rows],
                          None if c.validity is None
                          else c.validity[a:a + rows])
                   for c in li.columns])
            for a in range(0, PROBE_CHUNKS * rows, rows)]


def port_partial(chunk):
    from spark_rapids_jni_tpu_torch.ops.groupby import groupby_aggregate
    from spark_rapids_jni_tpu_torch.ops.table_ops import trim_table

    g = groupby_aggregate(chunk, keys=[4, 5],
                          aggs=[(0, "sum"), (1, "sum"), (0, "count")],
                          max_groups=16)
    return trim_table(g.table, int(g.num_groups))


def port_merge(partials):
    from spark_rapids_jni_tpu_torch.ops.groupby import groupby_aggregate
    from spark_rapids_jni_tpu_torch.ops.sort import sort_table
    from spark_rapids_jni_tpu_torch.ops.table_ops import trim_table

    g = groupby_aggregate(partials, keys=[0, 1],
                          aggs=[(i, "sum") for i in range(2, 5)])
    return sort_table(trim_table(g.table, int(g.num_groups)), [0, 1])


def reference_partial(chunk):
    from spark_rapids_jni_tpu.ops.groupby import groupby_aggregate
    from spark_rapids_jni_tpu.ops.table_ops import trim_table

    g = groupby_aggregate(chunk, keys=[4, 5],
                          aggs=[(0, "sum"), (1, "sum"), (0, "count")],
                          max_groups=16)
    return trim_table(g.table, int(g.num_groups))


def reference_merge(partials):
    from spark_rapids_jni_tpu.ops.groupby import groupby_aggregate
    from spark_rapids_jni_tpu.ops.sort import sort_table
    from spark_rapids_jni_tpu.ops.table_ops import trim_table

    g = groupby_aggregate(partials, keys=[0, 1],
                          aggs=[(i, "sum") for i in range(2, 5)])
    return sort_table(trim_table(g.table, int(g.num_groups)), [0, 1])


def port_host_sources(chunks) -> list:
    """Decode thunks returning ``HostTableChunk``s of ``chunks``, as a
    chunked reader's ``chunk_sources()`` gives them."""
    from spark_rapids_jni_tpu_torch.runtime.memory import host_table_chunk

    def snap(c):
        return (c.dtype, c.data, c.validity, c.chars, None)

    return [(lambda ch=ch: host_table_chunk(
        [snap(c) for c in ch.columns], ch.num_rows, torch.device("cpu")))
        for ch in chunks]


def reference_host_sources(chunks) -> list:
    from spark_rapids_jni_tpu.runtime.memory import (
        _col_to_host,
        host_table_chunk,
    )

    return [(lambda hc=host_table_chunk(
        [_col_to_host(c) for c in ch.columns], ch.num_rows): hc)
        for ch in chunks]


# ---- classified events of both packages -------------------------------------

_FIELDS = {"resilience": ("op", "event", "seam", "attempt", "rung"),
           "degrade": ("event", "tier", "trigger", "rung"),
           "integrity": ("op", "event", "seam")}


def port_events(kind: str) -> list:
    return [tuple(e.get(f) for f in _FIELDS[kind])
            for e in telemetry.events(kind)]


def reference_events(kind: str) -> list:
    from spark_rapids_jni_tpu import telemetry as jtelemetry

    return [tuple(e.get(f) for f in _FIELDS[kind])
            for e in jtelemetry.events() if e.get("kind") == kind]
