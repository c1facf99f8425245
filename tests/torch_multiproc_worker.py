"""Worker of ``tests/test_torch_multiprocess_mesh.py``: one rank of a
gloo process group running the port's distributed q1 across process
boundaries. It imports only the port (no JAX).

Run as: python -m tests.torch_multiproc_worker <rank> <world_size>
        <init_file> <rows_per_rank>

Every rank generates the whole lineitem table from one seed and passes
its own row slice to ``tpch_q1_distributed`` over a process-group mesh
(the shuffle's all-to-all crosses the process boundary). The result must
equal the local mesh's over the whole table and the numpy oracle; the
string-width agreement and the row-count check of
``shard_table_multiprocess`` are exercised too. Prints
TORCH_Q1_MULTIPROC_MATCH on success.
"""

import datetime
import sys

import torch
import torch.distributed as dist


def main() -> None:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    init_file, rows = sys.argv[3], int(sys.argv[4])
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        check(rank, world, rows)
    finally:
        dist.destroy_process_group()


def check(rank: int, world: int, rows: int) -> None:
    from spark_rapids_jni_tpu_torch.columnar import Table
    from spark_rapids_jni_tpu_torch.columnar.column import string_column
    from spark_rapids_jni_tpu_torch.models import tpch
    from spark_rapids_jni_tpu_torch.ops.table_ops import contiguous_split
    from spark_rapids_jni_tpu_torch.parallel.distributed import (
        global_table,
        shard_table_multiprocess,
    )
    from spark_rapids_jni_tpu_torch.parallel.mesh import executor_mesh

    full = tpch.lineitem_table(rows * world, seed=11, device="cpu")
    local = contiguous_split(full, [rows * r for r in range(1, world)])[rank]
    mesh = executor_mesh(devices=["cpu"] * world, group=dist.group.WORLD)
    assert mesh.executors == (rank,)
    got = tpch.tpch_q1_distributed(local, mesh)

    # the local transport over the whole table: the same shards, so the
    # same bytes
    want = tpch.tpch_q1_distributed(full, executor_mesh(world,
                                                        ["cpu"] * world))
    assert got.num_rows == want.num_rows, (got.num_rows, want.num_rows)
    for i, (a, b) in enumerate(zip(got.columns, want.columns)):
        va, vb = a.valid_mask(), b.valid_mask()
        assert torch.equal(va, vb), f"column {i} validity"
        assert torch.equal(a.data[va], b.data[vb]), f"column {i} data"

    oracle = tpch.tpch_q1_numpy(full)
    k = int((got.column(0).valid_mask() & got.column(1).valid_mask()).sum())
    assert k == len(oracle), (k, len(oracle))
    for r in range(k):
        w = oracle[(int(got.column(0).data[r]), int(got.column(1).data[r]))]
        assert [int(got.column(c).data[r]) for c in (2, 3, 4, 5, 9)] == [
            w["sum_qty"], w["sum_base_price"], w["sum_disc_price"],
            w["sum_charge"], w["count"]]

    # string widths differ per rank: the global width is agreed on
    svals = [f"p{rank}" + "x" * (3 * rank)] * 4
    shard = shard_table_multiprocess(
        Table([string_column(svals, device="cpu")]), mesh)
    whole = global_table(mesh, shard).column(0)
    got_strs = [bytes(whole.chars[i, :int(whole.data[i])].tolist()).decode()
                for i in range(whole.size)]
    assert got_strs == [f"p{q}" + "x" * (3 * q) for q in range(world)
                        for _ in range(4)], got_strs

    # unequal row counts fail loudly on every rank
    try:
        shard_table_multiprocess(
            Table([string_column(["a"] * (3 + rank), device="cpu")]), mesh)
    except ValueError as exc:
        assert "SAME row count" in str(exc)
    else:
        raise AssertionError("unequal row counts were accepted")

    print(f"TORCH_Q1_MULTIPROC_MATCH rank={rank} groups={k}", flush=True)


if __name__ == "__main__":
    main()
