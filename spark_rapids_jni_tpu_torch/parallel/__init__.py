"""Multiple executors (counterpart of ``spark_rapids_jni_tpu/parallel/``):
the executor mesh, the all-to-all shuffle, its wire codec, and the
distributed operators.

Spark executors map to positions along one mesh axis (``EXEC_AXIS``); a
repartition by key hash is one all-to-all of fixed-capacity ``(D,
capacity)`` send buffers, and post-shuffle operators (groupby merge,
join, window, sort) run on the key ranges each executor owns afterward.
The collectives run on copies between the executors' devices in one
process, or through a ``torch.distributed`` process group (NCCL on the
card, gloo on the CPU). The host byte transport between processes
(the reference's ``parallel/dcn.py``) comes with ROADMAP.md Queue 1
entry 12b.
"""

from spark_rapids_jni_tpu_torch.parallel.mesh import EXEC_AXIS, executor_mesh
from spark_rapids_jni_tpu_torch.parallel.shuffle import (
    ShuffleResult,
    hash_shuffle,
    shuffle_by_partition,
)
from spark_rapids_jni_tpu_torch.parallel.distributed import (
    distributed_groupby_aggregate,
    distributed_join,
    shard_table,
)
from spark_rapids_jni_tpu_torch.parallel.sort import distributed_sort
from spark_rapids_jni_tpu_torch.parallel.wire import BitPack, shuffle_wire_bytes

__all__ = [
    "BitPack",
    "EXEC_AXIS",
    "ShuffleResult",
    "distributed_groupby_aggregate",
    "distributed_join",
    "distributed_sort",
    "executor_mesh",
    "hash_shuffle",
    "shard_table",
    "shuffle_by_partition",
    "shuffle_wire_bytes",
]
