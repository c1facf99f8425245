"""One slice of the two-process slice exchange
(``test_torch_dcn.test_two_slices_in_two_processes_keep_every_row``):
``python tests/torch_dcn_worker.py <slice id> <port>``. Slice 0 listens,
slice 1 dials; each builds its own lineitem rows from its seed,
repartitions them by q1's group keys across the link, checks that every
row it holds hashes to it, and prints the sum of its column 0."""

import sys

from spark_rapids_jni_tpu_torch.models import tpch
from spark_rapids_jni_tpu_torch.ops.hash import partition_hash
from spark_rapids_jni_tpu_torch.parallel import dcn

KEYS = [4, 5]  # l_returnflag, l_linestatus


def main() -> int:
    sid, port = int(sys.argv[1]), int(sys.argv[2])
    table = tpch.lineitem_table(3000, seed=sid, device="cpu")
    link = (dcn.SliceLink.listen(port, device="cpu", timeout=60)
            if sid == 0 else
            dcn.SliceLink.connect(port, retries=200, delay_s=0.05,
                                  device="cpu"))
    try:
        mine = dcn.exchange_across_slices(table, KEYS, link, sid)
    finally:
        link.close()
    if mine.num_rows and not bool(
            (partition_hash(mine, KEYS, 2) == sid).all()):
        print("a row landed on the wrong slice")
        return 1
    print(f"slice {sid} rows {mine.num_rows} sum "
          f"{int(mine.column(0).data.sum())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
