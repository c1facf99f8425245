from spark_rapids_jni_tpu_torch.columnar.column import Column
from spark_rapids_jni_tpu_torch.columnar.table import Table
from spark_rapids_jni_tpu_torch.columnar.bitmask import (
    pack_validity,
    unpack_validity,
)

__all__ = ["Column", "Table", "pack_validity", "unpack_validity"]
