"""ORC reader of the port (counterpart of ``spark_rapids_jni_tpu/orc/``)."""

from spark_rapids_jni_tpu_torch.orc.reader import (
    OrcChunkedReader,
    read_table,
    stripe_info,
)

__all__ = ["OrcChunkedReader", "read_table", "stripe_info"]
