"""Parquet readers of the port (counterpart of
``spark_rapids_jni_tpu/parquet/``)."""

from spark_rapids_jni_tpu_torch.parquet.footer import ParquetFooter
from spark_rapids_jni_tpu_torch.parquet.reader import (
    ParquetChunkedReader,
    read_table,
    row_group_info,
)

__all__ = [
    "ParquetChunkedReader",
    "ParquetFooter",
    "read_table",
    "row_group_info",
]
