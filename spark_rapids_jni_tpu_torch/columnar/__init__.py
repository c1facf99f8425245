from spark_rapids_jni_tpu_torch.columnar.column import Column
from spark_rapids_jni_tpu_torch.columnar.table import Table

__all__ = ["Column", "Table"]
