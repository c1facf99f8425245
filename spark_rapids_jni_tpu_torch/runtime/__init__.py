"""Runtime pieces of the port (counterparts of the parts of
``spark_rapids_jni_tpu/runtime/`` that the readers use): the native
library's loader, input validation, the fault seam of untrusted ingest
and host-to-device staging."""
