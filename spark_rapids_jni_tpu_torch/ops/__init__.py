"""Operators of the port (counterparts of spark_rapids_jni_tpu/ops/)."""
