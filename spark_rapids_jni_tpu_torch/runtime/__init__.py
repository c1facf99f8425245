"""Runtime of the port (counterparts of ``spark_rapids_jni_tpu/runtime/``):
the native library's loader and the C ABI bridge, the plan IR and its
executor, memory (the limiter, the spill store, host-to-device staging),
out-of-core and pipelined execution, the resilience taxonomy and retry
policy, fault injection, integrity trailers, the columnar codec, the
degradation ladder, and the serving stack (the query server, its
result cache and runtime filters, the fleet of worker processes, the
cluster of hosts and the exchange between them)."""
