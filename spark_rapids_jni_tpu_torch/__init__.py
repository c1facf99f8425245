"""PyTorch/CUDA port of spark_rapids_jni_tpu: the columnar layer that the
RAPIDS Accelerator for Apache Spark calls, on an NVIDIA Hopper GPU.

The JAX package ``spark_rapids_jni_tpu`` is the reference this package is
held against; this package imports neither JAX nor anything of it. Its
layout mirrors the reference module by module, except that the hand-written
kernels live under ``ops/kernels/`` (CUDA C++ sources under ``csrc/``).
"""
