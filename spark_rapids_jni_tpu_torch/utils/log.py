"""Thin logging facade (counterpart of the reference's ``utils/log.py``,
the slf4j-api role): every port logger hangs under
``spark_rapids_jni_tpu_torch``, whose level comes from the ``log.level``
option (environment ``SPARK_RAPIDS_TPU_LOG_LEVEL``), read once when the
first logger is asked for."""

from __future__ import annotations

import logging

from spark_rapids_jni_tpu_torch.utils.config import get_option

_ROOT = "spark_rapids_jni_tpu_torch"
_configured = False


def get_logger(name: str = _ROOT) -> logging.Logger:
    global _configured
    logger = logging.getLogger(name)
    if not _configured:
        level = getattr(logging, str(get_option("log.level")).upper(),
                        logging.WARNING)
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        root = logging.getLogger(_ROOT)
        root.addHandler(handler)
        root.setLevel(level)
        root.propagate = False
        _configured = True
    return logger
