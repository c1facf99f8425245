"""Runtime options of the port (counterpart of the reference's
``utils/config.py``, with the same ``get_option`` / ``set_option`` /
``reset_option`` names). Only the options that ported modules read are
here; the rest waits for ROADMAP.md Queue 1 entry 12.

- ``regex.force_engine``: ``None`` (or ``""``) lets ``regexp_contains``
  pick the engine (the device DFA when the pattern compiles and the
  column has no embedded NUL, the host engine otherwise); ``"device"``
  requires the DFA engine and raises where it cannot run; ``"host"``
  pins the host engine.
- ``integrity.enabled``: validate untrusted file input (the readers'
  envelope and decoded-size checks); the environment variable
  ``SPARK_RAPIDS_TPU_INTEGRITY`` wins over it.
"""

from __future__ import annotations

from typing import Any

# option name -> (default, allowed values)
_OPTIONS: dict[str, tuple[Any, tuple]] = {
    "regex.force_engine": (None, (None, "device", "host")),
    "integrity.enabled": (True, (True, False)),
}
_overrides: dict[str, Any] = {}


def get_option(name: str) -> Any:
    if name not in _OPTIONS:
        raise KeyError(f"unknown option {name!r}")
    return _overrides.get(name, _OPTIONS[name][0])


def set_option(name: str, value: Any) -> None:
    if name not in _OPTIONS:
        raise KeyError(f"unknown option {name!r}")
    if value == "":
        value = None  # the reference's spelling of the default
    if value not in _OPTIONS[name][1]:
        raise ValueError(f"option {name!r} takes one of "
                         f"{_OPTIONS[name][1]}, not {value!r}")
    _overrides[name] = value


def reset_option(name: str) -> None:
    _overrides.pop(name, None)
