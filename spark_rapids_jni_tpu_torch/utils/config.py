"""Runtime options of the port (counterpart of the reference's
``utils/config.py``, with the same ``get_option`` / ``set_option`` /
``reset_option`` names and the same precedence: a ``set_option`` value,
then the environment variable ``SPARK_RAPIDS_TPU_<OPTION>`` (dots as
underscores, upper case), then the default). Only the options that
ported modules read are here (the multi-executor layer, ``parallel/``,
reads none of its own).

- ``log.level``: the level of the port's loggers (``utils/log.py``).
- ``telemetry.*``: ``enabled`` turns on the JSONL sink, the span trees
  and the flight recorder (the port's classified events and counters
  are recorded in process whether or not it is on); ``path`` the JSONL
  file; ``flight_recorder_depth`` and ``flight_recorder_path`` the
  recorder's ring and its artifact directory; ``max_spans_per_tree``
  the in-memory tree's cap; ``replica`` and ``host`` the identity a
  fleet or cluster worker stamps on every record and span ("" leaves
  records unstamped; the supervisors set them in each worker's
  environment).

- ``regex.force_engine``: ``None`` (or ``""``) lets ``regexp_contains``
  pick the engine (the device DFA when the pattern compiles and the
  column has no embedded NUL, the host engine otherwise); ``"device"``
  requires the DFA engine and raises where it cannot run; ``"host"``
  pins the host engine.
- ``integrity.enabled``: checksum trailers on spilled payloads and
  out-of-core checkpoints, and validation of untrusted file input (the
  readers' envelope and decoded-size checks); the environment variable
  ``SPARK_RAPIDS_TPU_INTEGRITY`` wins over it.
- ``memory.*``: ``log_level`` (0 off, 1 spills and staging, 2 every
  reservation), ``spill_dir`` (a directory for the SpillStore's disk
  tier; "" keeps spilled payloads in host memory).
- ``pipeline.*``: the pipelined out-of-core executor (off by default),
  its prefetch depth (``SPARK_RAPIDS_TPU_PIPELINE_PREFETCH`` wins) and
  decode threads.
- ``resilience.*``: the shared retry and capacity-escalation policy.
- ``degrade.*``: the degradation ladder's switch, step bound, parked
  wait and first out-of-core chunk size.
- ``compress.*``: the columnar codec under the integrity seal, one gate
  for each seam the port seals (spill, the DCN wire and checkpoint),
  and the zstd final stage's level.
- ``server.*``: the serving runtime (``runtime/server.py``): in-flight
  queries, the default budget, admission timeout, per-session queue
  depth, estimate headroom, default deadline, learned-estimate blend,
  file and save interval, and the warm-up's signature count.
- ``cache.*``: the result and subplan cache (``runtime/resultcache.py``):
  its switch, its LRU capacity in resident bytes, the subplan switch.
- ``rtfilter.*``: runtime bloom-join filters (``runtime/rtfilter.py``):
  the planner pass's switch (off), the largest build side, the target
  false-positive rate, the learned gate's pass fraction and blend, the
  learned-selectivity file and its save interval.
- ``fleet.*``: the serving fleet (``runtime/fleet.py``): replica count,
  heartbeat cadence and timeout, failover budget, restart backoff and
  its multiplier, the crash count that quarantines a replica, the
  result memo's entries, the worker boot timeout and the dispatch
  timeout.
- ``dcn.bind_host``: the interface DCN listeners bind and dials target.
- ``cluster.*``: the host count of ``runtime/cluster.py`` and the shard
  registration timeout.
- ``exchange.*``: the exchange's (``runtime/exchange.py``) largest send
  capacity before chunked flights, the receive-side merge budget, the
  direct host-to-host flights' switch, peer dial retries and delay and
  their timeout, and the auto-parts sizing (target rows per part, most
  parts).
"""

from __future__ import annotations

import os
from typing import Any

_ENV_PREFIX = "SPARK_RAPIDS_TPU_"

# option name -> (default, allowed values or the type values parse to)
_OPTIONS: dict[str, tuple[Any, Any]] = {
    "log.level": ("WARNING", str),
    "telemetry.enabled": (False, bool),
    "telemetry.path": ("", str),
    "telemetry.flight_recorder_depth": (16, int),
    "telemetry.flight_recorder_path": ("", str),
    "telemetry.max_spans_per_tree": (2048, int),
    "telemetry.replica": ("", str),
    "telemetry.host": ("", str),
    "regex.force_engine": (None, (None, "device", "host")),
    "integrity.enabled": (True, bool),
    "memory.log_level": (0, int),
    "memory.spill_dir": ("", str),
    "pipeline.enabled": (False, bool),
    "pipeline.prefetch_depth": (2, int),
    "pipeline.decode_threads": (2, int),
    "resilience.enabled": (True, bool),
    "resilience.max_attempts": (4, int),
    "resilience.growth": (4, int),
    "resilience.backoff_ms": (0, int),
    "resilience.backoff_multiplier": (2.0, float),
    "degrade.enabled": (True, bool),
    "degrade.max_steps": (4, int),
    "degrade.park_timeout_s": (30.0, float),
    "degrade.chunk_rows": (65536, int),
    "compress.enabled": (True, bool),
    "compress.spill": (True, bool),
    "compress.wire": (True, bool),
    "compress.checkpoint": (True, bool),
    "compress.zstd_level": (3, int),
    "server.max_inflight": (4, int),
    "server.hbm_budget_bytes": (1 << 30, int),
    "server.admission_timeout_s": (30.0, float),
    "server.queue_depth": (64, int),
    "server.estimate_headroom": (1.5, float),
    "server.deadline_ms": (0, int),
    "server.estimate_alpha": (0.4, float),
    "server.estimate_path": ("", str),
    "server.estimate_save_interval_s": (5.0, float),
    "server.warmup_top_n": (0, int),
    "cache.enabled": (True, bool),
    "cache.max_bytes": (256 << 20, int),
    "cache.subplan_enabled": (True, bool),
    "rtfilter.enabled": (False, bool),
    "rtfilter.max_build_rows": (1 << 16, int),
    "rtfilter.fpp": (0.03, float),
    "rtfilter.gate_pass_frac": (0.8, float),
    "rtfilter.alpha": (0.4, float),
    "rtfilter.path": ("", str),
    "rtfilter.save_interval_s": (5.0, float),
    "fleet.replicas": (2, int),
    "fleet.heartbeat_interval_s": (0.5, float),
    "fleet.heartbeat_timeout_s": (5.0, float),
    "fleet.failover_budget": (2, int),
    "fleet.restart_backoff_s": (0.25, float),
    "fleet.restart_backoff_multiplier": (2.0, float),
    "fleet.quarantine_after": (3, int),
    "fleet.result_memo_entries": (64, int),
    "fleet.worker_boot_timeout_s": (60.0, float),
    "fleet.dispatch_timeout_s": (30.0, float),
    "dcn.bind_host": ("127.0.0.1", str),
    "cluster.hosts": (2, int),
    "cluster.register_timeout_s": (60.0, float),
    "exchange.max_capacity_rows": (1 << 16, int),
    "exchange.merge_budget_bytes": (64 << 20, int),
    "exchange.direct_enabled": (True, bool),
    "exchange.peer_dial_retries": (8, int),
    "exchange.peer_dial_delay_s": (0.05, float),
    "exchange.direct_timeout_s": (30.0, float),
    "exchange.target_rows_per_part": (4096, int),
    "exchange.max_parts": (64, int),
}
_overrides: dict[str, Any] = {}


def _parse(raw: str, typ: type) -> Any:
    if typ is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    return typ(raw)


def _coerce(name: str, value: Any) -> Any:
    allowed = _OPTIONS[name][1]
    if isinstance(allowed, type):
        return _parse(value, allowed) if isinstance(value, str) \
            else allowed(value)
    if value == "":
        value = None  # the reference's spelling of the default
    if value not in allowed:
        raise ValueError(f"option {name!r} takes one of {allowed}, "
                         f"not {value!r}")
    return value


def get_option(name: str) -> Any:
    if name not in _OPTIONS:
        raise KeyError(f"unknown option {name!r}")
    if name in _overrides:
        return _overrides[name]
    env = os.environ.get(_ENV_PREFIX + name.upper().replace(".", "_"))
    if env is not None:
        return _coerce(name, env)
    return _OPTIONS[name][0]


def set_option(name: str, value: Any) -> None:
    if name not in _OPTIONS:
        raise KeyError(f"unknown option {name!r}")
    _overrides[name] = _coerce(name, value)


def reset_option(name: str) -> None:
    _overrides.pop(name, None)
