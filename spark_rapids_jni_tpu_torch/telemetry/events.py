"""Structured telemetry records (counterpart of the reference's
``telemetry/events.py``): where an op ran and why, what the runtime
decided, and the closed spans of each served query's tree.

Record kinds: ``dispatch`` (an op timed by ``trace_range(record=True)``),
``fallback`` (a device path handed its rows to the host; ``reason``
mandatory), ``compile_cache`` (a pattern-compile cache hit or miss),
``spill``, ``resilience``, ``degrade``, ``integrity`` (the memory and
out-of-core runtime), ``server``, ``cache`` and ``rtfilter`` (the
serving stack), ``fleet`` and ``exchange`` (the serving fleet, the
cluster and the exchange across processes), and ``span``
(``telemetry/spans.py``). Each record is stamped with ``ts`` (epoch
seconds), ``platform`` (``cuda`` once the process has initialised CUDA,
else ``cpu``), inside ``session_scope(sid)`` with ``session``, and in a
fleet or cluster worker with ``replica`` and ``host`` (the
``telemetry.replica`` and ``telemetry.host`` options its supervisor sets
in the worker's environment), so a JSONL sink that several processes
share attributes every line. A mandatory field left empty raises
``ValueError`` at the call site, whatever the options: an unaccountable
fallback, recovery, corruption, step, serving event or filter decision
is a bug.

Where the reference and the port differ: the reference records only
while ``telemetry.enabled`` is on; the port keeps every record in its
in-process ring (the last 4096) and counts its counters always, so a
run's classified events can be read without switching anything on (the
ring costs one dict and one lock a record). ``telemetry.enabled`` turns
on what costs more: the JSONL sink under ``telemetry.path`` (one
``O_APPEND`` write a record, never raising; a failed write counts
``dropped_writes``), the span trees and the flight recorder.

``record_compile_cache`` counts ``compile_cache.<cache>.hit|miss`` and
``fallbacks()`` returns the fallbacks per ``(op, reason)`` with their
row counts, as the port did before its telemetry became a package. The
reference's benchmark record (``record_bench_stale``) has no counterpart:
the port has no benchmark harness yet.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
from typing import Any, Deque, Dict, Iterable, List, Optional, Sequence

from spark_rapids_jni_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_jni_tpu_torch.utils.config import get_option

__all__ = [
    "enabled",
    "record_dispatch",
    "record_fallback",
    "record_compile_cache",
    "record_spill",
    "record_resilience",
    "record_server",
    "record_degrade",
    "record_integrity",
    "record_rtfilter",
    "record_cache",
    "record_fleet",
    "record_exchange",
    "session_scope",
    "current_session",
    "events",
    "drain",
    "summary",
    "fallbacks",
]

_RING_MAX = 4096
_ring: Deque[Dict[str, Any]] = collections.deque(maxlen=_RING_MAX)
_ring_lock = threading.Lock()
# (op, reason) -> [calls, rows]
_fallbacks: Dict[tuple, list] = {}

# Ambient session attribution (runtime/server.py): every record emitted
# on a thread inside session_scope(sid), by any layer, carries session.
_session_ctx = threading.local()


class session_scope:
    """Attribute every record emitted on this thread to a session.
    Nesting restores the outer session on exit; an explicit
    ``session=`` field of a record wins over the scope."""

    def __init__(self, session_id: str):
        if not session_id or not str(session_id).strip():
            raise ValueError("session_scope: session_id must be non-empty")
        self._sid = str(session_id)
        self._outer: Optional[str] = None

    def __enter__(self) -> "session_scope":
        self._outer = getattr(_session_ctx, "sid", None)
        _session_ctx.sid = self._sid
        return self

    def __exit__(self, *exc) -> bool:
        _session_ctx.sid = self._outer
        return False


def current_session() -> Optional[str]:
    """The session id attributed to this thread, or None outside a
    scope."""
    return getattr(_session_ctx, "sid", None)


def enabled() -> bool:
    """True when the ``telemetry.enabled`` option is on."""
    return bool(get_option("telemetry.enabled"))


def _platform() -> str:
    # no import here: the CLI reads records without loading torch
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        return "cuda"
    return "cpu"


def _replica() -> str:
    """The replica identity this process stamps on its records ("" in a
    process that is no fleet worker)."""
    return str(get_option("telemetry.replica") or "")


def _host() -> str:
    """The cluster host identity stamped beside the replica's."""
    return str(get_option("telemetry.host") or "")


def _emit(rec: Dict[str, Any]) -> Dict[str, Any]:
    rec.setdefault("ts", time.time())
    rec.setdefault("platform", _platform())
    sid = current_session()
    if sid is not None:
        rec.setdefault("session", sid)
    rid = _replica()
    if rid:
        rec.setdefault("replica", rid)
    hid = _host()
    if hid:
        rec.setdefault("host", hid)
    with _ring_lock:
        _ring.append(rec)
    REGISTRY.counter("events_total").inc()
    path = get_option("telemetry.path") if enabled() else ""
    if path:
        # one O_APPEND write a record: a reader never sees two writers'
        # lines torn into each other
        line = (json.dumps(rec, sort_keys=True, default=str)
                + "\n").encode("utf-8")
        try:
            fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
            try:
                os.write(fd, line)
            finally:
                os.close(fd)
        except OSError:
            # telemetry never takes the workload down with it
            REGISTRY.counter("dropped_writes").inc()
    return rec


def _base(kind: str, op: str, rows: Optional[int],
          dtype_widths: Optional[Sequence[int]],
          extra: Dict[str, Any]) -> Dict[str, Any]:
    rec: Dict[str, Any] = {"kind": kind, "op": op}
    if rows is not None:
        rec["rows"] = int(rows)
    if dtype_widths is not None:
        rec["dtype_widths"] = [int(w) for w in dtype_widths]
    rec.update(extra)
    return rec


def _required(kind: str, op: str, **named) -> None:
    for name, value in named.items():
        if not value or not str(value).strip():
            raise ValueError(f"record_{kind}({op!r}): {name} must be "
                             "non-empty")


def _unreserved(kind: str, op: str, extra: dict) -> None:
    for reserved in ("kind", "op"):
        if reserved in extra:
            raise ValueError(f"record_{kind}({op!r}): {reserved!r} is a "
                             "reserved record field")


def record_dispatch(op: str, *, engine: str = "device",
                    rows: Optional[int] = None,
                    dtype_widths: Optional[Sequence[int]] = None,
                    wall_ms: Optional[float] = None, **extra: Any) -> bool:
    """An op ran on ``engine``, timed when ``wall_ms`` is given (into
    the ``wall_ms.<op>`` histogram); counts ``dispatch.<op>``."""
    rec = _base("dispatch", op, rows, dtype_widths, extra)
    rec["engine"] = engine
    if wall_ms is not None:
        rec["wall_ms"] = float(wall_ms)
        REGISTRY.histogram(f"wall_ms.{op}").observe(float(wall_ms))
    REGISTRY.counter(f"dispatch.{op}").inc()
    _emit(rec)
    return True


def record_fallback(op: str, reason: str, *, rows: Optional[int] = None,
                    dtype_widths: Optional[Sequence[int]] = None,
                    **extra: Any) -> bool:
    """``op`` ran on the host because ``reason`` (which must be given);
    counts ``fallback.<op>`` and ``fallbacks_total``."""
    if not reason or not str(reason).strip():
        raise ValueError(f"record_fallback({op!r}): reason must be non-empty")
    with _ring_lock:
        row = _fallbacks.setdefault((op, str(reason)), [0, 0])
        row[0] += 1
        row[1] += int(rows or 0)
    rec = _base("fallback", op, rows, dtype_widths, extra)
    rec["reason"] = str(reason)
    rec["engine"] = "host"
    REGISTRY.counter(f"fallback.{op}").inc()
    REGISTRY.counter("fallbacks_total").inc()
    _emit(rec)
    return True


def fallbacks() -> dict:
    """``{(op, reason): {"calls": n, "rows": r}}`` since the last
    reset."""
    with _ring_lock:
        return {k: {"calls": c, "rows": r}
                for k, (c, r) in _fallbacks.items()}


def record_compile_cache(name: str, *, hit: bool, **extra: Any) -> bool:
    """The compile cache ``name`` (``regex_dfa``) was consulted: one more
    ``compile_cache.<name>.hit`` or ``.miss``."""
    rec = _base("compile_cache", name, None, None, extra)
    rec["hit"] = bool(hit)
    REGISTRY.counter(
        f"compile_cache.{name}.{'hit' if hit else 'miss'}").inc()
    _emit(rec)
    return True


def record_spill(op: str, reason: str, *, bytes_moved: int = 0,
                 rows: Optional[int] = None, **extra: Any) -> bool:
    """A spill or unspill between device and host, with its reason;
    counts ``spill.<op>`` and ``spill_bytes_total``."""
    _required("spill", op, reason=reason)
    _unreserved("spill", op, extra)
    rec = _base("spill", op, rows, None, extra)
    rec["reason"] = str(reason)
    rec["bytes_moved"] = int(bytes_moved)
    REGISTRY.counter(f"spill.{op}").inc()
    REGISTRY.counter("spill_bytes_total").inc(max(0, int(bytes_moved)))
    _emit(rec)
    return True


def record_resilience(op: str, event: str, *, seam: str, attempt: int,
                      rung: str, rows: Optional[int] = None,
                      **extra: Any) -> bool:
    """A resilience-policy decision: ``event`` is retry / recovered /
    escalate / fatal at ``seam``, on ladder ``rung``; counts
    ``resilience.<event>`` and ``resilience.rung.<rung>``."""
    _required("resilience", op, seam=seam, rung=rung)
    _unreserved("resilience", op, extra)
    rec = _base("resilience", op, rows, None, extra)
    rec["event"] = str(event)
    rec["seam"] = str(seam)
    rec["attempt"] = int(attempt)
    rec["rung"] = str(rung)
    REGISTRY.counter(f"resilience.{event}").inc()
    REGISTRY.counter(f"resilience.rung.{rung}").inc()
    _emit(rec)
    return True


def record_server(op: str, event: str, *, session: str,
                  rows: Optional[int] = None, **extra: Any) -> bool:
    """A serving decision for one query of one session: ``event`` is
    submitted / queued / rejected / admitted / served / failed /
    cancelled. The server counts its own ``server.*`` counters."""
    _required("server", op, session=session)
    rec = _base("server", op, rows, None, extra)
    rec["event"] = str(event)
    rec["session"] = str(session)
    _emit(rec)
    return True


def record_degrade(op: str, event: str, *, tier: str, trigger: str,
                   rung: int, rows: Optional[int] = None,
                   **extra: Any) -> bool:
    """A degradation decision: ``event`` is step / completed / parked /
    resumed / exhausted / pressure / cancelled / state_discarded /
    tier_unavailable, ``tier`` where the ladder goes, ``trigger`` what
    forced it; counts ``degrade.<event>`` and ``degrade.tier.<tier>``."""
    _required("degrade", op, tier=tier, trigger=trigger)
    _unreserved("degrade", op, extra)
    rec = _base("degrade", op, rows, None, extra)
    rec["event"] = str(event)
    rec["tier"] = str(tier)
    rec["trigger"] = str(trigger)
    rec["rung"] = int(rung)
    REGISTRY.counter(f"degrade.{event}").inc()
    REGISTRY.counter(f"degrade.tier.{tier}").inc()
    _emit(rec)
    return True


def record_integrity(op: str, event: str, *, seam: str,
                     nbytes: Optional[int] = None, **extra: Any) -> bool:
    """An integrity event (mismatch, replay, recovered, malformed) at
    the verification boundary ``seam``. The counters belong to
    ``runtime/integrity.py``, which counts whether or not this runs."""
    _required("integrity", op, seam=seam)
    _unreserved("integrity", op, extra)
    rec = _base("integrity", op, None, None, extra)
    rec["event"] = str(event)
    rec["seam"] = str(seam)
    if nbytes is not None:
        rec["nbytes"] = int(nbytes)
    _emit(rec)
    return True


def record_rtfilter(op: str, event: str, *, reason: str,
                    **extra: Any) -> bool:
    """A runtime-filter decision or observation (``runtime/rtfilter.py``):
    ``event`` is apply / skip / observed / state_discarded / prune and
    ``reason`` why. The filter counts its own ``rtfilter.*`` counters."""
    _required("rtfilter", op, reason=reason)
    rec = _base("rtfilter", op, None, None, extra)
    rec["event"] = str(event)
    rec["reason"] = str(reason)
    _emit(rec)
    return True


def record_cache(op: str, event: str, *, key: str,
                 nbytes: Optional[int] = None, **extra: Any) -> bool:
    """A result or subplan cache decision (``runtime/resultcache.py``):
    ``event`` is hit / miss / put / evict / shed / corrupt_discard /
    subplan_hit / subplan_materialize and ``key`` the entry's short
    two-part key. The cache counts its own ``cache.*`` counters."""
    _required("cache", op, key=key)
    rec = _base("cache", op, None, None, extra)
    rec["event"] = str(event)
    rec["key"] = str(key)
    if nbytes is not None:
        rec["nbytes"] = int(nbytes)
    _emit(rec)
    return True


def record_fleet(op: str, event: str, *, replica: str,
                 **extra: Any) -> bool:
    """A supervision event of the serving fleet or the cluster (boot,
    live, served, replica_death, failover, duplicate_drop, memo_hit,
    restart, quarantine, drain, identity_mismatch, and the cluster's
    routing and exchange events). ``replica`` names the replica or host
    the event is about ("supervisor" for the router's own). The fleet
    counts its own ``fleet.*`` and ``cluster.*`` counters."""
    _required("fleet", op, replica=replica)
    _unreserved("fleet", op, extra)
    rec = _base("fleet", op, None, None, extra)
    rec["event"] = str(event)
    rec["replica"] = str(replica)
    _emit(rec)
    return True


def record_exchange(op: str, event: str, *, rows: Optional[int] = None,
                    **extra: Any) -> bool:
    """An exchange event (pack, flight, overflow_escalate,
    chunked_flights, spill_demote, merge, parts_decision); byte and
    flight context rides in ``extra``. ``runtime/exchange.py`` counts
    its own ``exchange.*`` counters."""
    _required("exchange", op, event=event)
    _unreserved("exchange", op, extra)
    rec = _base("exchange", op, rows, None, extra)
    rec["event"] = str(event)
    _emit(rec)
    return True


def events(kind: Optional[str] = None) -> List[Dict[str, Any]]:
    """The ring's records, oldest first, of one ``kind`` if given (each
    a copy)."""
    with _ring_lock:
        return [dict(r) for r in _ring
                if kind is None or r.get("kind") == kind]


def drain() -> List[Dict[str, Any]]:
    """Return and clear the in-process ring."""
    with _ring_lock:
        buf = list(_ring)
        _ring.clear()
    return buf


def clear() -> None:
    """Empty the ring and the fallback table."""
    with _ring_lock:
        _ring.clear()
        _fallbacks.clear()


def summary(records: Optional[Iterable[Dict[str, Any]]] = None
            ) -> Dict[str, Any]:
    """Aggregate counts of a record stream (the reference's summary, key
    for key): with no argument the in-process ring, plus the columnar
    codec's section from this process's counters; otherwise parsed JSONL
    records of any process, whose ``compress`` section stays empty."""
    recs = list(records) if records is not None else events()
    compress: Dict[str, Any] = {}
    if records is None:
        comp = REGISTRY.counters("compress.")
        if comp:
            bytes_in = comp.get("compress.bytes_in", 0)
            bytes_out = comp.get("compress.bytes_out", 0)
            compress = {
                "bytes_in": bytes_in,
                "bytes_out": bytes_out,
                "ratio": round(bytes_in / bytes_out, 3)
                if bytes_out else None,
                "encode_us": comp.get("compress.encode_us", 0),
                "decode_us": comp.get("compress.decode_us", 0),
                "bytes_decoded": comp.get("compress.bytes_decoded", 0),
                "mismatches": comp.get("compress.mismatch", 0),
                "schemes": {
                    k.split(".", 2)[2]: v for k, v in sorted(comp.items())
                    if k.startswith("compress.scheme.")
                },
                "seams": {
                    seam: {
                        "bytes_in": comp.get(f"compress.{seam}.bytes_in", 0),
                        "bytes_out": comp.get(f"compress.{seam}.bytes_out",
                                              0),
                    }
                    for seam in ("spill", "wire", "checkpoint", "cache")
                    if f"compress.{seam}.bytes_in" in comp
                },
            }
    fallback_ops: Dict[str, int] = {}
    spills: Dict[str, int] = {}
    cache = {"hit": 0, "miss": 0}
    resilience: Dict[str, int] = {}
    server: Dict[str, int] = {}
    degrade: Dict[str, int] = {}
    degrade_tiers: Dict[str, int] = {}
    integrity: Dict[str, int] = {}
    integrity_seams: Dict[str, int] = {}
    result_cache: Dict[str, int] = {}
    fleet: Dict[str, int] = {}
    replicas: set = set()
    cluster: Dict[str, int] = {}
    hosts: set = set()
    per_host: Dict[str, int] = {}
    stale_reads = 0
    dispatches = 0
    spill_bytes = 0
    spans = 0
    span_status: Dict[str, int] = {}

    def bump(d: dict, key) -> None:
        d[key] = d.get(key, 0) + 1

    for r in recs:
        kind = r.get("kind")
        if r.get("replica"):
            replicas.add(str(r["replica"]))
        if r.get("host"):
            h = str(r["host"])
            hosts.add(h)
            bump(per_host, h)
        if kind == "span":
            spans += 1
            bump(span_status, str(r.get("status", "?")))
            continue
        ev = str(r.get("event", "?"))
        if kind == "resilience":
            bump(resilience, ev)
        elif kind == "server":
            bump(server, ev)
        elif kind == "degrade":
            bump(degrade, ev)
            if ev == "step":
                bump(degrade_tiers, str(r.get("tier", "?")))
        elif kind == "integrity":
            bump(integrity, ev)
            if ev == "mismatch":
                bump(integrity_seams, str(r.get("seam", "?")))
        elif kind == "cache":
            bump(result_cache, ev)
        elif kind == "fleet":
            # records of another process's fleet or cluster supervisor
            bump(fleet, ev)
            if str(r.get("op", "")).startswith("cluster."):
                bump(cluster, ev)
        elif kind == "fallback":
            bump(fallback_ops, str(r.get("op", "?")))
        elif kind == "spill":
            bump(spills, str(r.get("op", "?")))
            spill_bytes += int(r.get("bytes_moved", 0))
        elif kind == "compile_cache":
            cache["hit" if r.get("hit") else "miss"] += 1
        elif kind == "bench_stale":
            stale_reads += 1
        elif kind == "dispatch":
            dispatches += 1
    return {
        "events": len(recs),
        "dispatches": dispatches,
        "fallbacks": dict(sorted(fallback_ops.items())),
        "fallbacks_total": sum(fallback_ops.values()),
        "spills": dict(sorted(spills.items())),
        "spill_bytes_total": spill_bytes,
        "compile_cache": cache,
        "resilience": dict(sorted(resilience.items())),
        "server": dict(sorted(server.items())),
        "degrade": dict(sorted(degrade.items())),
        "degrade_tiers": dict(sorted(degrade_tiers.items())),
        "integrity": dict(sorted(integrity.items())),
        "integrity_seams": dict(sorted(integrity_seams.items())),
        "result_cache": dict(sorted(result_cache.items())),
        "fleet": dict(sorted(fleet.items())),
        "replicas": sorted(replicas),
        "cluster": dict(sorted(cluster.items())),
        "hosts": sorted(hosts),
        "per_host": dict(sorted(per_host.items())),
        "compress": compress,
        "spans": spans,
        "span_status": dict(sorted(span_status.items())),
        "stale_reads": stale_reads,
    }
