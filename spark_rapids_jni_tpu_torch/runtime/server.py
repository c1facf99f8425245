"""Multi-query serving runtime: admission, fair scheduling, deadlines
(counterpart of the reference's ``runtime/server.py``).

Every layer below this one runs one query at a time. Here N sessions
submit fusion plans (``runtime/fusion.py``) to one shared card, under
one ``MemoryLimiter``, one ``SpillStore``, one result cache and the
pipeline's shared decode pool.

Contracts, in order of importance:

* **No overcommit.** Every query's device-memory estimate is reserved
  through the shared limiter before it runs. An estimate over the whole
  budget, or a full session queue, is rejected at submit; a query that
  does not fit right now waits its turn in the limiter's FIFO
  (``reserve_blocking``), for at most ``server.admission_timeout_s``.
* **Fairness.** Queued work drains round-robin across sessions, at most
  ``server.max_inflight`` queries at once: each turn takes the next
  session's oldest query, not the globally oldest.
* **Attribution.** Latency and queue wait land in per-session histograms
  (``server.latency_ms.<sid>``, ``server.queue_wait_ms.<sid>``); the
  ``server.*`` counters count per session and in total; a query runs
  inside ``telemetry.session_scope(sid)``, so every record of any layer
  under it carries the session.
* **No leaks.** A query that dies, however, releases its reservation and
  its worker; its failure is classified (``resilience.classify``) and
  recorded before the ticket resolves.
* **Bend, don't break.** A classified pressure failure steps the query
  down the degradation ladder (``runtime/degrade.py``: fused ->
  out-of-core -> parked) instead of failing it; the limiter's high
  watermark sheds cached results, then spills the store's coldest
  entries, and pauses new admissions until usage drains below low.
* **Cooperative deadlines.** ``server.deadline_ms`` (or a submit's
  ``deadline_ms``) arms a ``CancelToken`` from submit time, checked at
  admission, at a plan's start and at chunk boundaries; expiry or
  ``ticket.cancel()`` resolves the ticket ``cancelled``.
* **Admission learns.** After each served query the measured working set
  (input and result device bytes) is blended into a per-signature EMA
  (``server.estimate_alpha``), persisted under an ``fcntl`` lock with
  ``atomic_write_json`` at ``server.estimate_path`` ("" keeps it in
  process), at most once per ``server.estimate_save_interval_s``.

Streams. Workers launch on the default stream of the card, so
concurrent queries share it and their kernels run in submission order:
correct, and concurrent on the host (staging, planning, the host steps
of each operator), not on the device. Host-decoded ``HostTableChunk``
bindings are staged on the shared decode pool, on a copy stream of the
server's; the worker's stream waits on the copy's event and every staged
tensor is marked with ``record_stream`` for it, as
``runtime/pipeline.py`` does.

Launch counters are process-wide: with ``max_inflight`` > 1 a count read
around one query also holds its neighbours' launches, so a caller reads
totals over a known set of queries.

The reference's query executables and donation do not exist in the port
(``runtime/dispatch.py``): ``submit`` takes no ``donate_inputs``, and
``warmup`` builds no executable (see its docstring).

Config: ``server.max_inflight``, ``hbm_budget_bytes``,
``admission_timeout_s``, ``queue_depth``, ``estimate_headroom``,
``deadline_ms``, ``estimate_alpha``, ``estimate_path``,
``estimate_save_interval_s``, ``warmup_top_n``; the ladder's are
``degrade.*`` and the cache's ``cache.*``.
"""

from __future__ import annotations

import collections
import threading
import time
import weakref
from typing import Any, Callable, Optional

import torch

from spark_rapids_jni_tpu_torch.runtime import (
    degrade,
    faults,
    fusion,
    pipeline,
    resilience,
    resultcache,
)
from spark_rapids_jni_tpu_torch.runtime.memory import (
    HostTableChunk,
    MemoryLimiter,
    SpillStore,
    table_nbytes,
    table_tensors,
)
from spark_rapids_jni_tpu_torch.telemetry import REGISTRY, spans
from spark_rapids_jni_tpu_torch.telemetry.events import (
    events as _ring_events,
    record_degrade,
    record_integrity,
    record_server,
    session_scope,
)
from spark_rapids_jni_tpu_torch.utils.atomic_io import (
    atomic_write_json,
    load_json,
)
from spark_rapids_jni_tpu_torch.utils.config import get_option
from spark_rapids_jni_tpu_torch.utils.log import get_logger

try:  # POSIX advisory locks for the shared learned-estimate file
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX: merge-on-load only
    fcntl = None  # type: ignore[assignment]

__all__ = ["QueryRejected", "QueryTicket", "Session", "QueryServer",
           "live_servers", "register_warmup_builder", "warmup_builders"]

_log = get_logger("spark_rapids_jni_tpu_torch.server")

# open servers of this process, for ``python -m
# spark_rapids_jni_tpu_torch.telemetry top``; weak, so a dropped server
# (and its limiter) is not kept alive
_LIVE_SERVERS: "weakref.WeakSet[QueryServer]" = weakref.WeakSet()


def live_servers() -> list:
    """The not-yet-closed QueryServers of this process."""
    return [s for s in list(_LIVE_SERVERS) if not s._closed]


# ---------------------------------------------------------------------------
# warm-up builders
# ---------------------------------------------------------------------------

_WARMUP_BUILDERS: dict = {}


def register_warmup_builder(plan_name: str, builder: Callable[[int], Any]
                            ) -> None:
    """Register the warm-up of one plan name: ``builder(rows)`` makes
    inputs of ``rows`` rows and runs the plan through its usual entry
    point; its value is dropped. ``models/tpch.py`` registers its
    single-table plans at import."""
    if not plan_name or not str(plan_name).strip():
        raise ValueError("register_warmup_builder: plan_name is required")
    if not callable(builder):
        raise TypeError(f"warmup builder for {plan_name!r} is not callable")
    _WARMUP_BUILDERS[str(plan_name)] = builder


def warmup_builders() -> dict:
    """The registered warm-up builders (name -> callable)."""
    return dict(_WARMUP_BUILDERS)


class QueryRejected(RuntimeError):
    """Admission refused the query: an estimate over the whole budget, a
    full session queue, an admission timeout, or a closed or draining
    server. The context rides on the exception: ``session``,
    ``reason``, ``queue_depth``, ``bytes_requested``,
    ``bytes_available`` (the limiter's free bytes then), and
    ``retry_after_s`` (None: retrying can never succeed);
    ``flight_record`` is the path of the flight-recorder artifact dumped
    at rejection, if one was written."""

    def __init__(self, message: str, *, session: str = "", reason: str = "",
                 queue_depth: int = 0, bytes_requested: int = 0,
                 bytes_available: int = 0,
                 retry_after_s: Optional[float] = None,
                 flight_record: Optional[str] = None):
        super().__init__(message)
        self.session = session
        self.reason = reason
        self.queue_depth = int(queue_depth)
        self.bytes_requested = int(bytes_requested)
        self.bytes_available = int(bytes_available)
        self.retry_after_s = retry_after_s
        self.flight_record = flight_record


class QueryTicket:
    """One submitted query's future: ``result()`` gives the plan's
    ``FusedResult`` or raises ``QueryRejected``, the classified
    ``QueryCancelled`` or the classified execution error. ``status``
    walks queued -> admitted -> served | rejected | cancelled |
    failed."""

    def __init__(self, session_id: str, plan: fusion.Plan, bindings: dict,
                 estimate: int, deadline_ms: int = 0,
                 outofcore: Optional[Callable] = None):
        self.session = session_id
        self.plan = plan
        self.bindings = bindings
        self.estimate = int(estimate)
        self.outofcore = outofcore
        # (signature, input fingerprint) when the result cache is on
        self.cache_key = None
        # the deadline runs from submit: queue wait counts against it
        self.deadline_ms = int(deadline_ms)
        self.cancel_token = resilience.CancelToken(
            self.deadline_ms, label=f"{plan.name}/{session_id}")
        self.status = "queued"
        self.queue_wait_s: Optional[float] = None
        self.latency_s: Optional[float] = None
        self._submitted_at = time.monotonic()
        self._value: Any = None
        self._exc: Optional[BaseException] = None
        self._done = threading.Event()

    def cancel(self, reason: str = "client cancel") -> None:
        """Cooperative cancel: the query stops at its next checkpoint,
        releases what it holds and resolves ``cancelled``."""
        self.cancel_token.cancel(reason)

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"query {self.plan.name!r} (session {self.session}) not "
                f"done within {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._value

    def _resolve(self, status: str, value: Any = None,
                 exc: Optional[BaseException] = None) -> None:
        self.status = status
        self._value = value
        self._exc = exc
        self._done.set()


class Session:
    """A client handle: submits under one session id."""

    def __init__(self, server: "QueryServer", session_id: str):
        self._server = server
        self.session_id = session_id

    def submit(self, plan: fusion.Plan, bindings: dict, *,
               estimate_bytes: Optional[int] = None,
               deadline_ms: Optional[int] = None,
               outofcore: Optional[Callable] = None,
               cache_fingerprint: Optional[str] = None) -> QueryTicket:
        return self._server.submit(
            self.session_id, plan, bindings, estimate_bytes=estimate_bytes,
            deadline_ms=deadline_ms, outofcore=outofcore,
            cache_fingerprint=cache_fingerprint)

    def stats(self) -> dict:
        return self._server.session_stats(self.session_id)


class QueryServer:
    """The serving runtime: construct, ``session(sid).submit(...)``,
    ``ticket.result()``; ``close()`` (or the context manager) joins the
    workers and rejects whatever is still queued."""

    def __init__(self, *, limiter: Optional[MemoryLimiter] = None,
                 budget_bytes: Optional[int] = None,
                 max_inflight: Optional[int] = None,
                 admission_timeout_s: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 estimate_headroom: Optional[float] = None):
        if limiter is not None and budget_bytes is not None:
            raise ValueError("pass limiter OR budget_bytes, not both")
        self.limiter = limiter if limiter is not None else MemoryLimiter(
            int(budget_bytes if budget_bytes is not None
                else get_option("server.hbm_budget_bytes")))
        self.max_inflight = max(1, int(
            max_inflight if max_inflight is not None
            else get_option("server.max_inflight")))
        self.admission_timeout_s = float(
            admission_timeout_s if admission_timeout_s is not None
            else get_option("server.admission_timeout_s"))
        self.queue_depth = max(1, int(
            queue_depth if queue_depth is not None
            else get_option("server.queue_depth")))
        self.estimate_headroom = float(
            estimate_headroom if estimate_headroom is not None
            else get_option("server.estimate_headroom"))
        self.decode_pool = pipeline.shared_decode_pool()
        self._copy_streams: dict = {}
        self._copy_streams_lock = threading.Lock()
        # the store backs degraded queries' partials and the cache's
        # entries, and is the limiter's pressure valve
        self.spill_store = SpillStore(self.limiter.budget)
        self.limiter.attach_spill_store(self.spill_store)
        self.degrader = degrade.DegradationController(self.limiter)
        self.result_cache = resultcache.ResultCache(
            self.spill_store, self.limiter)
        self.limiter.attach_result_cache(self.result_cache)
        self._learned_lock = threading.Lock()
        self._learned: dict[str, float] = {}
        self._learned_dirty = False
        self._last_save: Optional[float] = None
        self._estimate_path = str(get_option("server.estimate_path") or "")
        self._load_learned()
        self._cond = threading.Condition()
        self._queues: dict[str, collections.deque] = {}
        self._ring: collections.deque = collections.deque()
        # ticket id -> {ticket, span, tier, rung, ...} for inspect()
        self._inflight: dict[int, dict] = {}
        self._inflight_lock = threading.Lock()
        self._registered: dict[str, tuple] = {}
        self._registered_lock = threading.Lock()
        self._stop = threading.Event()
        self._closed = False
        self._draining = False
        _LIVE_SERVERS.add(self)
        self._workers = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"query-server-worker-{i}")
            for i in range(self.max_inflight)]
        for w in self._workers:
            w.start()

    # -- client surface ------------------------------------------------------

    def session(self, session_id: str) -> Session:
        if not session_id or not str(session_id).strip():
            raise ValueError("session_id must be non-empty")
        sid = str(session_id)
        with self._cond:
            if sid not in self._queues:
                self._queues[sid] = collections.deque()
                self._ring.append(sid)
        return Session(self, sid)

    def register_table(self, name: str, table) -> str:
        """Keep a resident table under ``name`` for queries that bind it
        by name (:meth:`registered_table`); its content fingerprint is
        returned. Re-registering a name replaces it."""
        if not name or not str(name).strip():
            raise ValueError("registered table name must be non-empty")
        fp = resultcache.table_fingerprint(table)
        with self._registered_lock:
            self._registered[str(name)] = (table, fp)
        record_server("server", "registered", session="_cluster",
                      table=str(name), rows=int(table.num_rows),
                      fingerprint=fp)
        return fp

    def registered_table(self, name: str):
        """The table registered under ``name`` (KeyError if none)."""
        with self._registered_lock:
            return self._registered[str(name)][0]

    def registered_fingerprint(self, name: str) -> str:
        with self._registered_lock:
            return self._registered[str(name)][1]

    def submit(self, session_id: str, plan: fusion.Plan, bindings: dict, *,
               estimate_bytes: Optional[int] = None,
               deadline_ms: Optional[int] = None,
               outofcore: Optional[Callable] = None,
               cache_fingerprint: Optional[str] = None) -> QueryTicket:
        """Queue one query; never blocks. An estimate over the whole
        budget or a full session queue comes back as a ticket already
        rejected.

        ``deadline_ms`` (default ``server.deadline_ms``; 0: none) arms
        the ticket's ``CancelToken`` from now. ``outofcore`` is the
        ladder's rung-2 factory, ``(bindings, limiter) -> runner`` with
        ``runner(chunk_rows, cancel_token) -> Table``
        (``degrade.row_chunked_tier`` builds one); without it the ladder
        is fused -> parked.

        With ``cache.enabled``, a submission whose (plan signature, input
        fingerprint) is cached resolves served at once, with no admission
        and no execution: one root span with a ``cache.hit`` child.
        ``cache_fingerprint`` replaces the content digest of
        ``bindings`` (which copies every buffer to the host once per
        table; see ``resultcache``)."""
        sid = str(session_id)
        self.session(sid)
        estimate = int(estimate_bytes) if estimate_bytes is not None \
            else self._default_estimate(plan, bindings)
        ddl = int(deadline_ms if deadline_ms is not None
                  else get_option("server.deadline_ms"))
        ticket = QueryTicket(sid, plan, bindings, estimate, deadline_ms=ddl,
                             outofcore=outofcore)
        self._count("submitted", sid)
        record_server(plan.name, "submitted", session=sid,
                      estimate_bytes=estimate)
        if resultcache.enabled():
            try:
                ticket.cache_key = resultcache.cache_key(
                    plan, bindings, fingerprint=cache_fingerprint)
            except (ValueError, KeyError, TypeError):
                ticket.cache_key = None  # unfingerprintable: never cached
            if ticket.cache_key is not None:
                hit = self.result_cache.get(ticket.cache_key)
                if hit is not None:
                    self._serve_hit(ticket, hit)
                    return ticket
        if estimate > self.limiter.budget:
            self._reject(ticket,
                         f"estimate {estimate} exceeds the whole budget "
                         f"({self.limiter.budget}): can never fit",
                         retry_after_s=None)
            return ticket
        retry_after: Optional[float] = None
        with self._cond:
            if self._closed:
                reject_why = "server closed"
            elif self._draining:
                reject_why = "server draining"
            elif len(self._queues[sid]) >= self.queue_depth:
                reject_why = f"session queue full ({self.queue_depth} deep)"
                # the queue drains about one p50 latency an entry
                p50 = REGISTRY.histogram("server.latency_ms").percentile(50)
                retry_after = max(0.05, float(p50 or 0.0) / 1e3)
            else:
                reject_why = None
                self._queues[sid].append(ticket)
                self._cond.notify()
        if reject_why is not None:
            self._reject(ticket, reject_why, retry_after_s=retry_after)
            return ticket
        self._count("queued", sid)
        record_server(plan.name, "queued", session=sid,
                      estimate_bytes=estimate)
        return ticket

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Stop accepting work, join the workers, reject the backlog,
        drop the cached entries (releasing their charges) and flush the
        learned estimates."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._stop.set()
            self._cond.notify_all()
        for w in self._workers:
            w.join(timeout)
        with self._cond:
            backlog = [t for q in self._queues.values() for t in q]
            for q in self._queues.values():
                q.clear()
        for t in backlog:
            self._reject(t, "server shutdown")
        self.result_cache.close()
        self.spill_store.close()
        self._save_learned()

    def drain(self, timeout: Optional[float] = 30.0) -> dict:
        """Stop admitting (new submits reject with "server draining"),
        let queued and running queries finish, flush the learned
        estimates. ``{"drained": bool, "inflight": n, "queued": n}``;
        ``drained`` is False when ``timeout`` ran out first."""
        with self._cond:
            self._draining = True
        deadline = (None if timeout is None
                    else time.monotonic() + float(timeout))
        while True:
            with self._cond:
                queued = sum(len(q) for q in self._queues.values())
            with self._inflight_lock:
                inflight = len(self._inflight)
            if queued == 0 and inflight == 0:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            time.sleep(0.01)
        self.flush_learned()
        record_server("server", "drained", session="_server",
                      inflight=inflight, queued=queued)
        return {"drained": queued == 0 and inflight == 0,
                "inflight": inflight, "queued": queued}

    def flush_learned(self) -> None:
        """Persist the learned estimates now, whatever the interval."""
        self._save_learned()

    def warmup(self, top_n: Optional[int] = None) -> dict:
        """Replay the ``top_n`` costliest learned signatures (by
        estimate, descending) through their registered builders at the
        signature's rows, before traffic comes.

        The port has no executable cache: there is nothing to compile
        ahead. On the card a warm-up run builds and loads the kernels'
        library (``libsrjt_kernels.so``) if no launch has yet, and leaves
        the caching allocator holding blocks of the query's sizes, so
        the first real query pays neither. The counters keep the
        reference's names: ``server.warmup_compiled`` counts runs that
        completed. A signature without a builder is skipped
        (``server.warmup_skipped``) and a builder that raises is counted
        (``server.warmup_failed``) and logged: warm-up never raises.
        ``{"attempted", "compiled", "skipped", "failed"}``."""
        if top_n is None:
            top_n = int(get_option("server.warmup_top_n"))
        summary = {"attempted": 0, "compiled": 0, "skipped": 0, "failed": 0}
        if top_n <= 0:
            return summary
        with self._learned_lock:
            ranked = sorted(self._learned.items(), key=lambda kv: -kv[1])
        for sig, _est in ranked[:int(top_n)]:
            name, _, bucket = sig.rpartition("@")
            builder = _WARMUP_BUILDERS.get(name)
            if builder is None or not bucket.isdigit() or int(bucket) <= 0:
                summary["skipped"] += 1
                REGISTRY.counter("server.warmup_skipped").inc()
                continue
            summary["attempted"] += 1
            try:
                with spans.span(f"warmup.{name}", rows=int(bucket)):
                    builder(int(bucket))
            except Exception as exc:
                summary["failed"] += 1
                REGISTRY.counter("server.warmup_failed").inc()
                _log.warning("warmup of %s failed: %s", sig, exc)
            else:
                summary["compiled"] += 1
                REGISTRY.counter("server.warmup_compiled").inc()
        return summary

    def __enter__(self) -> "QueryServer":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        c = REGISTRY.counters("server.")
        lat = REGISTRY.histogram("server.latency_ms")
        wait = REGISTRY.histogram("server.queue_wait_ms")
        return {
            "submitted": c.get("server.submitted", 0),
            "queued": c.get("server.queued", 0),
            "admitted": c.get("server.admitted", 0),
            "served": c.get("server.served", 0),
            "rejected": c.get("server.rejected", 0),
            "cancelled": c.get("server.cancelled", 0),
            "failed": c.get("server.failed", 0),
            "latency_ms_p50": lat.percentile(50),
            "latency_ms_p95": lat.percentile(95),
            "queue_wait_ms_p50": wait.percentile(50),
            "queue_wait_ms_p95": wait.percentile(95),
            "reserved_bytes": self.limiter.used,
            "budget_bytes": self.limiter.budget,
            "pressure_crossings": self.limiter.pressure_crossings,
            "degrade_steps": REGISTRY.counter_value("degrade.step"),
            "learned_signatures": len(self._learned),
            "sessions": sorted(self._queues),
            "cache": self.result_cache.stats(),
        }

    def inspect(self) -> dict:
        """Every running query with its deepest open span, ladder tier
        and rung, held bytes, deadline remaining and age, plus queue
        depths and the limiter's watermark state: host reads only, safe
        from any thread (``telemetry top`` renders it)."""
        with self._cond:
            queues = {sid: len(q) for sid, q in self._queues.items()}
        with self._inflight_lock:
            infos = [dict(i) for i in self._inflight.values()]
        now = time.monotonic()
        inflight = []
        for info in infos:
            ticket = info["ticket"]
            sp = info.get("span")
            current = None
            if isinstance(sp, spans.Span):
                deepest = sp.deepest_open()
                current = deepest.name if deepest is not None else None
            inflight.append({
                "session": info["session"],
                "plan": info["plan"],
                "status": ticket.status,
                "tier": info["tier"],
                "rung": info["rung"],
                "steps": info["steps"],
                "chunk_rows": info["chunk_rows"],
                "held_bytes": info["held_bytes"],
                "age_s": round(now - ticket._submitted_at, 3),
                "deadline_remaining_s": ticket.cancel_token.remaining_s(),
                "current_span": current,
            })
        return {
            "inflight": sorted(inflight,
                               key=lambda q: (q["session"], -q["age_s"])),
            "queues": dict(sorted(queues.items())),
            "queued": sum(queues.values()),
            "max_inflight": self.max_inflight,
            "limiter": self.limiter.watermarks(),
            "spill": self.spill_store.stats(),
            "cache": self.result_cache.stats(),
            "closed": self._closed,
        }

    def session_stats(self, session_id: str) -> dict:
        """One session's counters, latency and queue-wait percentiles,
        and its fallback, spill, resilience and degradation records from
        the in-process ring."""
        sid = str(session_id)
        c = REGISTRY.counters("server.")
        lat = REGISTRY.histogram(f"server.latency_ms.{sid}")
        wait = REGISTRY.histogram(f"server.queue_wait_ms.{sid}")
        kinds = collections.Counter(
            "degrade_step" if rec.get("kind") == "degrade"
            and rec.get("event") == "step" else rec.get("kind")
            for rec in _ring_events() if rec.get("session") == sid)
        out = {"session": sid}
        for event in ("submitted", "queued", "admitted", "served",
                      "rejected", "cancelled", "failed"):
            out[event] = c.get(f"server.{event}.{sid}", 0)
        out.update({
            "latency_ms_p50": lat.percentile(50),
            "latency_ms_p95": lat.percentile(95),
            "queue_wait_ms_p50": wait.percentile(50),
            "queue_wait_ms_p95": wait.percentile(95),
            "fallbacks": kinds["fallback"],
            "spills": kinds["spill"],
            "resilience_events": kinds["resilience"],
            "degrade_steps": kinds["degrade_step"],
        })
        return out

    # -- internals -----------------------------------------------------------

    def _count(self, event: str, sid: str) -> None:
        REGISTRY.counter(f"server.{event}").inc()
        REGISTRY.counter(f"server.{event}.{sid}").inc()

    # -- learned admission ---------------------------------------------------

    def _read_learned_file(self) -> Optional[dict]:
        """The shared estimate file, sanitized; None when absent or
        corrupt (counted and discarded)."""
        state, corrupt = load_json(self._estimate_path)
        if corrupt is not None:
            REGISTRY.counter("server.estimate_state_discarded").inc()
            record_degrade("server.learned_estimates", "state_discarded",
                           tier="persistent", trigger="corrupt", rung=0,
                           path=self._estimate_path, reason=corrupt)
            return None
        if not isinstance(state, dict):
            return None
        return {str(k): float(v) for k, v in state.items()
                if isinstance(v, (int, float)) and float(v) > 0}

    @staticmethod
    def _merge_learned(mine: dict, disk: dict) -> dict:
        """Per signature: one side's value transfers, both sides blend
        50/50 (each is an EMA already, so repeated merges converge)."""
        merged = dict(disk)
        for sig, mine_v in mine.items():
            disk_v = merged.get(sig)
            merged[sig] = float(mine_v) if disk_v is None \
                else 0.5 * float(mine_v) + 0.5 * float(disk_v)
        return merged

    def _load_learned(self) -> None:
        if not self._estimate_path:
            return
        disk = self._read_learned_file()
        if disk is None:
            return
        with self._learned_lock:
            self._learned = self._merge_learned(self._learned, disk)

    def _save_learned(self) -> None:
        if not self._estimate_path:
            return
        with self._learned_lock:
            if not self._learned_dirty:
                return
            snapshot = dict(self._learned)
            self._learned_dirty = False
        self._last_save = time.monotonic()
        # writers serialize on a sidecar lock (the data file itself is
        # replaced) and merge what the last writer left
        lock_fh = None
        try:
            if fcntl is not None:
                lock_fh = open(self._estimate_path + ".lock", "a")
                fcntl.flock(lock_fh.fileno(), fcntl.LOCK_EX)
            merged = self._merge_learned(snapshot,
                                         self._read_learned_file() or {})
            atomic_write_json(self._estimate_path, merged)
        except OSError as exc:
            # a lost write costs the next process a cold estimate; stay
            # dirty so the next save retries
            with self._learned_lock:
                self._learned_dirty = True
            REGISTRY.counter("server.estimate_state_write_error").inc()
            _log.warning("could not persist learned estimates to %s: %s",
                         self._estimate_path, exc)
        else:
            with self._learned_lock:
                for sig, v in merged.items():
                    self._learned.setdefault(sig, float(v))
        finally:
            if lock_fh is not None:
                try:
                    fcntl.flock(lock_fh.fileno(), fcntl.LOCK_UN)
                finally:
                    lock_fh.close()

    @staticmethod
    def _plan_signature(plan: fusion.Plan, bindings: dict) -> str:
        """Plan name @ the power-of-two bucket of its total input rows:
        the granularity at which measured working sets transfer."""
        rows = sum(int(getattr(v, "num_rows", 0) or 0)
                   for v in bindings.values())
        bucket = 1 << max(rows - 1, 0).bit_length() if rows else 0
        return f"{plan.name}@{bucket}"

    def _record_actual(self, ticket: QueryTicket, bindings: dict,
                       result) -> None:
        """Blend this query's measured working set (input and result
        device bytes) into its signature's EMA; persisted at most once
        per ``server.estimate_save_interval_s``."""
        try:
            actual = table_nbytes(result.table) + sum(
                v.nbytes if isinstance(v, HostTableChunk)
                else table_nbytes(v) for v in bindings.values())
        except (TypeError, AttributeError):
            return
        sig = self._plan_signature(ticket.plan, ticket.bindings)
        alpha = min(max(float(get_option("server.estimate_alpha")), 0.0),
                    1.0)
        with self._learned_lock:
            prev = self._learned.get(sig)
            self._learned[sig] = float(actual) if prev is None \
                else (1.0 - alpha) * prev + alpha * float(actual)
            self._learned_dirty = True
        interval = float(get_option("server.estimate_save_interval_s"))
        if (interval <= 0 or self._last_save is None
                or time.monotonic() - self._last_save >= interval):
            self._save_learned()

    def _default_estimate(self, plan: fusion.Plan, bindings: dict) -> int:
        """Headroom x the learned EMA of the plan's signature, else
        headroom x the static estimate (host chunks at their exact
        device bytes)."""
        with self._learned_lock:
            learned = self._learned.get(self._plan_signature(plan, bindings))
        if learned is not None:
            return int(self.estimate_headroom * learned)
        if any(isinstance(v, HostTableChunk) for v in bindings.values()):
            base = sum(v.nbytes if isinstance(v, HostTableChunk)
                       else table_nbytes(v) for v in bindings.values())
        else:
            base = fusion.estimate_hbm_bytes(plan, bindings)
        return int(self.estimate_headroom * base)

    # -- serving -------------------------------------------------------------

    def _serve_hit(self, ticket: QueryTicket, result) -> None:
        """Resolve a submit-time cache hit: no wait, no execution; the
        query's trace is one root span with a ``cache.hit`` child."""
        sid = ticket.session
        with spans.span(f"query.{ticket.plan.name}", session=sid,
                        plan=ticket.plan.name,
                        estimate_bytes=ticket.estimate) as qspan:
            qspan.annotate(cache_hit=True)
            with spans.child("cache.hit", session=sid,
                             key=ticket.cache_key.short):
                pass
        ticket.queue_wait_s = 0.0
        ticket.latency_s = time.monotonic() - ticket._submitted_at
        lat_ms = ticket.latency_s * 1e3
        for name in ("server.latency_ms", f"server.latency_ms.{sid}"):
            REGISTRY.histogram(name).observe(lat_ms)
        for name in ("server.queue_wait_ms", f"server.queue_wait_ms.{sid}"):
            REGISTRY.histogram(name).observe(0.0)
        self._count("served", sid)
        record_server(ticket.plan.name, "served", session=sid,
                      wall_ms=lat_ms, wait_ms=0.0, cache_hit=True)
        ticket._resolve("served", value=result)

    def _reject(self, ticket: QueryTicket, reason: str,
                retry_after_s: Optional[float] = None,
                flight_record: Optional[str] = None) -> None:
        sid = ticket.session
        with self._cond:
            depth = len(self._queues.get(sid, ()))
        available = max(self.limiter.budget - self.limiter.used, 0)
        self._count("rejected", sid)
        extra = {"flight_record": flight_record} if flight_record else {}
        record_server(ticket.plan.name, "rejected", session=sid,
                      reason=reason, estimate_bytes=ticket.estimate,
                      queue_depth=depth, bytes_available=available, **extra)
        _log.warning("rejected %s (session %s): %s", ticket.plan.name, sid,
                     reason)
        ticket._resolve("rejected", exc=QueryRejected(
            f"{ticket.plan.name} (session {sid}): {reason}",
            session=sid, reason=reason, queue_depth=depth,
            bytes_requested=ticket.estimate, bytes_available=available,
            retry_after_s=retry_after_s, flight_record=flight_record))

    def _next_ticket(self) -> Optional[QueryTicket]:
        """Round-robin pop: the next session in ring order after the one
        last scheduled that has work gives up its oldest query. Blocks
        until there is work or the server stops."""
        with self._cond:
            while True:
                for _ in range(len(self._ring)):
                    sid = self._ring[0]
                    self._ring.rotate(-1)
                    q = self._queues.get(sid)
                    if q:
                        return q.popleft()
                if self._stop.is_set():
                    return None
                self._cond.wait(0.1)

    def _worker(self) -> None:
        while True:
            ticket = self._next_ticket()
            if ticket is None:
                return
            self._serve(ticket)

    def _copy_stream(self, device: torch.device):
        with self._copy_streams_lock:
            if device not in self._copy_streams:
                self._copy_streams[device] = torch.cuda.Stream(device)
            return self._copy_streams[device]

    def _stage_one(self, chunk: HostTableChunk):
        """One host chunk's copy on a pool thread: on a CUDA device on
        the server's copy stream, with the event the worker waits on."""
        if chunk.device.type != "cuda":
            return chunk.stage(), None
        stream = self._copy_stream(chunk.device)
        with torch.cuda.stream(stream):
            table = chunk.stage()
            done = torch.cuda.Event()
            done.record(stream)
        return table, done

    def _stage_bindings(self, bindings: dict) -> dict:
        """Stage the host-decoded chunk bindings on the shared decode
        pool, concurrently across tables (after admission: the
        reservation covers them). The worker's stream waits on each
        copy, and each staged tensor is recorded on that stream."""
        futs = {name: self.decode_pool.submit(self._stage_one, val)
                for name, val in bindings.items()
                if isinstance(val, HostTableChunk)}
        if not futs:
            return bindings
        staged = dict(bindings)
        for name, fut in futs.items():
            table, done = fut.result()
            if done is not None:
                consumer = torch.cuda.current_stream(
                    table.columns[0].device)
                consumer.wait_event(done)
                for x in table_tensors(table):
                    x.record_stream(consumer)
            staged[name] = table
        return staged

    def _cancelled(self, ticket: QueryTicket,
                   exc: resilience.QueryCancelled,
                   flight_record: Optional[str] = None) -> None:
        sid = ticket.session
        reason = str(exc.context.get("reason") or "cancelled")
        where = str(exc.context.get("where") or "checkpoint")
        ticket.latency_s = time.monotonic() - ticket._submitted_at
        self._count("cancelled", sid)
        extra = {"flight_record": flight_record} if flight_record else {}
        record_server(ticket.plan.name, "cancelled", session=sid,
                      reason=reason, where=where,
                      wall_ms=ticket.latency_s * 1e3, **extra)
        record_degrade(f"degrade.{ticket.plan.name}", "cancelled",
                       tier="cancelled", trigger=reason, rung=0, session=sid)
        _log.info("query %s (session %s) cancelled: %s", ticket.plan.name,
                  sid, reason)
        ticket._resolve("cancelled", exc=exc)

    def _state_snapshot(self) -> dict:
        """What a flight-recorder dump carries besides the tree."""
        with self._cond:
            queues = {sid: len(q) for sid, q in self._queues.items()}
        with self._inflight_lock:
            inflight = len(self._inflight)
        return {"limiter": self.limiter.watermarks(), "queues": queues,
                "inflight": inflight, "spill": self.spill_store.stats()}

    def _admit(self, ticket: QueryTicket, qspan) -> bool:
        """Reserve the ticket's estimate (cache entries shed first if it
        does not fit); False after the ticket was rejected."""
        sid = ticket.session
        token = ticket.cancel_token
        stop = self._stop

        class _admission_cancel:
            # wakes a blocked admission on shutdown or cancellation
            @staticmethod
            def is_set() -> bool:
                return stop.is_set() or token.cancelled()

        faults.fire("server.admit", 0, session=sid, plan=ticket.plan.name)
        if token.cancelled():
            token.check("server.admit")  # expired while queued
        if resultcache.enabled():
            self.result_cache.make_room(ticket.estimate)
        with spans.child("admission.wait", session=sid,
                         estimate_bytes=ticket.estimate) as asp:
            ok = self.limiter.reserve_blocking(
                ticket.estimate, cancel=_admission_cancel,
                timeout=self.admission_timeout_s, admission=True)
            if not ok:
                asp.set_status("failed")
        if ok:
            return True
        if token.cancelled():
            token.check("server.admit")
        qspan.set_status("failed")
        why = ("server shutdown" if self._stop.is_set()
               else f"admission timeout ({self.admission_timeout_s}s) "
                    f"waiting for {ticket.estimate} bytes")
        qspan.annotate(reason=why)
        self._reject(ticket, why,
                     retry_after_s=None if self._stop.is_set()
                     else self.admission_timeout_s,
                     flight_record=spans.dump_flight_record(
                         "rejected", root=qspan,
                         state=self._state_snapshot()))
        return False

    def _execute(self, ticket: QueryTicket, info: dict, qspan, held: int):
        """The admitted query's run: staging, the subplan rewrite, the
        degradation ladder."""
        sid = ticket.session
        token = ticket.cancel_token

        def _observe(tier: str, rung: int, steps: int,
                     chunk_rows: Optional[int]) -> None:
            info.update(tier=tier, rung=rung, steps=steps,
                        chunk_rows=chunk_rows)
            if steps and qspan.status == "ok":
                qspan.set_status("degraded")

        with session_scope(sid):
            faults.fire("server.execute", 0, session=sid,
                        plan=ticket.plan.name)
            token.check("server.execute")
            bindings = self._stage_bindings(ticket.bindings)
            runner = None if ticket.outofcore is None \
                else ticket.outofcore(bindings, self.limiter)
            run_plan, run_bindings, _ = resultcache.apply_subplans(
                self.result_cache, ticket.plan, bindings, cancel_token=token)
            # held_bytes: the parked rung discounts this query's own
            # admission reservation from its drain wait
            result = self.degrader.execute(
                degrade.DegradableQuery(run_plan, run_bindings,
                                        outofcore=runner),
                cancel_token=token, held_bytes=held, observer=_observe)
        return bindings, result

    def _served(self, ticket: QueryTicket, bindings: dict, result) -> None:
        sid = ticket.session
        ticket.latency_s = time.monotonic() - ticket._submitted_at
        lat_ms = ticket.latency_s * 1e3
        for name in ("server.latency_ms", f"server.latency_ms.{sid}"):
            REGISTRY.histogram(name).observe(lat_ms)
        self._count("served", sid)
        record_server(ticket.plan.name, "served", session=sid,
                      wall_ms=lat_ms, wait_ms=ticket.queue_wait_s * 1e3)
        self._record_actual(ticket, bindings, result)
        if ticket.cache_key is not None:
            try:
                self.result_cache.put(ticket.cache_key, result)
            except Exception as exc:
                # a failed put never fails a query that served
                REGISTRY.counter("cache.put_error").inc()
                _log.warning("result-cache put failed for %s: %s",
                             ticket.plan.name, exc)
        ticket._resolve("served", value=result)

    def _failed(self, ticket: QueryTicket, exc: BaseException,
                qspan) -> None:
        sid = ticket.session
        kind = resilience.classify(exc, seam="server.execute").__name__
        if isinstance(exc, resilience.MalformedInputError):
            # untrusted input: this one query dies, counted apart
            REGISTRY.counter("integrity.malformed_rejects").inc()
            record_integrity(ticket.plan.name, "malformed",
                             seam="integrity.ingest", session=sid)
        qspan.set_status("failed")
        qspan.annotate(error_kind=kind)
        flight = spans.dump_flight_record("failed", root=qspan,
                                          state=self._state_snapshot())
        ticket.latency_s = time.monotonic() - ticket._submitted_at
        self._count("failed", sid)
        extra = {"flight_record": flight} if flight else {}
        record_server(ticket.plan.name, "failed", session=sid,
                      error_kind=kind, reason=str(exc) or type(exc).__name__,
                      **extra)
        _log.warning("query %s (session %s) failed classified as %s",
                     ticket.plan.name, sid, kind)
        ticket._resolve("failed", exc=exc)

    def _serve(self, ticket: QueryTicket) -> None:
        sid = ticket.session
        held = 0
        info = {"ticket": ticket, "session": sid, "plan": ticket.plan.name,
                "tier": "fused", "rung": 0, "steps": 0, "chunk_rows": None,
                "held_bytes": 0, "span": None}
        with self._inflight_lock:
            self._inflight[id(ticket)] = info
        try:
            # one root span a query: every seam below attaches to it
            with spans.span(f"query.{ticket.plan.name}", session=sid,
                            plan=ticket.plan.name,
                            estimate_bytes=ticket.estimate) as qspan:
                info["span"] = qspan
                try:
                    if not self._admit(ticket, qspan):
                        return
                    held = ticket.estimate
                    info["held_bytes"] = held
                    ticket.status = "admitted"
                    ticket.queue_wait_s = (time.monotonic()
                                           - ticket._submitted_at)
                    wait_ms = ticket.queue_wait_s * 1e3
                    for name in ("server.queue_wait_ms",
                                 f"server.queue_wait_ms.{sid}"):
                        REGISTRY.histogram(name).observe(wait_ms)
                    self._count("admitted", sid)
                    record_server(ticket.plan.name, "admitted", session=sid,
                                  wait_ms=wait_ms, reserved_bytes=held)
                    bindings, result = self._execute(ticket, info, qspan,
                                                     held)
                    self._served(ticket, bindings, result)
                except resilience.QueryCancelled as exc:
                    qspan.set_status("cancelled")
                    self._cancelled(ticket, exc,
                                    flight_record=spans.dump_flight_record(
                                        "cancelled", root=qspan,
                                        state=self._state_snapshot()))
                except BaseException as exc:
                    self._failed(ticket, exc, qspan)
                    if not isinstance(exc, Exception):
                        raise  # KeyboardInterrupt is not the server's
        finally:
            with self._inflight_lock:
                self._inflight.pop(id(ticket), None)
            if held:
                self.limiter.release(held)
