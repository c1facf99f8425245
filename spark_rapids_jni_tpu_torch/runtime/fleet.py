"""The serving fleet: supervised ``QueryServer`` replicas in worker
processes, with health-checked routing and bit-identical failover
(counterpart of the reference's ``runtime/fleet.py``).

- :class:`QueryFleet`, the supervisor and router, boots N replicas as
  worker processes (``python -m spark_rapids_jni_tpu_torch.runtime.fleet
  --worker``), each on its end of a socketpair carrying length-prefixed,
  integrity-sealed pickle frames (the seal and verify of
  ``parallel/dcn.py``); a table inside a frame is a
  ``dcn.serialize_table`` blob of host bytes, rebuilt on the receiver's
  own device. No frame holds a device tensor.
- The **router** places a submit on the healthy replica with the lowest
  outstanding cost: a per-plan-signature EMA of measured wall time over
  that replica's in-flight queries, plus the queue depth its last pong
  reported.
- The **supervisor** pings every replica each
  ``fleet.heartbeat_interval_s``; silence past
  ``fleet.heartbeat_timeout_s``, a nonzero exit or a signal is a
  classified death (:func:`~.resilience.classify_worker_exit`,
  ``ReplicaDeadError``).
- **Failover**: a dead replica's in-flight queries re-dispatch to a
  healthy one under ``fleet.failover_budget``. A failed-over query must
  come back bit-identical: its result's fingerprint is checked against
  the supervisor's memo of (plan signature, input fingerprint), and a
  late duplicate from a kill-raced replica is fingerprint-checked, then
  dropped.
- **Circuit breaker**: ``fleet.quarantine_after`` crashes in a row
  quarantine a replica; every death before that restarts it after
  ``fleet.restart_backoff_s`` x ``fleet.restart_backoff_multiplier``
  ** (crashes - 1).
- **Drain and recycle** (:meth:`QueryFleet.recycle`): a planned exit
  that flushes the replica's learned estimates, never a counted death.

Where the port differs: the device of every worker is explicit. The
supervisor takes ``device=`` (None: the card, and an error without
one) and passes it on each worker's command line; a worker told
``cuda`` on a machine with no card fails its boot (a classified death),
never serves from the CPU. On the card the supervisor empties its
caching allocator and builds the kernel library before the workers
boot, so each worker only loads it. Each worker reports its kernel
launches (``ops.kernels.launches()`` of its own process) in its pong's
``load``; :meth:`QueryFleet.fresh_loads` reads a report newer than the
call.

Every decision is counted (``fleet.*`` counters) and recorded
(``record_fleet``); workers stamp ``replica=`` on their records.
"""

from __future__ import annotations

import collections
import itertools
import os
import pickle
import socket
import struct
import subprocess
import sys
import threading
import time
import weakref
from typing import Any, Dict, List, Optional

import torch

from spark_rapids_jni_tpu_torch.runtime import (
    compress,
    faults,
    fusion,
    resilience,
    resultcache,
)
from spark_rapids_jni_tpu_torch.telemetry import spans
from spark_rapids_jni_tpu_torch.telemetry.events import record_fleet
from spark_rapids_jni_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_jni_tpu_torch.utils.config import get_option
from spark_rapids_jni_tpu_torch.utils.log import get_logger
from spark_rapids_jni_tpu_torch.utils.platform import resolve_device

__all__ = ["QueryFleet", "FleetTicket", "live_fleets", "main"]

_log = get_logger("spark_rapids_jni_tpu_torch.fleet")

# test hooks, set in ONE replica's environment through per_replica_env:
# crash at boot (crash-loop drills), and a hold before a query serves, so
# a test can SIGKILL the worker mid-query: a fixed delay, or for as long
# as a file exists (at most _HOLD_MAX_S), which a drill can switch on
# and off while the worker lives
_ENV_BOOT_CRASH = "SPARK_RAPIDS_TPU_FLEET_TEST_BOOT_CRASH"
_ENV_SERVE_DELAY = "SPARK_RAPIDS_TPU_FLEET_TEST_SERVE_DELAY_MS"
_ENV_SERVE_HOLD_FILE = "SPARK_RAPIDS_TPU_FLEET_TEST_HOLD_FILE"
_HOLD_MAX_S = 120.0

# a worker's exit code when its device is unavailable (a boot failure)
_EXIT_NO_DEVICE = 4

# the directory that holds the package: the workers' import path
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_LIVE_FLEETS: "weakref.WeakSet[QueryFleet]" = weakref.WeakSet()


def live_fleets() -> List["QueryFleet"]:
    """Every open fleet in this process (telemetry ``top``)."""
    return [f for f in list(_LIVE_FLEETS) if not f._closed]


# ---------------------------------------------------------------------------
# framing: length-prefixed, integrity-sealed pickle frames
# ---------------------------------------------------------------------------


class _FrameChannel:
    """One control channel: an 8-byte little-endian length, then a
    pickle payload, sealed with ``integrity.enabled()`` (raw pickle
    frames otherwise). Sends are serialized by a lock (query threads and
    the control loop share the socket); a corrupt frame raises the
    classified ``CorruptDataError`` out of :meth:`recv`, and the caller
    treats the channel, and so the replica, as dead."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._send_lock = threading.Lock()
        self._recv_lock = threading.Lock()

    def send(self, msg: Dict[str, Any]) -> None:
        from spark_rapids_jni_tpu_torch.runtime import integrity

        blob = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
        if integrity.enabled():
            blob = integrity.seal(blob)
        REGISTRY.counter("fleet.link_bytes").inc(8 + len(blob))
        with self._send_lock:
            self._sock.sendall(struct.pack("<Q", len(blob)))
            self._sock.sendall(blob)

    def recv(self) -> Dict[str, Any]:
        from spark_rapids_jni_tpu_torch.parallel.dcn import _recv_exact
        from spark_rapids_jni_tpu_torch.runtime import integrity

        with self._recv_lock:
            # the lock only keeps whole frames together on this socket
            (length,) = struct.unpack("<Q", _recv_exact(self._sock, 8))
            framed = _recv_exact(self._sock, length)
        REGISTRY.counter("fleet.link_bytes").inc(8 + length)
        if integrity.enabled():
            framed = integrity.verify(framed, seam="integrity.wire",
                                      op="fleet.recv")
        return pickle.loads(framed)

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


def _encode_table(table) -> bytes:
    from spark_rapids_jni_tpu_torch.parallel import dcn

    if compress.seam_enabled("integrity.wire"):
        REGISTRY.counter("fleet.codec_framed_tables").inc()
    return dcn.serialize_table(table)


def _decode_table(blob: bytes, device):
    from spark_rapids_jni_tpu_torch.parallel import dcn

    return dcn.deserialize_table(blob, device=device)


# ---------------------------------------------------------------------------
# client surface
# ---------------------------------------------------------------------------


class FleetTicket:
    """One fleet query's future: :meth:`result` gives the plan's
    ``FusedResult`` (on the supervisor's device) or raises the
    classified failure. ``status`` goes queued -> dispatched -> served
    or failed; ``dispatches`` counts placements (more than one means the
    query failed over)."""

    def __init__(self, qid: int, session: str, plan_name: str):
        self.qid = qid
        self.session = session
        self.plan_name = plan_name
        self.status = "queued"
        self.replica: Optional[str] = None
        self.dispatches = 0
        self.wall_ms: Optional[float] = None
        self.fingerprint: Optional[str] = None
        self._value: Any = None
        self._exc: Optional[BaseException] = None
        self._done = threading.Event()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"fleet query {self.plan_name!r} (session {self.session}) "
                f"not done within {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._value

    def _resolve(self, status: str, value: Any = None,
                 exc: Optional[BaseException] = None) -> None:
        if self._done.is_set():
            return
        self.status = status
        self._value = value
        self._exc = exc
        self._done.set()


class _Query:
    """The supervisor's record of one query: the submit frame (built
    once, re-sent verbatim on failover) and the idempotency key.
    ``shard`` pins a partitioned query to its (table, part), which the
    cluster routes to the shard's host."""

    __slots__ = ("qid", "session", "signature", "cost_sig", "key",
                 "payload", "ticket", "deadline_ms", "shard")

    def __init__(self, qid: int, session: str, signature: str,
                 cost_sig: str, key, payload: Dict[str, Any],
                 ticket: FleetTicket, deadline_ms: int, shard=None):
        self.qid = qid
        self.session = session
        self.signature = signature
        self.cost_sig = cost_sig
        self.key = key  # resultcache.CacheKey, or None
        self.payload = payload
        self.ticket = ticket
        self.deadline_ms = deadline_ms
        self.shard = shard


class _Replica:
    """One supervised worker process and its control-channel state."""

    def __init__(self, rid: str):
        self.rid = rid
        self.state = "booting"  # booting|live|draining|dead|quarantined
        self.generation = 0
        self.proc: Optional[subprocess.Popen] = None
        self.chan: Optional[_FrameChannel] = None
        self.inflight: Dict[int, _Query] = {}
        self.consecutive_crashes = 0
        self.crashes_total = 0
        self.served_total = 0
        self.restart_at: Optional[float] = None
        self.boot_deadline: Optional[float] = None
        self.last_pong: Optional[float] = None
        self.load: Dict[str, Any] = {}
        self.boot_info: Dict[str, Any] = {}
        self.hb_seq = 0
        self.expected_exit = False
        self.live_evt = threading.Event()
        self.drained_evt = threading.Event()
        self.env_extra: Dict[str, str] = {}


class QueryFleet:
    """Supervisor and router over N ``QueryServer`` worker processes.

    ``replicas`` overrides ``fleet.replicas``; ``device`` is every
    worker's device and the device results are rebuilt on (None: the
    card, an error without one; ``"cpu"`` for the CPU); ``worker_env``
    adds environment variables to every worker, ``per_replica_env`` to
    one (by id, ``"r0"``, ``"r1"``, ...).

    Construction returns once the workers are launched; they boot in
    the background and :meth:`wait_live` waits for them. Use as a
    context manager: :meth:`close` shuts every worker down and fails
    any unresolved ticket, classified.

    Subclasses override :meth:`_launch_worker` (how a worker and its
    channel come up), :meth:`_route` (where a query lands) and
    :meth:`_extra` (identity stamped into events and errors); the
    cluster (``runtime/cluster.py``) reuses all the rest."""

    _ID_PREFIX = "r"
    is_cluster = False
    _WORKER_MODULE = "spark_rapids_jni_tpu_torch.runtime.fleet"

    def __init__(self, replicas: Optional[int] = None, *, device=None,
                 worker_env: Optional[Dict[str, str]] = None,
                 per_replica_env: Optional[Dict[str, Dict[str, str]]] = None):
        self.device = resolve_device(device)
        self.n_replicas = max(1, int(replicas if replicas is not None
                                     else get_option("fleet.replicas")))
        self._worker_env = dict(worker_env or {})
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._closed = False
        self._qid = itertools.count(1)
        self._queries: Dict[int, _Query] = {}
        # resolved queries' fingerprints (bounded), for late duplicates
        self._done_fp: "collections.OrderedDict[int, Optional[str]]" = \
            collections.OrderedDict()
        # (signature, fingerprint) -> (table, meta, table fingerprint)
        self._memo: "collections.OrderedDict[Any, tuple]" = \
            collections.OrderedDict()
        # plan signature -> EMA wall ms (the router's learned cost)
        self._cost: Dict[str, float] = {}
        self._replicas: List[_Replica] = []
        for i in range(self.n_replicas):
            r = _Replica(f"{self._ID_PREFIX}{i}")
            r.env_extra = dict((per_replica_env or {}).get(r.rid, {}))
            self._replicas.append(r)
        if self.device.type == "cuda" and torch.cuda.is_available():
            # the workers share the card: hand back this process's
            # cached blocks first, and build the kernel library once so
            # that each worker only loads it
            from spark_rapids_jni_tpu_torch.ops.kernels import _build

            torch.cuda.empty_cache()
            _build.library()
        _LIVE_FLEETS.add(self)
        for r in self._replicas:
            self._spawn(r)
        self._hb_stop = threading.Event()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True, name="fleet-heartbeat")
        self._hb_thread.start()

    # -- worker lifecycle ----------------------------------------------------

    def _worker_environment(self, r: _Replica) -> Dict[str, str]:
        from spark_rapids_jni_tpu_torch.runtime import integrity

        env = dict(os.environ)
        path = env.get("PYTHONPATH", "")
        env["PYTHONPATH"] = (_PKG_ROOT + os.pathsep + path) if path \
            else _PKG_ROOT
        # option state held in this process's overrides (options set in
        # the environment are inherited already)
        env["SPARK_RAPIDS_TPU_TELEMETRY_REPLICA"] = r.rid
        env["SPARK_RAPIDS_TPU_INTEGRITY"] = "1" if integrity.enabled() else "0"
        for opt, var in (
            ("telemetry.enabled", "SPARK_RAPIDS_TPU_TELEMETRY_ENABLED"),
            ("telemetry.path", "SPARK_RAPIDS_TPU_TELEMETRY_PATH"),
            ("server.estimate_path", "SPARK_RAPIDS_TPU_SERVER_ESTIMATE_PATH"),
        ):
            val = get_option(opt)
            if val:
                env[var] = "1" if val is True else str(val)
        env.update(self._worker_env)
        env.update(r.env_extra)
        return env

    def _extra(self, r: _Replica) -> Dict[str, Any]:
        """Identity context for events and errors (the cluster stamps
        ``host=``)."""
        return {}

    def _launch_worker(self, r: _Replica):
        """Create the worker process and its control channel; returns
        ``(proc, chan)``, ``chan`` None when it attaches later (the
        cluster's dial-back)."""
        parent_sock, child_sock = socket.socketpair()
        child_fd = child_sock.fileno()
        os.set_inheritable(child_fd, True)
        cmd = [sys.executable, "-m", self._WORKER_MODULE, "--worker",
               "--fd", str(child_fd), "--replica", r.rid,
               "--device", str(self.device)]
        proc = subprocess.Popen(cmd, pass_fds=(child_fd,),
                                env=self._worker_environment(r))
        child_sock.close()
        return proc, _FrameChannel(parent_sock)

    def _attach_channel(self, r: _Replica, chan: _FrameChannel,
                        gen: int) -> None:
        """Bind a live channel to a replica generation and start its
        receive loop."""
        r.chan = chan
        threading.Thread(
            target=self._recv_loop, args=(r, chan, gen), daemon=True,
            name=f"fleet-recv-{r.rid}-g{gen}").start()

    def _spawn(self, r: _Replica) -> None:
        """Boot (or re-boot) one worker on a fresh channel."""
        r.generation += 1
        gen = r.generation
        r.state = "booting"
        r.expected_exit = False
        r.live_evt.clear()
        r.drained_evt.clear()
        r.last_pong = None
        r.load = {}
        r.boot_info = {}
        r.chan = None
        r.boot_deadline = (time.monotonic()
                           + float(get_option("fleet.worker_boot_timeout_s")))
        r.proc, chan = self._launch_worker(r)
        REGISTRY.counter("fleet.boots").inc()
        record_fleet("fleet.spawn", "boot", replica=r.rid, pid=r.proc.pid,
                     generation=gen, **self._extra(r))
        if chan is not None:
            self._attach_channel(r, chan, gen)

    def _restart(self, r: _Replica) -> None:
        REGISTRY.counter("fleet.restarts").inc()
        record_fleet("fleet.restart", "restart", replica=r.rid,
                     crashes=r.consecutive_crashes, **self._extra(r))
        self._spawn(r)

    # -- receive path --------------------------------------------------------

    def _recv_loop(self, r: _Replica, chan: _FrameChannel, gen: int) -> None:
        while True:
            try:
                msg = chan.recv()
            except BaseException as exc:
                self._reap(r, gen, exc)
                return
            t = msg.get("t")
            if t == "boot_ok":
                with self._cond:
                    if r.generation == gen and r.state == "booting":
                        r.state = "live"
                        r.last_pong = time.monotonic()
                        r.boot_info = {k: v for k, v in msg.items()
                                       if k != "t"}
                        r.live_evt.set()
                        self._cond.notify_all()
                record_fleet("fleet.spawn", "live", replica=r.rid,
                             pid=msg.get("pid", 0),
                             device=str(msg.get("device", "")),
                             **self._extra(r))
            elif t == "pong":
                with self._lock:
                    r.last_pong = time.monotonic()
                    r.load = dict(msg.get("load") or {})
            elif t == "result":
                self._on_result(r, gen, msg)
            elif t == "drained":
                r.drained_evt.set()
            elif t == "bye":
                pass  # the shutdown's ack: the exit is expected
            else:
                self._on_worker_msg(r, gen, msg)

    def _on_worker_msg(self, r: _Replica, gen: int,
                       msg: Dict[str, Any]) -> None:
        """Hook for control messages beyond the base protocol."""

    def _reap(self, r: _Replica, gen: int, exc: BaseException) -> None:
        """The control channel closed: reap the worker's exit status and
        classify it."""
        with self._lock:
            if r.generation != gen:
                return  # a stale receiver from before a restart
            expected = r.expected_exit
        rc: Optional[int] = None
        if r.proc is not None:
            try:
                rc = r.proc.wait(timeout=2.0)
            except subprocess.TimeoutExpired:
                rc = None
        if expected and (rc is None or rc == 0):
            return  # a planned recycle or shutdown, not a death
        try:
            faults.fire("fleet.worker_exit", gen, replica=r.rid,
                        returncode=-1 if rc is None else rc)
        except BaseException as injected:
            exc = injected
        classified = (exc if isinstance(exc, resilience.ResilienceError)
                      else resilience.classify_worker_exit(
                          rc, replica=r.rid, **self._extra(r)))
        if classified is not exc and classified.__cause__ is None:
            classified.__cause__ = exc
        self._on_replica_death(r, gen, classified)

    def _on_result(self, r: _Replica, gen: int, msg: Dict[str, Any]) -> None:
        qid = int(msg.get("qid", 0))
        with self._lock:
            q = r.inflight.pop(qid, None) if r.generation == gen else None
            if q is None:
                q = self._queries.get(qid)
        if q is None:
            # resolved while this replica raced its kill: a late
            # duplicate, checked against the recorded fingerprint and
            # dropped, never served twice
            self._drop_duplicate(r, qid, msg)
            return
        if str(msg.get("status", "failed")) != "served":
            # a query failure the replica reports is deterministic: never
            # failed over
            exc = self._rebuild_error(msg, r.rid)
            REGISTRY.counter("fleet.failed").inc()
            record_fleet("fleet.result", "failed", replica=r.rid, qid=qid,
                         error_kind=str(msg.get("error_kind", "?")))
            self._finish_query(q, str(msg.get("status", "failed")), exc=exc)
            return
        try:
            table = _decode_table(msg["table"], self.device)
            fp = resultcache.table_fingerprint(table)
        except BaseException as exc:
            self._fail_query(q, resilience.classify(
                exc, seam="fleet.dispatch")(
                    f"fleet: result decode failed for query "
                    f"{q.ticket.plan_name}: {exc}", qid=qid,
                    replica=r.rid))
            return
        result = fusion.FusedResult(table, resultcache._rehydrate_meta(
            dict(msg.get("meta") or {}), self.device))
        wall_ms = float(msg.get("wall_ms") or 0.0)
        mismatch = False
        with self._lock:
            r.served_total += 1
            r.consecutive_crashes = 0
            self._learn_cost(q.cost_sig, wall_ms)
            if q.key is not None:
                prev = self._memo.get(q.key)
                if prev is not None and prev[2] != fp:
                    mismatch = True
                else:
                    self._memo_put(q.key, (table, result.meta, fp))
        if mismatch:
            REGISTRY.counter("fleet.identity_mismatch").inc()
            record_fleet("fleet.result", "identity_mismatch",
                         replica=r.rid, qid=qid, signature=q.key.signature)
            self._fail_query(q, resilience.CorruptDataError(
                f"fleet: replica {r.rid} returned a result whose "
                f"fingerprint differs from the recorded one for the same "
                f"(signature, input fingerprint) key: determinism "
                f"violated", qid=qid, replica=r.rid,
                signature=q.key.signature))
            return
        q.ticket.replica = r.rid
        q.ticket.wall_ms = wall_ms
        q.ticket.fingerprint = fp
        REGISTRY.counter("fleet.served").inc()
        REGISTRY.counter(f"fleet.served.{r.rid}").inc()
        record_fleet("fleet.result", "served", replica=r.rid, qid=qid,
                     wall_ms=wall_ms)
        self._finish_query(q, "served", value=result, fp=fp)

    def _drop_duplicate(self, r: _Replica, qid: int,
                        msg: Dict[str, Any]) -> None:
        REGISTRY.counter("fleet.duplicate_drops").inc()
        record_fleet("fleet.result", "duplicate_drop", replica=r.rid,
                     qid=qid)
        if str(msg.get("status")) != "served":
            return
        with self._lock:
            want = self._done_fp.get(qid)
        if want is None:
            return
        try:
            fp = resultcache.table_fingerprint(
                _decode_table(msg["table"], self.device))
        except BaseException:
            return  # a torn duplicate from a dying replica proves nothing
        if fp != want:
            REGISTRY.counter("fleet.identity_mismatch").inc()
            record_fleet("fleet.result", "identity_mismatch",
                         replica=r.rid, qid=qid)

    @staticmethod
    def _rebuild_error(msg: Dict[str, Any], rid: str) -> BaseException:
        kind = str(msg.get("error_kind", "FatalExecutionError"))
        message = str(msg.get("message", "replica reported failure"))
        if kind == "QueryRejected":
            from spark_rapids_jni_tpu_torch.runtime.server import QueryRejected

            return QueryRejected(message,
                                 reason=str(msg.get("reason", "")),
                                 retry_after_s=msg.get("retry_after_s"))
        cls = getattr(resilience, kind, None)
        if not (isinstance(cls, type)
                and issubclass(cls, resilience.ResilienceError)):
            cls = resilience.FatalExecutionError
        return cls(message, replica=rid)

    def _finish_query(self, q: _Query, status: str, *, value: Any = None,
                      exc: Optional[BaseException] = None,
                      fp: Optional[str] = None) -> None:
        with self._lock:
            self._queries.pop(q.qid, None)
            self._done_fp[q.qid] = fp
            while len(self._done_fp) > 4096:
                self._done_fp.popitem(last=False)
            q.payload = None  # free the serialized bindings
        q.ticket._resolve(status, value=value, exc=exc)

    def _fail_query(self, q: _Query, exc: BaseException) -> None:
        REGISTRY.counter("fleet.failed").inc()
        self._finish_query(q, "failed", exc=exc)

    # -- death, failover, quarantine ----------------------------------------

    def _on_replica_death(self, r: _Replica, gen: int,
                          classified: BaseException) -> None:
        with self._lock:
            if r.generation != gen or r.state in ("dead", "quarantined"):
                return
            if r.expected_exit:
                return  # a planned recycle or shutdown racing us
            r.state = "dead"
            r.live_evt.clear()
            r.consecutive_crashes += 1
            r.crashes_total += 1
            crashes = r.consecutive_crashes
            orphans = list(r.inflight.values())
            r.inflight.clear()
        REGISTRY.counter("fleet.replica_deaths").inc()
        REGISTRY.counter(f"fleet.replica_deaths.{r.rid}").inc()
        flight = spans.dump_flight_record(
            "replica_death",
            state={"replica": r.rid, "cause": str(classified),
                   "error_kind": type(classified).__name__,
                   "consecutive_crashes": crashes,
                   "inflight_qids": [q.qid for q in orphans],
                   **self._extra(r)})
        record_fleet("fleet.supervise", "replica_death", replica=r.rid,
                     error_kind=type(classified).__name__,
                     cause=str(classified), inflight=len(orphans),
                     **self._extra(r),
                     **({"flight_record": flight} if flight else {}))
        _log.warning("fleet: replica %s died (%s); %d in flight to fail "
                     "over", r.rid, classified, len(orphans))
        if r.chan is not None:
            r.chan.close()
        if r.proc is not None and r.proc.poll() is None:
            r.proc.kill()
        quarantine_after = max(1, int(get_option("fleet.quarantine_after")))
        with self._lock:
            if crashes >= quarantine_after:
                r.state = "quarantined"
                r.restart_at = None
            else:
                backoff = (float(get_option("fleet.restart_backoff_s"))
                           * float(get_option(
                               "fleet.restart_backoff_multiplier"))
                           ** (crashes - 1))
                r.restart_at = time.monotonic() + backoff
        if r.state == "quarantined":
            REGISTRY.counter("fleet.quarantines").inc()
            record_fleet("fleet.supervise", "quarantine", replica=r.rid,
                         crashes=crashes, **self._extra(r))
            _log.warning("fleet: replica %s quarantined after %d "
                         "consecutive crashes", r.rid, crashes)
        if orphans:
            # off the supervision thread: a re-dispatch may wait for a
            # booting replacement, and the heartbeat loop must not
            threading.Thread(
                target=self._failover_batch,
                args=(r.rid, orphans, classified), daemon=True,
                name=f"fleet-failover-{r.rid}").start()

    def _failover_batch(self, dead_rid: str, orphans: List[_Query],
                        cause: BaseException) -> None:
        budget = max(0, int(get_option("fleet.failover_budget")))
        for q in orphans:
            if q.ticket.done():
                continue
            if q.ticket.dispatches > budget:
                self._fail_query(q, resilience.ReplicaDeadError(
                    f"fleet: query {q.ticket.plan_name} lost its replica "
                    f"{q.ticket.dispatches} times: failover budget "
                    f"({budget}) exhausted", qid=q.qid,
                    dispatches=q.ticket.dispatches))
                continue
            REGISTRY.counter("fleet.failovers").inc()
            record_fleet("fleet.supervise", "failover", replica=dead_rid,
                         qid=q.qid, attempt=q.ticket.dispatches)
            try:
                self._dispatch(q)
            except BaseException as exc:
                self._fail_query(q, exc if isinstance(
                    exc, resilience.ResilienceError)
                    else resilience.classify(exc, seam="fleet.dispatch")(
                        f"fleet: failover dispatch failed: {exc}",
                        qid=q.qid))

    # -- heartbeat ------------------------------------------------------------

    def _heartbeat_loop(self) -> None:
        interval = max(0.05, float(get_option("fleet.heartbeat_interval_s")))
        while not self._hb_stop.wait(interval):
            timeout = float(get_option("fleet.heartbeat_timeout_s"))
            now = time.monotonic()
            for r in list(self._replicas):
                with self._lock:
                    state, gen = r.state, r.generation
                # a draining worker sits in srv.drain() and legitimately
                # does not answer: recycle() owns its fate
                if state == "live":
                    r.hb_seq += 1
                    try:
                        faults.fire("fleet.heartbeat", r.hb_seq,
                                    replica=r.rid)
                        r.chan.send({"t": "ping", "seq": r.hb_seq})
                    except BaseException as exc:
                        self._declare_dead(r, gen, exc)
                        continue
                    last = r.last_pong
                    if last is not None and now - last > timeout:
                        REGISTRY.counter("fleet.heartbeats_missed").inc()
                        self._declare_dead(r, gen, None)
                elif state == "booting":
                    # a worker that exited before its channel attached
                    # (the cluster's dial-back) is dead now, not at its
                    # boot deadline
                    exited = (r.chan is None and r.proc is not None
                              and r.proc.poll() is not None)
                    if exited or (r.boot_deadline is not None
                                  and now > r.boot_deadline):
                        self._declare_dead(r, gen, None)
                elif state == "dead":
                    with self._lock:
                        due = r.restart_at is not None and now >= r.restart_at
                        if due:
                            r.restart_at = None
                    if due:
                        self._restart(r)

    def _declare_dead(self, r: _Replica, gen: int,
                      exc: Optional[BaseException]) -> None:
        """A liveness verdict of the supervisor (missed pongs, a failed
        send, a boot timeout): classify, then kill the process."""
        if exc is None or not isinstance(exc, resilience.ResilienceError):
            rc = r.proc.poll() if r.proc is not None else None
            if rc is None and exc is not None and r.proc is not None:
                # a failed send: the process is most likely exiting, so
                # reap it for its real exit shape
                try:
                    rc = r.proc.wait(timeout=2.0)
                except subprocess.TimeoutExpired:
                    rc = None
            classified = resilience.classify_worker_exit(
                rc, replica=r.rid, seam="fleet.heartbeat", **self._extra(r))
            if exc is not None and classified.__cause__ is None:
                classified.__cause__ = exc
        else:
            classified = exc
        self._on_replica_death(r, gen, classified)

    # -- routing -------------------------------------------------------------

    def _learn_cost(self, sig: str, wall_ms: float) -> None:
        if wall_ms <= 0:
            return
        prev = self._cost.get(sig)
        self._cost[sig] = wall_ms if prev is None \
            else 0.6 * prev + 0.4 * wall_ms

    def _placement_cost(self, r: _Replica) -> float:
        default = (sum(self._cost.values()) / len(self._cost)
                   if self._cost else 50.0)
        cost = sum(self._cost.get(q.cost_sig, default)
                   for q in r.inflight.values())
        # the replica's own backlog (its last pong) covers work placed
        # around the router
        return cost + default * float(r.load.get("queued", 0) or 0)

    def _pick_replica(self, deadline: float) -> Optional[_Replica]:
        while True:
            with self._cond:
                live = [r for r in self._replicas if r.state == "live"]
                if live:
                    picked = min(live, key=lambda r: (
                        self._placement_cost(r), r.rid))
                    REGISTRY.counter("fleet.placements").inc()
                    REGISTRY.counter(f"fleet.placements.{picked.rid}").inc()
                    return picked
                if self._closed or time.monotonic() >= deadline:
                    return None
                self._cond.wait(timeout=min(
                    0.05, max(0.0, deadline - time.monotonic())) or 0.01)

    def _route(self, q: _Query, deadline: float) -> Optional[_Replica]:
        """Routing hook: the replica this placement lands on (the
        cluster routes shard-pinned queries to the shard's host)."""
        return self._pick_replica(deadline)

    def _dispatch(self, q: _Query) -> None:
        """Place one query on the routed healthy replica and send its
        frame; raises classified when no replica takes it in time."""
        deadline = time.monotonic() + float(
            get_option("fleet.dispatch_timeout_s"))
        while True:
            r = self._route(q, deadline)
            if r is None:
                raise resilience.ReplicaDeadError(
                    "fleet: no healthy replica to dispatch to within "
                    f"{get_option('fleet.dispatch_timeout_s')}s",
                    qid=q.qid, seam="fleet.dispatch")
            with self._lock:
                gen = r.generation
                if r.state != "live":
                    continue
                r.inflight[q.qid] = q
                q.ticket.dispatches += 1
                q.ticket.replica = r.rid
                q.ticket.status = "dispatched"
            try:
                with spans.span("fleet.dispatch", replica=r.rid,
                                plan=q.ticket.plan_name, qid=q.qid):
                    faults.fire("fleet.dispatch", q.ticket.dispatches,
                                replica=r.rid, qid=q.qid)
                    r.chan.send(q.payload)
            except BaseException as exc:
                with self._lock:
                    r.inflight.pop(q.qid, None)
                classified = (exc if isinstance(
                    exc, resilience.ResilienceError)
                    else resilience.classify(exc, seam="fleet.dispatch")(
                        f"fleet: dispatch to {r.rid} failed: {exc}",
                        qid=q.qid, replica=r.rid))
                # a failed send means the replica is gone: its other
                # queries fail over too
                self._declare_dead(r, gen, classified)
                if not resilience.is_transient(classified,
                                               seam="fleet.dispatch"):
                    raise classified
                budget = max(0, int(get_option("fleet.failover_budget")))
                if q.ticket.dispatches > budget:
                    raise resilience.ReplicaDeadError(
                        f"fleet: query {q.ticket.plan_name} lost "
                        f"{q.ticket.dispatches} replicas at dispatch: "
                        f"failover budget ({budget}) exhausted",
                        qid=q.qid) from classified
                continue
            REGISTRY.counter("fleet.dispatched").inc()
            REGISTRY.counter(f"fleet.dispatched.{r.rid}").inc()
            return

    # -- client surface ------------------------------------------------------

    def wait_live(self, n: Optional[int] = None,
                  timeout: float = 120.0) -> int:
        """Wait until ``n`` (default all) replicas serve; returns the
        live count (short on timeout or quarantine)."""
        want = self.n_replicas if n is None else int(n)
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                live = sum(1 for r in self._replicas if r.state == "live")
                quarantined = sum(1 for r in self._replicas
                                  if r.state == "quarantined")
                if live >= want or time.monotonic() >= deadline:
                    return live
                if live >= self.n_replicas - quarantined:
                    return live
                self._cond.wait(timeout=0.1)

    def submit(self, session_id: str, plan: fusion.Plan, bindings: dict, *,
               deadline_ms: Optional[int] = None,
               cache_fingerprint: Optional[str] = None) -> FleetTicket:
        """Route one query to a replica. Returns a :class:`FleetTicket`
        at once; placement failures, deaths past the failover budget and
        replica-reported failures resolve it, classified. The bindings
        travel with the submit, as host bytes."""
        return self._submit(session_id, plan, bindings,
                            deadline_ms=deadline_ms,
                            cache_fingerprint=cache_fingerprint)

    def _submit(self, session_id: str, plan: fusion.Plan, bindings: dict, *,
                binding_refs: Optional[Dict[str, str]] = None,
                shard=None,
                sig_bindings: Optional[Dict[str, Any]] = None,
                deadline_ms: Optional[int] = None,
                cache_fingerprint: Optional[str] = None) -> FleetTicket:
        """The shared submit. ``binding_refs`` maps binding names to
        tables registered on the worker (the cluster's ship-the-query
        path); ``shard`` pins the query to its (table, part);
        ``sig_bindings`` stands in for ref-bound tables when the memo key
        and cost signature are derived (both read only ``num_rows``)."""
        if self._closed:
            raise RuntimeError("fleet is closed")
        qid = next(self._qid)
        sid = str(session_id)
        ticket = FleetTicket(qid, sid, plan.name)
        REGISTRY.counter("fleet.submitted").inc()
        key_bindings = (bindings if not sig_bindings
                        else {**bindings, **sig_bindings})
        key = None
        if int(get_option("fleet.result_memo_entries")) > 0:
            try:
                key = resultcache.cache_key(plan, key_bindings,
                                            fingerprint=cache_fingerprint)
            except (ValueError, KeyError, TypeError):
                key = None  # not fingerprintable: served, never memoized
        if key is not None:
            with self._lock:
                hit = self._memo.get(key)
                if hit is not None:
                    self._memo.move_to_end(key)
            if hit is not None:
                table, meta, fp = hit
                REGISTRY.counter("fleet.memo_hits").inc()
                record_fleet("fleet.submit", "memo_hit",
                             replica="supervisor", qid=qid,
                             signature=key.signature)
                ticket.fingerprint = fp
                ticket.replica = "supervisor"
                ticket._resolve("served",
                                value=fusion.FusedResult(table, dict(meta)))
                return ticket
        try:
            payload = {
                "t": "submit", "qid": qid, "session": sid,
                "plan": pickle.dumps(plan, protocol=pickle.HIGHEST_PROTOCOL),
                "bindings": {k: _encode_table(v)
                             for k, v in bindings.items()},
                "binding_refs": dict(binding_refs or {}),
                "deadline_ms": deadline_ms,
                "cache_fingerprint": cache_fingerprint,
            }
        except BaseException as exc:
            ticket._resolve("failed", exc=resilience.MalformedInputError(
                f"fleet: query {plan.name} is not shippable to a replica "
                f"(plan or bindings failed to serialize): {exc}", qid=qid))
            return ticket
        from spark_rapids_jni_tpu_torch.runtime.server import QueryServer

        q = _Query(qid, sid, key.signature if key is not None else "",
                   QueryServer._plan_signature(plan, key_bindings), key,
                   payload, ticket, int(deadline_ms or 0), shard=shard)
        with self._lock:
            self._queries[qid] = q
        try:
            self._dispatch(q)
        except BaseException as exc:
            self._fail_query(q, exc if isinstance(
                exc, resilience.ResilienceError)
                else resilience.classify(exc, seam="fleet.dispatch")(
                    f"fleet: dispatch failed: {exc}", qid=qid))
        return ticket

    def recycle(self, rid: str, timeout: float = 60.0) -> bool:
        """Drain one replica (stop admitting, finish in flight, flush
        its learned estimates), let it exit cleanly and boot a successor:
        a planned exit, no crash counted. True when the successor is
        live."""
        r = self._find(rid)
        with self._lock:
            if r.state != "live":
                return False
            r.state = "draining"
            gen = r.generation
        record_fleet("fleet.supervise", "drain", replica=rid)
        REGISTRY.counter("fleet.drains").inc()
        try:
            r.chan.send({"t": "drain", "timeout": timeout})
            if not r.drained_evt.wait(timeout):
                self._declare_dead(r, gen, None)
                return False
            with self._lock:
                r.expected_exit = True
            r.chan.send({"t": "shutdown"})
        except BaseException as exc:
            self._declare_dead(r, gen, exc)
            return False
        try:
            r.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            r.proc.kill()
        with self._lock:
            r.state = "dead"  # planned: no crash counted
        self._restart(r)
        return bool(r.live_evt.wait(
            float(get_option("fleet.worker_boot_timeout_s"))))

    def _find(self, rid: str) -> _Replica:
        for r in self._replicas:
            if r.rid == rid:
                return r
        raise KeyError(f"no replica {rid!r}")

    def inspect(self) -> dict:
        """Every replica's state, load, boot report (pid, device) and
        history, and the router's and memo's state; host reads only."""
        with self._lock:
            replicas = []
            for r in self._replicas:
                age = (None if r.last_pong is None
                       else time.monotonic() - r.last_pong)
                replicas.append({
                    "replica": r.rid, "state": r.state,
                    "pid": r.proc.pid if r.proc is not None else None,
                    "generation": r.generation,
                    "device": r.boot_info.get("device"),
                    "inflight": len(r.inflight),
                    "served": r.served_total,
                    "crashes": r.crashes_total,
                    "consecutive_crashes": r.consecutive_crashes,
                    "last_pong_age_s": age,
                    "restart_in_s": (
                        None if r.restart_at is None
                        else max(0.0, r.restart_at - time.monotonic())),
                    "load": dict(r.load),
                })
            c = REGISTRY.counters("fleet.")
            return {
                "fleet": True,
                "device": str(self.device),
                "replicas": replicas,
                "pending_queries": len(self._queries),
                "memo_entries": len(self._memo),
                "learned_signatures": len(self._cost),
                "counters": {k: v for k, v in sorted(c.items())
                             if k.count(".") == 1},
            }

    def fresh_loads(self, timeout: float = 10.0) -> Dict[str, dict]:
        """Each live replica's ``load`` from a pong received after this
        call (its in-flight and queued queries, limiter use, leaked
        bytes, kernel launches since boot); waits at most ``timeout``
        for the pongs, then raises :class:`TimeoutError` naming the
        replicas that sent none (a stale load would hide work)."""
        t0 = time.monotonic()
        deadline = t0 + timeout
        while True:
            with self._lock:
                live = [r for r in self._replicas if r.state == "live"]
                stale = [r.rid for r in live
                         if r.last_pong is None or r.last_pong <= t0]
                if not stale:
                    return {r.rid: dict(r.load) for r in live}
            if time.monotonic() >= deadline:
                raise TimeoutError(f"no pong within {timeout} s from {stale}")
            time.sleep(0.02)

    def leaked_bytes(self) -> int:
        """The live replicas' last-reported leaked reservation bytes
        (limiter use beyond the result cache's resident charge): zero
        once every query has resolved. Read after a fresh pong
        (:meth:`fresh_loads`, or one heartbeat interval)."""
        with self._lock:
            return sum(int(r.load.get("leaked", 0) or 0)
                       for r in self._replicas if r.state == "live")

    def _memo_put(self, key, entry: tuple) -> None:
        cap = int(get_option("fleet.result_memo_entries"))
        if cap <= 0:
            return
        self._memo[key] = entry
        self._memo.move_to_end(key)
        while len(self._memo) > cap:
            self._memo.popitem(last=False)

    def close(self, timeout: float = 30.0) -> None:
        """Shut every worker down; unresolved tickets fail classified."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._hb_stop.set()
        self._hb_thread.join(timeout=5.0)
        for r in self._replicas:
            with self._lock:
                r.expected_exit = True
            if r.chan is not None and r.state in ("live", "draining"):
                try:
                    r.chan.send({"t": "shutdown"})
                except OSError:
                    pass
            elif r.proc is not None and r.proc.poll() is None:
                # still booting (a restart racing the close): it would
                # serve nothing, so it is not waited for
                r.proc.kill()
        for r in self._replicas:
            if r.proc is not None:
                try:
                    r.proc.wait(timeout=timeout)
                except subprocess.TimeoutExpired:
                    r.proc.kill()
                    r.proc.wait(timeout=5.0)
            if r.chan is not None:
                r.chan.close()
            with self._lock:
                r.state = "dead"
        with self._lock:
            pending = list(self._queries.values())
        for q in pending:
            self._finish_query(q, "failed", exc=resilience.ReplicaDeadError(
                "fleet closed before the query completed", qid=q.qid))

    def __enter__(self) -> "QueryFleet":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


# ---------------------------------------------------------------------------
# worker side
# ---------------------------------------------------------------------------


def _worker_load(srv) -> Dict[str, Any]:
    from spark_rapids_jni_tpu_torch.ops import kernels

    with srv._inflight_lock:
        inflight = len(srv._inflight)
    with srv._cond:
        queued = sum(len(dq) for dq in srv._queues.values())
    used = srv.limiter.used
    # at idle the limiter holds exactly the result cache's resident
    # charge: anything beyond it is a reservation a query failed to
    # release
    return {"inflight": inflight, "queued": queued, "used": used,
            "leaked": max(0, used - srv.result_cache.evictable_bytes),
            "launches": kernels.launches()}


def _test_hold() -> None:
    """The test hooks' hold of a query before it serves (a mid-query
    kill's window): the fixed delay, then while the hold file exists."""
    delay_ms = float(os.environ.get(_ENV_SERVE_DELAY, "0") or 0.0)
    if delay_ms > 0:
        time.sleep(delay_ms / 1e3)
    hold = os.environ.get(_ENV_SERVE_HOLD_FILE)
    if hold:
        deadline = time.monotonic() + _HOLD_MAX_S
        while os.path.exists(hold) and time.monotonic() < deadline:
            time.sleep(0.01)


def _serve_one(chan: _FrameChannel, srv, msg: Dict[str, Any],
               replica: str, device: torch.device) -> None:
    qid = msg["qid"]
    out: Dict[str, Any] = {"t": "result", "qid": qid}
    try:
        _test_hold()
        plan = pickle.loads(msg["plan"])
        bindings = {k: _decode_table(v, device)
                    for k, v in (msg.get("bindings") or {}).items()}
        # the cluster's ship-the-query path: bindings resolved from
        # tables registered on this worker
        for name, reg in (msg.get("binding_refs") or {}).items():
            try:
                bindings[name] = srv.registered_table(reg)
            except KeyError:
                raise resilience.MalformedInputError(
                    f"fleet: submit references registered table {reg!r} "
                    f"which is not resident on replica {replica}",
                    replica=replica, binding=name) from None
        t0 = time.monotonic()
        ticket = srv.submit(
            msg["session"], plan, bindings,
            deadline_ms=msg.get("deadline_ms"),
            cache_fingerprint=msg.get("cache_fingerprint"))
        result = ticket.result()
        wall_ms = (time.monotonic() - t0) * 1e3
        out.update({
            "status": "served",
            "table": _encode_table(result.table),
            "meta": resultcache._snap_meta(result.meta),
            "wall_ms": wall_ms,
        })
    except BaseException as exc:
        kind = type(exc).__name__
        if not isinstance(exc, resilience.ResilienceError) \
                and kind != "QueryRejected":
            kind = resilience.classify(exc).__name__
        out.update({
            "status": {"QueryRejected": "rejected",
                       "QueryCancelled": "cancelled"}.get(kind, "failed"),
            "error_kind": kind,
            "message": str(exc),
            "reason": str(getattr(exc, "reason", "") or ""),
            "retry_after_s": getattr(exc, "retry_after_s", None),
        })
    try:
        chan.send(out)
    except OSError:
        pass  # the supervisor is gone; this worker is about to be reaped


def _register_one(chan: _FrameChannel, srv, msg: Dict[str, Any],
                  replica: str, device: torch.device) -> None:
    """Install one shipped shard in this worker's registered tables and
    acknowledge it with its fingerprint (which the supervisor checks
    against the one taken before the bytes crossed the wire)."""
    name = str(msg.get("name", ""))
    out: Dict[str, Any] = {"t": "registered", "name": name}
    try:
        table = _decode_table(msg["table"], device)
        out["fingerprint"] = srv.register_table(name, table)
        out["rows"] = int(table.num_rows)
    except BaseException as exc:
        kind = type(exc).__name__
        if not isinstance(exc, resilience.ResilienceError):
            kind = resilience.classify(exc).__name__
        out.update({"error_kind": kind, "message": str(exc)})
    try:
        chan.send(out)
    except OSError:
        pass


def _boot_device(device: str) -> torch.device:
    """The worker's device; a CUDA device needs a card (no CPU
    fallback), and there the kernel library (built by the supervisor)
    is loaded before the worker reports ready."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"worker told to run on {device} but no CUDA device is "
                "available")
        if dev.index is not None:
            torch.cuda.set_device(dev)
        torch.empty(1, device=dev)  # the context, before boot_ok
        from spark_rapids_jni_tpu_torch.ops.kernels import _build

        _build.library()
    return dev


def _boot_report(dev: torch.device) -> Dict[str, Any]:
    info: Dict[str, Any] = {"t": "boot_ok", "pid": os.getpid(),
                            "device": str(dev)}
    if dev.type == "cuda":
        info["device_name"] = torch.cuda.get_device_name(dev)
    info["modules"] = sorted({m.split(".")[0] for m in sys.modules})
    return info


def _worker_main(fd: int, replica: str, device: str) -> int:
    """A replica: one in-process QueryServer behind the frame channel."""
    if os.environ.get(_ENV_BOOT_CRASH):
        return 3  # test hook: crash-loop at boot
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM, fileno=fd)
    try:
        dev = _boot_device(device)
    except RuntimeError as exc:
        print(f"fleet worker {replica}: {exc}", file=sys.stderr)
        sock.close()
        return _EXIT_NO_DEVICE
    return _worker_loop(_FrameChannel(sock), replica, dev)


def _worker_loop(chan: _FrameChannel, replica: str, device: torch.device,
                 extensions=None) -> int:
    """The control loop behind a connected channel (a socketpair for the
    fleet, a dialed-back TCP socket for the cluster). The main thread
    answers pings inline, so liveness tracks the control plane; each
    submit serves on its own thread. ``extensions`` maps further frame
    types to handlers ``fn(chan, srv, msg, replica, device)``, each on
    its own thread (the cluster's exchange frames block on compute and
    peer flights)."""
    from spark_rapids_jni_tpu_torch.runtime.server import QueryServer

    srv = QueryServer()
    if int(get_option("server.warmup_top_n")) > 0:
        from spark_rapids_jni_tpu_torch.models import tpch  # noqa: F401

        srv.warmup()
    chan.send(_boot_report(device))
    frozen = False
    try:
        while True:
            try:
                msg = chan.recv()
            except (ConnectionError, EOFError, OSError):
                return 0  # the supervisor went away: exit quietly
            t = msg.get("t")
            if t == "ping":
                if not frozen:
                    chan.send({"t": "pong", "seq": msg.get("seq", 0),
                               "load": _worker_load(srv)})
            elif t == "submit":
                threading.Thread(
                    target=_serve_one,
                    args=(chan, srv, msg, replica, device), daemon=True,
                    name=f"fleet-serve-{msg.get('qid')}").start()
            elif t == "register":
                # inline: a registration completes (and acks) before any
                # later submit that references it
                _register_one(chan, srv, msg, replica, device)
            elif t == "drain":
                state = srv.drain(timeout=msg.get("timeout"))
                chan.send({"t": "drained", **state})
            elif t == "freeze":
                # test hook: stop answering pings (a wedged control
                # plane) while query threads run on
                frozen = True
            elif t == "shutdown":
                srv.close()
                chan.send({"t": "bye"})
                return 0
            elif extensions is not None and t in extensions:
                threading.Thread(
                    target=extensions[t],
                    args=(chan, srv, msg, replica, device), daemon=True,
                    name=f"fleet-ext-{t}").start()
    finally:
        srv.close()  # idempotent after the shutdown path


def _args(argv: List[str], names) -> Dict[str, Optional[str]]:
    out: Dict[str, Optional[str]] = {n: None for n in names}
    for i, a in enumerate(argv):
        if a in out and i + 1 < len(argv):
            out[a] = argv[i + 1]
    return out


def main(argv: Optional[List[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    usage = ("usage: python -m spark_rapids_jni_tpu_torch.runtime.fleet "
             "--worker --fd <fd> --replica <rid> --device <cuda|cpu>")
    if "--worker" not in args:
        print(usage, file=sys.stderr)
        return 2
    a = _args(args, ("--fd", "--replica", "--device"))
    if None in a.values():
        print(usage, file=sys.stderr)
        return 2
    return _worker_main(int(a["--fd"]), a["--replica"], a["--device"])


if __name__ == "__main__":
    sys.exit(main())
