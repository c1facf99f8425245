"""The serving mesh across processes: remote host workers and
data-partitioned query routing over the sealed DCN transport
(counterpart of the reference's ``runtime/cluster.py``).

- :class:`QueryCluster` boots one ``QueryServer`` worker per host as a
  process that dials back over TCP (``dcn.dial`` to the supervisor's
  ``dcn.SliceServer`` gateway) with a per-launch token, instead of
  inheriting a socketpair. Control frames are the fleet's sealed
  ``_FrameChannel`` pickle frames; every table inside one is a
  ``dcn.serialize_table`` blob of host bytes.
- Supervision is the fleet's, through its hooks (``_launch_worker``,
  ``_attach_channel``, ``_route``, ``_extra``): heartbeat, classified
  exits (stamped ``host=``), bounded failover, quarantine, the
  (plan signature, input fingerprint) memo and late-duplicate drops.
- **Partitioned serving**: :meth:`QueryCluster.register_table` splits a
  table by key hash (``dcn.partition_for_slices``), ships each shard to
  its host once, and keeps the partition map and each shard's blob and
  fingerprint. :meth:`~QueryCluster.submit_to_shard` then ships only the
  plan; :meth:`~QueryCluster.submit_merge` fans a partial plan out to
  every shard and merges on the router, memo-checking the merged
  fingerprint.
- **The exchange**: :meth:`~QueryCluster.submit_exchange` runs the
  hash-partitioned all-to-all (``runtime/exchange.py``): direct (each
  host packs and flies its flights host to host under grants the
  supervisor signs; the supervisor link carries manifests) or routed
  (the flights return through the supervisor), with the reference's
  rung-by-rung fallback from direct to routed.
- **Host failover re-homes data**: when a shard's owner dies, the router
  re-ships the retained blob to a live host (the registration
  fingerprint checked again), updates the map and re-dispatches; the
  result is checked against the same memo entry.

As in the fleet, every host's device is explicit: ``device=`` (None:
the card) reaches each worker on its command line, and every table a
worker receives is rebuilt there.

Counters ``cluster.*`` (``route_local``, ``route_rehomed``,
``fanouts``, ``merges``, ``host_deaths``, ``exchanges``, ...) and
``cluster.*`` events with ``host=`` stamps, rendered by ``telemetry
top``'s cluster view.
"""

from __future__ import annotations

import collections
import os
import socket
import subprocess
import sys
import threading
import time
import weakref
from typing import Any, Dict, List, Optional

from spark_rapids_jni_tpu_torch.parallel import dcn
from spark_rapids_jni_tpu_torch.runtime import fleet as fleetmod
from spark_rapids_jni_tpu_torch.runtime import fusion, resilience, resultcache
from spark_rapids_jni_tpu_torch.runtime.fleet import (
    FleetTicket, QueryFleet, _encode_table, _FrameChannel, _Replica)
from spark_rapids_jni_tpu_torch.telemetry import spans
from spark_rapids_jni_tpu_torch.telemetry.events import record_fleet
from spark_rapids_jni_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_jni_tpu_torch.utils.config import get_option
from spark_rapids_jni_tpu_torch.utils.log import get_logger

__all__ = ["QueryCluster", "MergeTicket", "ExchangeTicket",
           "live_clusters", "main"]

_log = get_logger("cluster")

# the dial-back handshake credential: the supervisor mints one per
# worker launch and only a dial-in presenting a currently-pending token
# is admitted as that host's control channel
_ENV_TOKEN = "SPARK_RAPIDS_TPU_CLUSTER_TOKEN"

# the per-boot peer secret: minted once per supervisor construction and
# shipped to every worker's launch environment. Workers derive the
# grant HMAC key from it (dcn.grant_key) and refuse any direct
# host-to-host flight whose dial grant the supervisor didn't sign.
_ENV_PEER_SECRET = "SPARK_RAPIDS_TPU_CLUSTER_PEER_SECRET"

_LIVE_CLUSTERS: "weakref.WeakSet[QueryCluster]" = weakref.WeakSet()


def live_clusters() -> List["QueryCluster"]:
    """Every open cluster in this process (telemetry ``top`` view)."""
    return [c for c in list(_LIVE_CLUSTERS) if not c._closed]


class _ShardRows:
    """Row-count stand-in for a worker-resident shard: the memo key and
    cost signature both read only ``num_rows``, so the supervisor never
    needs the shard's bytes to derive the idempotency pair."""

    __slots__ = ("num_rows",)

    def __init__(self, num_rows: int):
        self.num_rows = int(num_rows)


class _ShardSet:
    """Supervisor-side record of one partitioned table: the partition
    map (part -> owning host) plus, per part, the encoded shard blob
    (retained for re-homing), its fingerprint (verified on every
    registration — the cross-host half of the idempotency pair) and its
    row count (memo-key stand-in)."""

    __slots__ = ("name", "keys", "parts", "rows", "blobs", "fps", "owners")

    def __init__(self, name: str, keys: tuple, parts: int):
        self.name = name
        self.keys = keys
        self.parts = parts
        self.rows: List[int] = []
        self.blobs: List[bytes] = []
        self.fps: List[str] = []
        self.owners: List[Optional[str]] = [None] * parts


class MergeTicket:
    """Future for one fan-out/fan-in query: every shard's partial ticket
    plus the router-side merge. :meth:`result` blocks for all partials
    (in part order — the merge input order is deterministic), merges on
    the caller's thread under a ``cluster.merge`` span, and memo-checks
    the merged fingerprint so a repeated fan-out — including one whose
    partials failed over to re-homed shards — must come back
    bit-identical or die :class:`~.resilience.CorruptDataError`."""

    def __init__(self, cluster: "QueryCluster", table: str, plan_name: str,
                 tickets: List[FleetTicket], merge_fn):
        self.table = table
        self.plan_name = plan_name
        self.tickets = tickets
        self.fingerprint: Optional[str] = None
        self._cluster = cluster
        self._merge_fn = merge_fn
        self._lock = threading.Lock()
        self._resolved = False
        self._value: Any = None
        self._exc: Optional[BaseException] = None

    def done(self) -> bool:
        return self._resolved or all(t.done() for t in self.tickets)

    def result(self, timeout: Optional[float] = None):
        with self._lock:
            if self._resolved:
                if self._exc is not None:
                    raise self._exc
                return self._value
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            # a timeout leaves the ticket unresolved (retryable wait);
            # any other failure — a failed partial, a merge mismatch —
            # is permanent and resolves the ticket failed
            partials = []
            for t in self.tickets:
                left = (None if deadline is None
                        else max(0.0, deadline - time.monotonic()))
                partials.append(t.result(left))
            try:
                value = self._cluster._merge(self, partials)
            except BaseException as exc:
                self._resolved, self._exc = True, exc
                raise
            self._resolved, self._value = True, value
            return value


class ExchangeTicket:
    """Future for one general-cardinality distributed exchange query.

    Phase 1 (already in flight when this ticket exists): the pack plan —
    an ``Exchange``-rooted plan — fanned out to every shard's host; each
    worker runs its partial locally and returns the WIRE FORM (one
    concatenated table of per-destination slices plus plain
    ``row_counts`` meta). Phase 2 (:meth:`result`): the router splits
    each source's wire table, regroups the slices by destination, and
    per destination either ships the reassembled rows to the
    destination's owning host to run the merge plan there (the normal
    all-to-all path), or — when a skewed destination's flights exceed
    the merge budget — runs the spill-aware chunked merge on the router
    (``exchange.merge_flights``: partials demote into the SpillStore,
    zero leaked reservations). Destination key spaces are disjoint by
    construction, so the part-ordered concatenation of destination
    results is the global answer; its fingerprint is memo-checked like
    :class:`MergeTicket`'s, so a repeated exchange — including one whose
    packs failed over — must come back bit-identical.

    The merge plan must be RE-APPLICABLE (``merge(merge(a) + merge(b))
    == merge(a + b)`` — sum/count-style merge algebra): the spill path
    applies it per chunk and once more over the concatenated partials.
    """

    def __init__(self, cluster: "QueryCluster", session_id: str,
                 table: str, pack_plan: fusion.Plan,
                 merge_plan: fusion.Plan, merge_binding: str,
                 merge_valid_meta: Optional[str],
                 tickets: List[FleetTicket],
                 deadline_ms: Optional[int],
                 merge_budget_bytes: Optional[int],
                 *, direct: bool = False, binding: str = "",
                 bindings: Optional[dict] = None):
        self.table = table
        self.pack_plan = pack_plan
        self.merge_plan = merge_plan
        self.merge_binding = merge_binding
        self.merge_valid_meta = merge_valid_meta
        self.label = str(pack_plan.root.label)
        self.parts = int(pack_plan.root.parts)
        self.tickets = tickets
        self.session_id = session_id
        self.deadline_ms = deadline_ms
        self.merge_budget_bytes = merge_budget_bytes
        self.fingerprint: Optional[str] = None
        # direct mode: the pack fan-out is DEFERRED — phase 1 runs as
        # xpack frames when result() drives the exchange, and the pack
        # binding/broadcast bindings are retained for the routed
        # fallback rung's submit_to_shard fan-out
        self.direct = bool(direct)
        self.binding = str(binding)
        self.bindings = dict(bindings or {})
        self._cluster = cluster
        self._lock = threading.Lock()
        self._claimed = False
        self._done = threading.Event()
        self._value: Any = None
        self._exc: Optional[BaseException] = None

    def done(self) -> bool:
        if self._done.is_set():
            return True
        return bool(self.tickets) and all(t.done() for t in self.tickets)

    def _trim(self, fused: fusion.FusedResult):
        """Slice a merge result back to its true rows (the merge plan's
        unbounded groupby pads to its input row count)."""
        if self.merge_valid_meta is None:
            return fused.table
        from spark_rapids_jni_tpu_torch.ops.table_ops import _slice_rows

        return _slice_rows(
            fused.table, 0,
            int(fused.meta[self.merge_valid_meta]))

    def _run_merge_local(self, tbl):
        """Router-side merge step (the spill path's partial AND merge
        fn — re-applicable algebra makes them the same plan)."""
        return self._trim(fusion.execute(
            self.merge_plan, {self.merge_binding: tbl}))

    def result(self, timeout: Optional[float] = None):
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        # one caller claims the resolution; the phase-1 waits, worker
        # merges and spill ladder all run OUTSIDE the ticket lock (they
        # block on sockets/queues), so concurrent callers park on the
        # event, never on a held lock
        with self._lock:
            claimed = not self._claimed and not self._done.is_set()
            if claimed:
                self._claimed = True
        if not claimed:
            left = (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
            if not self._done.wait(left):
                raise TimeoutError(
                    f"exchange {self.pack_plan.name!r} (session "
                    f"{self.session_id}) not done within {timeout}s")
            if self._exc is not None:
                raise self._exc
            return self._value
        try:
            value = self._cluster._exchange_run(self, deadline)
        except TimeoutError:
            # a timeout leaves the ticket unresolved (retryable wait);
            # re-driving is idempotent through the fleet memos
            with self._lock:
                self._claimed = False
            raise
        except BaseException as exc:
            # any other failure — a failed partial, a merge mismatch —
            # is permanent and resolves the ticket failed
            self._exc = exc
            self._done.set()
            raise
        self._value = value
        self._done.set()
        return value


class QueryCluster(QueryFleet):
    """Mesh supervisor: the fleet's supervision core over dial-back TCP
    host workers, plus the partition map and locality router.

    ``hosts`` overrides ``cluster.hosts``; ``device`` is as the
    fleet's (None: the card). Construction binds the
    gateway listener (``dcn.bind_host``, ephemeral port), launches one
    worker per host and returns immediately; :meth:`wait_live` blocks
    until the hosts dialed back and booted. Use as a context manager."""

    _ID_PREFIX = "h"  # host workers: h0, h1, ...
    is_cluster = True

    def __init__(self, hosts: Optional[int] = None, *, device=None,
                 worker_env: Optional[Dict[str, str]] = None,
                 per_replica_env: Optional[Dict[str, Dict[str, str]]] = None):
        # gateway + handshake state first: the base ctor spawns workers
        # through our _launch_worker, which needs both
        self._gateway = dcn.SliceServer()
        self._boot_lock = threading.Lock()
        self._pending_boots: Dict[str, tuple] = {}
        self._reg_waits: Dict[tuple, tuple] = {}
        # direct-exchange state: the per-boot peer secret (workers sign
        # peer dial-ins against it), each host's flight-gateway address
        # (reported in its hello), and the pending xpack/xmerge waits
        self._peer_secret = os.urandom(16).hex()
        self._peer_key = dcn.grant_key(self._peer_secret)
        self._peer_addrs: Dict[str, tuple] = {}
        self._x_waits: Dict[tuple, tuple] = {}
        self._tables: Dict[str, _ShardSet] = {}
        self._merge_memo: "collections.OrderedDict[tuple, str]" = \
            collections.OrderedDict()
        self._accept_stop = threading.Event()
        super().__init__(
            hosts if hosts is not None else int(get_option("cluster.hosts")),
            device=device, worker_env=worker_env,
            per_replica_env=per_replica_env)
        _LIVE_CLUSTERS.add(self)
        # dials queue in the listener backlog until this thread starts,
        # so launching before accepting loses no worker
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="cluster-gateway")
        self._accept_thread.start()

    # -- transport: dial-back workers over the DCN gateway -------------------

    def _worker_environment(self, r: _Replica) -> Dict[str, str]:
        env = super()._worker_environment(r)
        # workers stamp host= on every record and span they emit
        env["SPARK_RAPIDS_TPU_TELEMETRY_HOST"] = r.rid
        # the grant key for direct peer flights derives from this; it
        # rides the launch environment, never the data path
        env[_ENV_PEER_SECRET] = self._peer_secret
        return env

    def _extra(self, r: _Replica) -> Dict[str, Any]:
        return {"host": r.rid}

    def _launch_worker(self, r: _Replica):
        token = os.urandom(16).hex()
        with self._boot_lock:
            # a relaunch obsoletes the dead generation's credential
            for tok in [t for t, (rr, g) in self._pending_boots.items()
                        if rr is r and g < r.generation]:
                del self._pending_boots[tok]
            self._pending_boots[token] = (r, r.generation)
        env = self._worker_environment(r)
        env[_ENV_TOKEN] = token
        cmd = [sys.executable, "-m", "spark_rapids_jni_tpu_torch.runtime.cluster",
               "--worker", "--connect",
               f"{self._gateway.host}:{self._gateway.port}",
               "--host", r.rid, "--device", str(self.device)]
        proc = subprocess.Popen(cmd, env=env)
        # the control channel attaches asynchronously when the worker
        # dials back with its token (the accept loop calls
        # _attach_channel); until then the boot deadline supervises it
        return proc, None

    def _accept_loop(self) -> None:
        while not self._accept_stop.is_set():
            try:
                conn, _addr = self._gateway.accept(timeout=0.2)
            except TimeoutError:
                continue
            except OSError:
                if self._accept_stop.is_set():
                    return
                continue
            # handshake off the accept thread: a stalled dialer must not
            # block other hosts' dial-ins
            threading.Thread(target=self._admit, args=(conn,), daemon=True,
                             name="cluster-admit").start()

    def _admit(self, conn: socket.socket) -> None:
        chan = _FrameChannel(conn)
        try:
            conn.settimeout(10.0)
            hello = chan.recv()
            conn.settimeout(None)
        except BaseException:
            chan.close()
            return
        token = str(hello.get("token", ""))
        with self._boot_lock:
            ent = self._pending_boots.pop(token, None)
        if ent is None:
            # unknown or stale credential: not one of ours (or a boot
            # superseded by a restart) — refuse the channel, visibly
            REGISTRY.counter("cluster.rejected_dials").inc()
            record_fleet("cluster.gateway", "rejected_dial",
                         replica="supervisor",
                         peer=str(hello.get("host", "?")))
            chan.close()
            return
        r, gen = ent
        with self._lock:
            stale = r.generation != gen
        if stale:
            chan.close()
            return
        peer_port = hello.get("peer_port")
        if peer_port:
            # the worker's direct-flight gateway: where OTHER hosts dial
            # it with exchange flights (latest generation wins)
            with self._lock:
                self._peer_addrs[r.rid] = (
                    str(hello.get("peer_host") or self._gateway.host),
                    int(peer_port))
        record_fleet("cluster.gateway", "host_dialed_in", replica=r.rid,
                     host=r.rid, generation=gen,
                     peer_port=int(peer_port or 0))
        self._attach_channel(r, chan, gen)

    # -- partitioned serving: register, route, fan out -----------------------

    def register_table(self, name: str, table, keys,
                       *, parts: Optional[int] = None) -> Dict[str, Any]:
        """Partition ``table`` by the key columns ``keys`` and ship each
        shard to its owning host (round-robin over the live set). The
        supervisor retains each shard's encoded blob and fingerprint —
        the re-homing reserve — and the partition map the router
        consults. Returns ``{table, parts, rows, owners}``."""
        if self._closed:
            raise RuntimeError("cluster is closed")
        name = str(name)
        n = int(parts if parts is not None else self.n_replicas)
        if n < 1:
            raise ValueError("register_table needs at least one partition")
        boot = float(get_option("fleet.worker_boot_timeout_s"))
        if self.wait_live(1, timeout=boot) < 1:
            raise resilience.ReplicaDeadError(
                "cluster: no live host to place shards on", table=name,
                seam="fleet.dispatch")
        with spans.span("cluster.partition", table=name, parts=n):
            shards = dcn.partition_for_slices(table, list(keys), n)
            ss = _ShardSet(name, tuple(int(k) for k in keys), n)
            for shard in shards:
                ss.rows.append(int(shard.num_rows))
                ss.blobs.append(_encode_table(shard))
                ss.fps.append(resultcache.table_fingerprint(shard))
        with self._lock:
            live = [r for r in self._replicas if r.state == "live"]
        for part in range(n):
            r = live[part % len(live)]
            self._register_shard(r, ss, part)
            with self._lock:
                ss.owners[part] = r.rid
        with self._lock:
            self._tables[name] = ss
        record_fleet("cluster.partition_map", "table_registered",
                     replica="supervisor", table=name, parts=n,
                     rows=sum(ss.rows), owners=list(ss.owners))
        return {"table": name, "parts": n, "rows": sum(ss.rows),
                "owners": list(ss.owners)}

    def _register_shard(self, r: _Replica, ss: _ShardSet, part: int) -> None:
        """Ship one retained shard blob to ``r`` and block for its
        acknowledgement; the returned fingerprint must equal the one
        taken before the bytes crossed the wire (CorruptDataError
        otherwise — a shard that mutated in transit must never serve)."""
        reg = f"{ss.name}/p{part}"
        timeout = float(get_option("cluster.register_timeout_s"))
        with self._lock:
            gen, chan = r.generation, r.chan
        if chan is None or r.state != "live":
            raise resilience.ReplicaDeadError(
                f"cluster: host {r.rid} has no live control channel to "
                f"register shard {reg} on", host=r.rid, table=ss.name,
                part=part, seam="fleet.dispatch")
        evt = threading.Event()
        slot: Dict[str, Any] = {}
        key = (r.rid, gen, reg)
        with self._lock:
            self._reg_waits[key] = (evt, slot)
        try:
            with spans.span("cluster.register", replica=r.rid, host=r.rid,
                            table=ss.name, part=part):
                try:
                    chan.send({"t": "register", "name": reg,
                               "table": ss.blobs[part]})
                except BaseException as exc:
                    raise (exc if isinstance(exc, resilience.ResilienceError)
                           else resilience.classify(
                               exc, seam="fleet.dispatch")(
                               f"cluster: shard registration send to "
                               f"{r.rid} failed: {exc}", host=r.rid,
                               table=ss.name, part=part))
                if not evt.wait(timeout):
                    raise resilience.ReplicaDeadError(
                        f"cluster: host {r.rid} did not acknowledge shard "
                        f"{reg} within {timeout}s", host=r.rid,
                        table=ss.name, part=part, seam="fleet.dispatch")
            if "error_kind" in slot:
                raise self._rebuild_error(slot, r.rid)
            if slot.get("fingerprint") != ss.fps[part]:
                REGISTRY.counter("fleet.identity_mismatch").inc()
                record_fleet("cluster.register", "identity_mismatch",
                             replica=r.rid, host=r.rid, table=ss.name,
                             part=part)
                raise resilience.CorruptDataError(
                    f"cluster: shard {reg} registered on {r.rid} with "
                    f"fingerprint {slot.get('fingerprint')!r} but left the "
                    f"supervisor as {ss.fps[part]!r} — shard mutated in "
                    f"transit", host=r.rid, table=ss.name, part=part)
            REGISTRY.counter("cluster.shards_registered").inc()
            record_fleet("cluster.register", "registered", replica=r.rid,
                         host=r.rid, table=ss.name, part=part,
                         rows=slot.get("rows", 0),
                         fingerprint=ss.fps[part])
        finally:
            with self._lock:
                self._reg_waits.pop(key, None)

    def _on_worker_msg(self, r: _Replica, gen: int,
                       msg: Dict[str, Any]) -> None:
        t = msg.get("t")
        if t == "registered":
            key = (r.rid, gen, str(msg.get("name", "")))
            with self._lock:
                ent = self._reg_waits.get(key)
            if ent is None:
                return  # ack for a wait that timed out or a stale gen
            evt, slot = ent
            slot.update(msg)
            evt.set()
        elif t in ("xpack_done", "xmerge_done"):
            key = (str(msg.get("xid", "")), t, int(msg.get("part", -1)))
            with self._lock:
                ent = self._x_waits.get(key)
            if ent is None:
                return  # reply for an abandoned exchange run
            evt, slot, rid, wgen = ent
            if rid != r.rid or wgen != gen:
                return  # stale generation's straggler
            slot.update(msg)
            evt.set()

    def _host(self, rid: Optional[str]) -> Optional[_Replica]:
        if rid is None:
            return None
        for r in self._replicas:
            if r.rid == rid:
                return r
        return None

    def _route(self, q, deadline: float) -> Optional[_Replica]:
        """Locality routing: a shard-pinned query goes to its owning
        host ("ship the query to the shard"); a dead owner triggers
        re-homing — the retained blob re-ships to the cheapest live
        host and the partition map is updated — before dispatch.
        Unpinned queries load-balance exactly like the fleet."""
        if q.shard is None:
            return super()._route(q, deadline)
        name, part = q.shard
        with self._lock:
            ss = self._tables.get(name)
            owner_id = ss.owners[part] if ss is not None else None
        if ss is None:
            raise resilience.MalformedInputError(
                f"cluster: query pinned to unregistered table {name!r}",
                qid=q.qid)
        owner = self._host(owner_id)
        if owner is not None and owner.state == "live":
            REGISTRY.counter("cluster.route_local").inc()
            record_fleet("cluster.route", "local", replica=owner.rid,
                         host=owner.rid, table=name, part=part, qid=q.qid)
            return owner
        r2 = self._pick_replica(deadline)
        if r2 is None:
            return None
        self._register_shard(r2, ss, part)
        with self._lock:
            # first re-homer wins the map; a concurrent failover that
            # also re-registered merely duplicated an idempotent install
            if ss.owners[part] == owner_id:
                ss.owners[part] = r2.rid
        REGISTRY.counter("cluster.route_rehomed").inc()
        record_fleet("cluster.route", "rehomed", replica=r2.rid,
                     host=r2.rid, table=name, part=part, qid=q.qid,
                     from_host=owner_id)
        _log.warning("cluster: shard %s/p%d re-homed %s -> %s",
                     name, part, owner_id, r2.rid)
        return r2

    def shard_for_key(self, name: str, key_table) -> int:
        """Owning partition of one key: hash a single-row table holding
        the key columns (in partition-key order, matching dtypes) with
        the same ``partition_hash`` that sharded the table."""
        from spark_rapids_jni_tpu_torch.ops.hash import partition_hash

        with self._lock:
            ss = self._tables[str(name)]
        ncols = len(key_table.columns)
        if ncols != len(ss.keys):
            raise ValueError(
                f"cluster: table {ss.name!r} partitions on {len(ss.keys)} "
                f"key column(s), got a {ncols}-column key table")
        dest = partition_hash(key_table, list(range(ncols)), ss.parts)
        if dest.numel() != 1:
            raise ValueError("shard_for_key takes exactly one key row, "
                             f"got {dest.numel()}")
        return int(dest[0])

    def submit_to_shard(self, session_id: str, plan: fusion.Plan, *,
                        table: str, binding: str,
                        part: Optional[int] = None, key_table=None,
                        bindings: Optional[dict] = None,
                        deadline_ms: Optional[int] = None) -> FleetTicket:
        """Route one single-shard query to the host owning the shard.
        Only the plan crosses the wire: ``binding`` resolves on the
        worker from its registered shard. Pass ``part`` directly or
        ``key_table`` (one key row) to look the partition up. The memo
        key pairs the plan signature (derived against the shard's row
        count) with the shard's registration fingerprint, so cross-host
        failover and duplicate drops keep their bit-identity check.

        ``bindings`` optionally ships additional SMALL tables inline on
        the submit frame (sealed DCN transport) — replicated dimension
        sides and runtime-filter ``to_packed`` bloom bits, the
        broadcast half of a fan-out join; the registered shard stays
        resident and never rides the wire."""
        with self._lock:
            ss = self._tables.get(str(table))
        if ss is None:
            raise KeyError(f"cluster: table {table!r} is not registered")
        if part is None:
            if key_table is None:
                raise ValueError("submit_to_shard needs part= or key_table=")
            part = self.shard_for_key(table, key_table)
        part = int(part)
        if not 0 <= part < ss.parts:
            raise IndexError(f"cluster: table {ss.name!r} has {ss.parts} "
                             f"partitions, no p{part}")
        binding = str(binding)
        return self._submit(
            str(session_id), plan, dict(bindings or {}),
            binding_refs={binding: f"{ss.name}/p{part}"},
            shard=(ss.name, part),
            sig_bindings={binding: _ShardRows(ss.rows[part])},
            deadline_ms=deadline_ms,
            cache_fingerprint=ss.fps[part])

    def submit_merge(self, session_id: str, partial_plan: fusion.Plan,
                     merge_fn, *, table: str, binding: str,
                     bindings: Optional[dict] = None,
                     deadline_ms: Optional[int] = None) -> MergeTicket:
        """Fan a partial plan out to every shard's host and merge on the
        router: ``merge_fn(partial_results)`` runs on the caller's
        thread once every partial lands (``MergeTicket.result``), its
        input ordered by part index so the merge is deterministic.
        ``bindings`` (inline broadcast tables — dims, packed bloom
        bits) ship with every per-shard submit."""
        with self._lock:
            ss = self._tables.get(str(table))
        if ss is None:
            raise KeyError(f"cluster: table {table!r} is not registered")
        REGISTRY.counter("cluster.fanouts").inc()
        record_fleet("cluster.fanout", "fanout", replica="supervisor",
                     table=ss.name, parts=ss.parts, plan=partial_plan.name)
        tickets = [
            self.submit_to_shard(session_id, partial_plan, table=table,
                                 binding=binding, part=p,
                                 bindings=bindings,
                                 deadline_ms=deadline_ms)
            for p in range(ss.parts)]
        return MergeTicket(self, ss.name, partial_plan.name, tickets,
                           merge_fn)

    def _merge(self, mt: MergeTicket, partials: List[Any]):
        fps = tuple(t.fingerprint or "" for t in mt.tickets)
        mkey = (mt.plan_name, mt.table, fps)
        with spans.span("cluster.merge", table=mt.table,
                        parts=len(partials), plan=mt.plan_name):
            merged = mt._merge_fn(partials)
        fp = resultcache.table_fingerprint(getattr(merged, "table", merged))
        with self._lock:
            prev = self._merge_memo.get(mkey)
            if prev is None:
                self._merge_memo[mkey] = fp
                while len(self._merge_memo) > 512:
                    self._merge_memo.popitem(last=False)
        if prev is not None and prev != fp:
            REGISTRY.counter("fleet.identity_mismatch").inc()
            record_fleet("cluster.merge", "identity_mismatch",
                         replica="supervisor", table=mt.table,
                         plan=mt.plan_name)
            raise resilience.CorruptDataError(
                f"cluster: merged result for {mt.plan_name} over "
                f"{mt.table} differs from the memoized fingerprint for "
                f"the same partial set — merge determinism violated",
                table=mt.table)
        mt.fingerprint = fp
        REGISTRY.counter("cluster.merges").inc()
        record_fleet("cluster.merge", "merged", replica="supervisor",
                     table=mt.table, parts=len(partials), fingerprint=fp)
        return merged

    def submit_exchange(self, session_id: str, pack_plan: fusion.Plan,
                        merge_plan: Optional[fusion.Plan] = None, *,
                        table: str, binding: str,
                        merge_binding: Optional[str] = None,
                        merge_valid_meta: Optional[str] = None,
                        bindings: Optional[dict] = None,
                        deadline_ms: Optional[int] = None,
                        merge_budget_bytes: Optional[int] = None,
                        direct: Optional[bool] = None
                        ) -> ExchangeTicket:
        """General-cardinality distributed groupby/join fan-out: the
        hash-partitioned all-to-all (``runtime/exchange.py``) over the
        mesh, with NO static slot table anywhere.

        Two plan forms. The classic pair: ``pack_plan`` rooted at an
        ``Exchange`` node whose ``parts`` equals the registered table's
        partition count, plus a ``merge_plan`` scanning
        ``merge_binding``. Or ONE plan with a planner-placed interior
        ``Exchange`` (``merge_plan=None``): the supervisor derives the
        pair with :func:`fusion.split_at_exchange` — ``parts=0`` in the
        plan resolves to the table's partition count, and
        ``merge_valid_meta`` defaults to the merge root's
        ``<label>.num_groups`` when it is an unbounded groupby.

        Each shard's host runs the Exchange child (the partial plan)
        locally, then repartitions its output by the exchange keys into
        per-destination wire buffers (TPCZ codec + integrity seal on
        every hop, like all fleet frames); the merge plan runs on each
        destination's owning host over the rows that hashed there.
        ``direct`` (default ``exchange.direct_enabled``) ships the
        flights host-to-host through each worker's peer gateway — the
        supervisor link carries only the routing manifest and acks —
        with the router-mediated path as the classified fallback rung.
        The returned ticket's :meth:`~ExchangeTicket.result` finishes
        the all-to-all and returns the part-ordered concatenation of
        destination results — bit-identical to the single-host oracle
        (the same plans run over ``exchange.exchange_local``), direct
        or routed."""
        with self._lock:
            ss = self._tables.get(str(table))
        if ss is None:
            raise KeyError(f"cluster: table {table!r} is not registered")
        if merge_plan is None:
            # single mid-plan-Exchange form: derive the pair
            split = fusion.split_at_exchange(pack_plan)
            if split is None:
                raise TypeError(
                    "submit_exchange with merge_plan=None needs a plan "
                    "with an interior Exchange node (see "
                    f"fusion.split_at_exchange), got {pack_plan.name!r}")
            pack_plan, merge_plan, merge_binding, x = split
            if int(x.parts) == 0:
                # auto-parts on a mesh: one destination per shard owner
                x = x._replace(parts=ss.parts)
                pack_plan = fusion.Plan(pack_plan.name, x)
            mroot = merge_plan.root
            if (merge_valid_meta is None
                    and isinstance(mroot, fusion.GroupBy)
                    and mroot.max_groups is None):
                merge_valid_meta = f"{mroot.label}.num_groups"
        if merge_binding is None:
            raise ValueError(
                "submit_exchange needs merge_binding= with an explicit "
                "merge plan")
        root = pack_plan.root
        if not isinstance(root, fusion.Exchange):
            raise TypeError(
                "submit_exchange needs a pack plan rooted at an Exchange "
                f"node, got {type(root).__name__}")
        if int(root.parts) != ss.parts:
            raise ValueError(
                f"cluster: exchange routes to {int(root.parts)} "
                f"destinations but table {ss.name!r} has {ss.parts} "
                f"partitions — they must match (one destination per "
                f"shard owner)")
        direct = (bool(get_option("exchange.direct_enabled"))
                  if direct is None else bool(direct))
        REGISTRY.counter("cluster.fanouts").inc()
        REGISTRY.counter("cluster.exchanges").inc()
        record_fleet("cluster.exchange", "fanout", replica="supervisor",
                     table=ss.name, parts=ss.parts, plan=pack_plan.name,
                     direct=direct)
        if direct:
            # phase 1 is deferred: result() drives the xpack fan-out so
            # grants/manifests bind to one exchange run (a retried wait
            # mints a fresh xid); the routed fallback rung fans out
            # through submit_to_shard like the classic path
            tickets: List[FleetTicket] = []
        else:
            tickets = [
                self.submit_to_shard(session_id, pack_plan, table=table,
                                     binding=binding, part=p,
                                     bindings=bindings,
                                     deadline_ms=deadline_ms)
                for p in range(ss.parts)]
        return ExchangeTicket(self, str(session_id), ss.name, pack_plan,
                              merge_plan, str(merge_binding),
                              merge_valid_meta, tickets, deadline_ms,
                              merge_budget_bytes, direct=direct,
                              binding=str(binding), bindings=bindings)

    def _exchange_merge(self, xt: ExchangeTicket, partials: List[Any],
                        deadline: Optional[float]):
        """Phase 2 of the all-to-all: split every source's wire table,
        regroup by destination, merge each destination (on its owning
        host, or router-side through the spill ladder when its flights
        exceed the budget), and concatenate in part order."""
        from spark_rapids_jni_tpu_torch.ops.table_ops import (
            _slice_rows, concatenate)
        from spark_rapids_jni_tpu_torch.runtime import exchange as xch
        from spark_rapids_jni_tpu_torch.runtime.memory import table_nbytes
        from spark_rapids_jni_tpu_torch.utils.config import get_option as _opt

        label, parts = xt.label, xt.parts
        per_dest: List[List[Any]] = [[] for _ in range(parts)]
        for fused in partials:
            rc = fused.meta.get(f"{label}.row_counts")
            if rc is None:
                raise resilience.MalformedInputError(
                    f"cluster: exchange partial for {xt.pack_plan.name} "
                    f"carries no {label}.row_counts meta — not an "
                    "Exchange-rooted plan result", table=xt.table,
                    seam="exchange.wire")
            for p, fls in enumerate(xch.split_wire(fused.table, rc, parts)):
                per_dest[p].extend(fls)
        budget = int(xt.merge_budget_bytes
                     if xt.merge_budget_bytes is not None
                     else _opt("exchange.merge_budget_bytes"))
        with spans.span("cluster.exchange_merge", table=xt.table,
                        parts=parts, plan=xt.merge_plan.name):
            # dispatch every host-merged destination first (they run
            # concurrently on their owners), then run any router-side
            # spill merges while the workers compute
            pending: List[Optional[FleetTicket]] = [None] * parts
            spill_parts: List[int] = []
            for p, flights in enumerate(per_dest):
                if not flights:
                    continue
                if (len(flights) > 1
                        and sum(table_nbytes(f) for f in flights) > budget):
                    spill_parts.append(p)
                    continue
                dest_in = (flights[0] if len(flights) == 1
                           else concatenate(flights))
                pending[p] = self._submit(
                    xt.session_id, xt.merge_plan,
                    {xt.merge_binding: dest_in},
                    shard=(xt.table, p), deadline_ms=xt.deadline_ms)
            spilled: Dict[int, Any] = {}
            for p in spill_parts:
                # a skewed destination: too many flight bytes to reship
                # inline — the spill-aware chunked merge absorbs them
                # through the SpillStore on the router, zero leaks
                REGISTRY.counter("cluster.exchange_spill_merges").inc()
                record_fleet("cluster.exchange", "spill_merge",
                             replica="supervisor", table=xt.table,
                             part=p, flights=len(per_dest[p]))
                res = xch.merge_flights(
                    per_dest[p], xt._run_merge_local, xt._run_merge_local,
                    budget_bytes=budget,
                    op=f"exchange.{label}.merge")
                spilled[p] = res.table
            dest_results: List[Any] = []
            for p in range(parts):
                if p in spilled:
                    dest_results.append(spilled[p])
                elif pending[p] is not None:
                    left = (None if deadline is None
                            else max(0.0, deadline - time.monotonic()))
                    dest_results.append(xt._trim(pending[p].result(left)))
            if dest_results:
                merged = (dest_results[0] if len(dest_results) == 1
                          else concatenate(dest_results))
            else:
                merged = xt._run_merge_local(
                    _slice_rows(partials[0].table, 0, 0))
        fps = tuple(t.fingerprint or "" for t in xt.tickets)
        mkey = ("exchange", xt.pack_plan.name, xt.merge_plan.name,
                xt.table, fps)
        return self._exchange_finish(xt, mkey, merged, parts, "routed")

    def _exchange_finish(self, xt: ExchangeTicket, mkey: tuple, merged,
                         parts: int, mode: str):
        """Shared exchange epilogue: memo-check the concatenated result's
        fingerprint — a repeated exchange over the same input set must
        come back bit-identical whether it ran direct, routed, or fell
        back mid-way — then count and record the merge."""
        fp = resultcache.table_fingerprint(merged)
        with self._lock:
            prev = self._merge_memo.get(mkey)
            if prev is None:
                self._merge_memo[mkey] = fp
                while len(self._merge_memo) > 512:
                    self._merge_memo.popitem(last=False)
        if prev is not None and prev != fp:
            REGISTRY.counter("fleet.identity_mismatch").inc()
            record_fleet("cluster.exchange", "identity_mismatch",
                         replica="supervisor", table=xt.table,
                         plan=xt.merge_plan.name, mode=mode)
            raise resilience.CorruptDataError(
                f"cluster: exchange result for {xt.pack_plan.name} -> "
                f"{xt.merge_plan.name} over {xt.table} differs from the "
                "memoized fingerprint for the same partial set — "
                "exchange determinism violated", table=xt.table)
        xt.fingerprint = fp
        REGISTRY.counter("cluster.exchange_merges").inc()
        record_fleet("cluster.exchange", "merged", replica="supervisor",
                     table=xt.table, parts=parts, fingerprint=fp,
                     mode=mode)
        return merged

    # -- direct flights: host-to-host exchange over the peer gateways --------

    def _exchange_run(self, xt: ExchangeTicket, deadline: Optional[float]):
        """Drive one claimed exchange to its value: the direct
        host-to-host path first (for tickets submitted direct), with the
        router-mediated path as the classified fallback rung — and the
        only path for ``direct=False`` tickets. A fallback re-fans the
        pack out through ``submit_to_shard`` (re-homing dead owners'
        shards on the way), so chaos semantics and SIGKILL failover
        carry over unchanged."""
        if xt.direct:
            try:
                return self._exchange_direct(xt, deadline)
            except TimeoutError:
                raise  # retryable wait: the ticket unclaims
            except BaseException as exc:
                REGISTRY.counter("cluster.exchange_direct_fallbacks").inc()
                record_fleet("cluster.exchange", "direct_fallback",
                             replica="supervisor", table=xt.table,
                             plan=xt.pack_plan.name,
                             error_kind=type(exc).__name__)
                _log.warning(
                    "cluster: direct exchange %s over %s fell back to "
                    "the routed path: %s",
                    xt.pack_plan.name, xt.table, exc)
        if not xt.tickets:
            xt.tickets = [
                self.submit_to_shard(xt.session_id, xt.pack_plan,
                                     table=xt.table, binding=xt.binding,
                                     part=p, bindings=xt.bindings,
                                     deadline_ms=xt.deadline_ms)
                for p in range(xt.parts)]
        partials = []
        for t in xt.tickets:
            left = (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
            partials.append(t.result(left))
        return self._exchange_merge(xt, partials, deadline)

    def _x_collect(self, wait: tuple, deadline: Optional[float],
                   cap: float, what: str) -> Dict[str, Any]:
        """Block for one xpack/xmerge reply slot. A caller-deadline
        expiry raises ``TimeoutError`` (retryable — the ticket
        unclaims); a per-phase stall or an error reply raises the
        classified ``TransportError`` that trips the routed fallback."""
        key, evt, slot, rid = wait
        left = (cap if deadline is None
                else min(cap, deadline - time.monotonic()))
        ok = evt.wait(max(0.0, left))
        with self._lock:
            self._x_waits.pop(key, None)
        if not ok:
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"cluster: direct exchange {what} on {rid} not done "
                    "before the caller deadline")
            raise resilience.TransportError(
                f"cluster: direct exchange {what} on {rid} did not "
                f"complete within {cap}s", host=rid,
                seam="exchange.wire")
        if slot.get("status") != "ok":
            raise resilience.TransportError(
                f"cluster: direct exchange {what} on {rid} failed: "
                f"{slot.get('error_kind')}: {slot.get('error')}",
                host=rid, seam="exchange.wire")
        return slot

    def _exchange_direct(self, xt: ExchangeTicket,
                         deadline: Optional[float]):
        """The direct all-to-all: phase 1 ships each source owner an
        ``xpack`` frame (plan + per-destination HMAC grants); workers
        pack locally and fly their sealed blobs host-to-host through the
        peer gateways, reporting only fingerprints (plus any blobs whose
        peer dial failed — the per-flight fallback rung). Phase 2 ships
        each destination owner the manifest (source-ordered fingerprint
        list + the supervisor-routed stragglers); workers verify every
        blob against it before decoding, merge, and return the trimmed
        result. The supervisor link carries manifests, acks and merge
        results — never a healthy flight."""
        import pickle

        from spark_rapids_jni_tpu_torch.ops.table_ops import concatenate

        parts = xt.parts
        cap = float(get_option("exchange.direct_timeout_s"))
        owners: List[tuple] = []
        with self._lock:
            ss = self._tables.get(xt.table)
            if ss is None:
                raise KeyError(
                    f"cluster: table {xt.table!r} is not registered")
            for p in range(parts):
                r = self._host(ss.owners[p])
                if r is None or r.state != "live" or r.chan is None:
                    raise resilience.ReplicaDeadError(
                        f"cluster: shard {xt.table}/p{p} owner "
                        f"{ss.owners[p]} is not live for a direct "
                        "exchange", host=str(ss.owners[p]), part=p,
                        seam="fleet.dispatch")
                peer = self._peer_addrs.get(r.rid)
                if peer is None:
                    raise resilience.TransportError(
                        f"cluster: host {r.rid} reported no peer flight "
                        "gateway", host=r.rid, seam="exchange.wire")
                owners.append((r, r.generation, r.chan, peer))
        xid = os.urandom(8).hex()
        plan_blob = pickle.dumps(xt.pack_plan,
                                 protocol=pickle.HIGHEST_PROTOCOL)
        merge_blob = pickle.dumps(xt.merge_plan,
                                  protocol=pickle.HIGHEST_PROTOCOL)
        enc_bindings = {k: _encode_table(v)
                        for k, v in xt.bindings.items()}
        record_fleet("cluster.exchange", "direct_fanout",
                     replica="supervisor", table=xt.table, parts=parts,
                     plan=xt.pack_plan.name, xid=xid)
        try:
            with spans.span("cluster.exchange_direct", table=xt.table,
                            parts=parts, plan=xt.pack_plan.name):
                waits = []
                for sp in range(parts):
                    r, gen, chan, _peer = owners[sp]
                    dests = []
                    for dp in range(parts):
                        rd, _gd, _cd, peerd = owners[dp]
                        dests.append({
                            "part": dp, "host": rd.rid,
                            "addr": list(peerd),
                            "grant": dcn.sign_grant(
                                self._peer_key, xid=xid, src=f"p{sp}",
                                dest=rd.rid, part=dp)})
                    key = (xid, "xpack_done", sp)
                    evt, slot = threading.Event(), {}
                    with self._lock:
                        self._x_waits[key] = (evt, slot, r.rid, gen)
                    waits.append((key, evt, slot, r.rid))
                    chan.send({"t": "xpack", "xid": xid, "part": sp,
                               "plan": plan_blob, "binding": xt.binding,
                               "binding_ref": f"{xt.table}/p{sp}",
                               "bindings": enc_bindings, "dests": dests,
                               "timeout_s": cap})
                packs = [self._x_collect(w, deadline, cap, "xpack")
                         for w in waits]
                # manifests stay SOURCE-ORDERED (sp ascending): the
                # destination concatenates in manifest order, which is
                # the routed path's source-major flight order — the
                # bit-identity contract
                manifests: List[list] = [[] for _ in range(parts)]
                routed: List[dict] = [dict() for _ in range(parts)]
                bytes_direct = bytes_routed = 0
                for sp, res in enumerate(packs):
                    sid = f"p{sp}"
                    for dp, fpv in (res.get("fps") or {}).items():
                        manifests[int(dp)].append([sid, str(fpv)])
                    for dp, blob in (res.get("routed") or {}).items():
                        routed[int(dp)][sid] = blob
                    bytes_direct += int(res.get("bytes_direct", 0))
                    bytes_routed += int(res.get("bytes_routed", 0))
                # workers counted their own lanes in their own
                # processes; re-increment here so the split is
                # measurable from the supervisor's telemetry alone
                REGISTRY.counter("exchange.bytes_direct").inc(bytes_direct)
                REGISTRY.counter("exchange.bytes_routed").inc(bytes_routed)
                budget = int(xt.merge_budget_bytes
                             if xt.merge_budget_bytes is not None
                             else get_option("exchange.merge_budget_bytes"))
                mwaits = []
                for dp in range(parts):
                    if not manifests[dp]:
                        continue
                    r, gen, chan, _peer = owners[dp]
                    key = (xid, "xmerge_done", dp)
                    evt, slot = threading.Event(), {}
                    with self._lock:
                        self._x_waits[key] = (evt, slot, r.rid, gen)
                    mwaits.append(((key, evt, slot, r.rid), dp))
                    chan.send({"t": "xmerge", "xid": xid, "part": dp,
                               "plan": merge_blob,
                               "binding": xt.merge_binding,
                               "valid_meta": xt.merge_valid_meta,
                               "manifest": manifests[dp],
                               "routed": routed[dp], "budget": budget,
                               "timeout_s": cap})
                dest_results = []
                for w, dp in mwaits:
                    slot = self._x_collect(w, deadline, cap, "xmerge")
                    tbl = fleetmod._decode_table(slot["table"], self.device)
                    if (resultcache.table_fingerprint(tbl)
                            != slot.get("fingerprint")):
                        REGISTRY.counter("fleet.identity_mismatch").inc()
                        record_fleet("cluster.exchange",
                                     "identity_mismatch",
                                     replica="supervisor",
                                     table=xt.table, part=dp,
                                     mode="direct")
                        raise resilience.CorruptDataError(
                            f"cluster: direct merge result for part {dp} "
                            "mutated crossing the supervisor link",
                            table=xt.table, part=dp)
                    dest_results.append(tbl)
                if not dest_results:
                    raise resilience.TransportError(
                        "cluster: direct exchange produced no "
                        "destination results", seam="exchange.wire")
                merged = (dest_results[0] if len(dest_results) == 1
                          else concatenate(dest_results))
        finally:
            with self._lock:
                for k in [k for k in self._x_waits if k[0] == xid]:
                    self._x_waits.pop(k, None)
        REGISTRY.counter("cluster.exchanges_direct").inc()
        # keyed by the SHARD fingerprints (the direct path has no pack
        # tickets): a repeated direct exchange over the same registered
        # input set must come back bit-identical
        mkey = ("exchange-direct", xt.pack_plan.name, xt.merge_plan.name,
                xt.table, tuple(ss.fps))
        return self._exchange_finish(xt, mkey, merged, parts, "direct")

    # -- supervision overrides ----------------------------------------------

    def _on_replica_death(self, r: _Replica, gen: int,
                          classified: BaseException) -> None:
        before = r.crashes_total
        super()._on_replica_death(r, gen, classified)
        # fail this generation's pending direct-exchange waits FAST: a
        # host killed mid-flight must trip the routed fallback rung, not
        # stall the exchange until its phase timeout
        with self._lock:
            dead = [v for k, v in self._x_waits.items()
                    if v[2] == r.rid and v[3] == gen]
        for evt, slot, _rid, _g in dead:
            slot.setdefault("status", "error")
            slot.setdefault("error_kind", type(classified).__name__)
            slot.setdefault("error",
                            f"host {r.rid} died mid-exchange")
            evt.set()
        if r.crashes_total != before:
            # the base counted a real (non-stale, unplanned) death: that
            # is a HOST death here, with shards to re-home on demand
            REGISTRY.counter("cluster.host_deaths").inc()
            record_fleet("cluster.supervise", "host_death", replica=r.rid,
                         host=r.rid,
                         error_kind=type(classified).__name__)

    def inspect(self) -> dict:
        snap = super().inspect()
        snap["cluster"] = True
        with self._lock:
            snap["tables"] = {
                name: {"parts": ss.parts, "keys": list(ss.keys),
                       "rows": sum(ss.rows), "owners": list(ss.owners)}
                for name, ss in self._tables.items()}
        c = REGISTRY.counters("cluster.")
        snap["counters"].update(
            {k: v for k, v in sorted(c.items()) if k.count(".") == 1})
        return snap

    def close(self, timeout: float = 30.0) -> None:
        super().close(timeout)
        self._accept_stop.set()
        self._gateway.close()
        if getattr(self, "_accept_thread", None) is not None:
            self._accept_thread.join(timeout=2.0)


# ---------------------------------------------------------------------------
# worker side: dial back, authenticate, run the fleet worker loop
# ---------------------------------------------------------------------------


def _handle_xpack(chan: _FrameChannel, srv, msg: Dict[str, Any],
                  hid: str, device, peer) -> None:
    """Worker-side phase 1 of a direct exchange: run the pack plan over
    the registered shard, split its wire table per destination, and fly
    each destination's blob host-to-host through that destination's
    peer gateway (self-deliveries skip the dial). A failed peer dial is
    the per-flight fallback rung: the blob rides the reply frame back to
    the supervisor, recorded and counted — the exchange completes
    either way. The reply carries only fingerprints, lane byte counts
    and any routed blobs."""
    import pickle

    from spark_rapids_jni_tpu_torch.ops.table_ops import concatenate
    from spark_rapids_jni_tpu_torch.runtime import exchange as xch

    xid, sp = str(msg.get("xid", "")), int(msg.get("part", -1))
    src_id = f"p{sp}"
    try:
        fleetmod._test_hold()  # the SIGKILL drills' window
        plan = pickle.loads(msg["plan"])
        bindings = {k: fleetmod._decode_table(v, device)
                    for k, v in (msg.get("bindings") or {}).items()}
        ref = msg.get("binding_ref")
        if ref:
            try:
                bindings[str(msg.get("binding"))] = \
                    srv.registered_table(ref)
            except KeyError:
                raise resilience.MalformedInputError(
                    f"direct pack references unregistered shard "
                    f"{ref!r}", host=hid)
        fused = fusion.execute(plan, bindings)
        label = str(plan.root.label)
        parts = int(plan.root.parts)
        rc = fused.meta[f"{label}.row_counts"]
        per_dest = xch.split_wire(fused.table, rc, parts)
        dests = {int(d["part"]): d for d in msg.get("dests", [])}
        fps: Dict[int, str] = {}
        routed: Dict[int, bytes] = {}
        sent: List[int] = []
        bytes_direct = bytes_routed = 0
        for dp, flights in enumerate(per_dest):
            if not flights:
                continue
            dest_in = (flights[0] if len(flights) == 1
                       else concatenate(flights))
            blob = xch.serialize_flight(
                dest_in, op="exchange.direct_pack", xid=xid,
                src=src_id, dest=dp)
            fp = dcn.flight_fingerprint(blob)
            fps[dp] = fp
            d = dests[dp]
            header = {"xid": xid, "src": src_id, "part": dp,
                      "grant": d.get("grant", ""), "fp": fp}
            if str(d.get("host")) == hid and peer is not None:
                # self-flight: the destination is this host — straight
                # into the local mailbox, no dial
                peer.deliver(xid, dp, src_id, blob)
                REGISTRY.counter("exchange.bytes_direct").inc(len(blob))
                bytes_direct += len(blob)
                sent.append(dp)
                continue
            try:
                dcn.send_peer_flight(
                    tuple(d["addr"]), header, blob,
                    op="exchange.direct_flight", xid=xid, src=src_id)
            except (resilience.ResilienceError, ConnectionError,
                    OSError) as exc:
                # peer unreachable (or it refused the grant): this
                # flight routes via the supervisor, recorded — the
                # classified fallback rung
                REGISTRY.counter("exchange.peer_dial_fallbacks").inc()
                record_fleet("cluster.peer_flight", "dial_fallback",
                             replica=hid, host=hid, xid=xid, dest=dp,
                             error_kind=type(exc).__name__)
                routed[dp] = blob
                REGISTRY.counter("exchange.bytes_routed").inc(len(blob))
                bytes_routed += len(blob)
                continue
            REGISTRY.counter("exchange.bytes_direct").inc(len(blob))
            bytes_direct += len(blob)
            sent.append(dp)
        chan.send({"t": "xpack_done", "xid": xid, "part": sp,
                   "status": "ok", "fps": fps, "routed": routed,
                   "sent": sent, "bytes_direct": bytes_direct,
                   "bytes_routed": bytes_routed,
                   "rows": int(fused.meta[f"{label}.rows"])})
    except BaseException as exc:
        err = (exc if isinstance(exc, resilience.ResilienceError)
               else resilience.classify(exc, seam="exchange.wire")(
                   f"direct pack failed on {hid}: {exc}", host=hid))
        chan.send({"t": "xpack_done", "xid": xid, "part": sp,
                   "status": "error", "error_kind": type(err).__name__,
                   "error": str(err)})


def _handle_xmerge(chan: _FrameChannel, srv, msg: Dict[str, Any],
                   hid: str, device, peer) -> None:
    """Worker-side phase 2 of a direct exchange: collect this
    destination's flights from the peer mailbox (plus any
    supervisor-routed stragglers off the frame), verify EVERY blob
    against the manifest fingerprint before decoding (an unverified
    flight must never merge), run the merge plan over the
    manifest-ordered concatenation (or the spill-aware chunked merge
    when the flights exceed the budget), and reply with the trimmed
    result."""
    import pickle

    from spark_rapids_jni_tpu_torch.ops.table_ops import (
        _slice_rows, concatenate)
    from spark_rapids_jni_tpu_torch.runtime import exchange as xch
    from spark_rapids_jni_tpu_torch.runtime.memory import table_nbytes

    xid, dp = str(msg.get("xid", "")), int(msg.get("part", -1))
    try:
        try:
            plan = pickle.loads(msg["plan"])
            binding = str(msg.get("binding"))
            vm = msg.get("valid_meta")
            manifest = list(msg.get("manifest") or [])
            routed = dict(msg.get("routed") or {})
            timeout = float(msg.get("timeout_s") or 30.0)
            direct_srcs = [s for s, _fp in manifest if s not in routed]
            flights: Dict[str, bytes] = {}
            if direct_srcs:
                if peer is None:
                    raise resilience.TransportError(
                        "no peer flight gateway on this worker",
                        host=hid, seam="exchange.wire")
                flights = peer.wait_flights(xid, dp, direct_srcs,
                                            timeout=timeout)
            tables = []
            for src_id, want_fp in manifest:
                blob = routed.get(src_id)
                if blob is None:
                    blob = flights.get(src_id)
                if blob is None or dcn.flight_fingerprint(blob) != want_fp:
                    # a flight that does not match the supervisor's
                    # manifest must never decode, let alone merge
                    REGISTRY.counter("fleet.identity_mismatch").inc()
                    record_fleet("cluster.peer_flight",
                                 "manifest_mismatch", replica=hid,
                                 host=hid, xid=xid, part=dp, src=src_id)
                    raise resilience.CorruptDataError(
                        f"direct flight {src_id} -> p{dp} of exchange "
                        f"{xid} does not match the manifest "
                        "fingerprint — refusing to decode", host=hid,
                        part=dp)
                tables.append(dcn.deserialize_table(blob, device=device))

            def step(tbl):
                res = fusion.execute(plan, {binding: tbl})
                if vm is None:
                    return res.table
                return _slice_rows(res.table, 0, int(res.meta[vm]))

            budget = int(msg.get("budget")
                         or get_option("exchange.merge_budget_bytes"))
            if (len(tables) > 1
                    and sum(table_nbytes(t) for t in tables) > budget):
                # a skewed destination on the DIRECT path spills on its
                # own host — the router never sees the flights at all
                REGISTRY.counter("cluster.exchange_spill_merges").inc()
                record_fleet("cluster.exchange", "spill_merge",
                             replica=hid, host=hid, part=dp,
                             flights=len(tables))
                out = xch.merge_flights(
                    tables, step, step, budget_bytes=budget,
                    op="exchange.direct_merge").table
            else:
                dest_in = (tables[0] if len(tables) == 1
                           else concatenate(tables))
                out = step(dest_in)
            chan.send({"t": "xmerge_done", "xid": xid, "part": dp,
                       "status": "ok",
                       "table": fleetmod._encode_table(out),
                       "fingerprint": resultcache.table_fingerprint(out),
                       "rows": int(out.num_rows)})
        finally:
            if peer is not None:
                peer.discard(xid, dp)
    except BaseException as exc:
        err = (exc if isinstance(exc, resilience.ResilienceError)
               else resilience.classify(exc, seam="exchange.wire")(
                   f"direct merge failed on {hid}: {exc}", host=hid))
        chan.send({"t": "xmerge_done", "xid": xid, "part": dp,
                   "status": "error", "error_kind": type(err).__name__,
                   "error": str(err)})


def _worker_main(connect: str, hid: str, device: str) -> int:
    """A host worker: boot its device (a CUDA device needs a card), dial
    the supervisor's gateway (bounded classified retry, ``dcn.dial``),
    present the launch token and the port of its own peer flight
    gateway, then run the fleet's worker loop with the exchange's frame
    handlers installed."""
    if os.environ.get(fleetmod._ENV_BOOT_CRASH):
        return 3  # test hook: crash-loop at boot
    try:
        dev = fleetmod._boot_device(device)
    except RuntimeError as exc:
        print(f"cluster worker {hid}: {exc}", file=sys.stderr)
        return fleetmod._EXIT_NO_DEVICE
    host, _, port = connect.rpartition(":")
    secret = os.environ.get(_ENV_PEER_SECRET, "")
    peer = (dcn.PeerFlightServer(dcn.grant_key(secret), dest=hid)
            if secret else None)
    try:
        chan = _FrameChannel(dcn.dial(int(port), host or None))
        hello: Dict[str, Any] = {"t": "hello", "host": hid,
                                 "token": os.environ.get(_ENV_TOKEN, "")}
        if peer is not None:
            hello["peer_host"] = peer.host
            hello["peer_port"] = peer.port
        chan.send(hello)
        exts = {
            "xpack": lambda ch, srv, m, rid, d: _handle_xpack(
                ch, srv, m, rid, d, peer),
            "xmerge": lambda ch, srv, m, rid, d: _handle_xmerge(
                ch, srv, m, rid, d, peer),
        }
        return fleetmod._worker_loop(chan, hid, dev, extensions=exts)
    finally:
        if peer is not None:
            peer.close()


def main(argv: Optional[List[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    usage = ("usage: python -m spark_rapids_jni_tpu_torch.runtime.cluster "
             "--worker --connect <host:port> --host <hid> "
             "--device <cuda|cpu>")
    if "--worker" not in args:
        print(usage, file=sys.stderr)
        return 2
    a = fleetmod._args(args, ("--connect", "--host", "--device"))
    if None in a.values():
        print(usage, file=sys.stderr)
        return 2
    return _worker_main(a["--connect"], a["--host"], a["--device"])


if __name__ == "__main__":
    sys.exit(main())
