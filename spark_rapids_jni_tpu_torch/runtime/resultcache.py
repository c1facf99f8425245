"""Plan-signature result and subplan cache (counterpart of the
reference's ``runtime/resultcache.py``).

Query traffic repeats itself: dashboards re-issue the same plans over
slowly changing data. The serving runtime (``runtime/server.py``) cashes
that in twice:

* **Final results.** :class:`ResultCache` keeps whole-query
  ``FusedResult``\\ s under a :class:`CacheKey` ``(plan signature, input
  fingerprint)``. A hit in ``QueryServer.submit`` skips admission and
  execution and returns the cached table.
* **Subplan intermediates.** :func:`apply_subplans` keys the Filter /
  rowwise-Project prefixes over a scan (``fusion.scan_prefix_chains``),
  so two plans that share a prefix run it once between them.

Keys. The signature is a sha256 over ``fusion.plan_fingerprint`` (node
kinds, qualified callable names, static parameters, resolved row specs);
the fingerprint a sha256 over the bound inputs' content (every buffer
with its dtype and shape), or ``source_fingerprint`` (path, size, mtime)
for a file-backed scan. A key without either half raises.

Fingerprints copy every buffer to the host: SF10 lineitem is about 2.28
GB. So a table's fingerprint is kept on the Table object, as in the
reference, but torch tensors are mutable where JAX arrays are not: the
memo is keyed on each tensor's ``_version`` (bumped by every in-place
write) and ``data_ptr``, and a table whose tensors changed is hashed
again. A caller with large inputs passes ``cache_fingerprint=`` (a
``source_fingerprint`` or a token of its own) and no buffer is read.

Storage. Entries live in the server's ``SpillStore`` under the
``integrity.cache`` seam. A new entry shares the result's device
tensors, no copy, and a result may share its inputs' tensors (a Filter
or a Project passes columns through): **a served result, and a table
bound to a served query, must not be written in place.** An entry
remembers its tensors' versions, and one whose tensors were written in
place is discarded when it is next read or shed (``cache.stale_discard``)
rather than served or spilled. Under
pressure an entry is spilled to the store's sealed host or disk tier and
verified when read back: a corrupt payload is a classified
``cache.corrupt_discard`` and a recompute, never wrong bytes. Resident
entries are charged against the shared ``MemoryLimiter`` and are the
first thing its pressure sheds (``MemoryLimiter.attach_result_cache``).
Capacity is an LRU over resident bytes (``cache.max_bytes``); ``stats()``
reports logical and stored bytes.

Meta values (device tensors in the port) are copied to the host when an
entry is stored and back to the table's device on a hit, so an entry
holds no device memory beyond its table.

Config: ``cache.enabled`` / ``cache.max_bytes`` /
``cache.subplan_enabled``.
"""

from __future__ import annotations

import collections
import hashlib
import os
import threading
from typing import NamedTuple, Optional

import torch

from spark_rapids_jni_tpu_torch.runtime import fusion, resilience
from spark_rapids_jni_tpu_torch.runtime.memory import (
    HostTableChunk,
    MemoryLimiter,
    MemoryLimitExceeded,
    SpillStore,
    table_nbytes,
    table_tensors,
)
from spark_rapids_jni_tpu_torch.telemetry import REGISTRY, spans
from spark_rapids_jni_tpu_torch.telemetry.events import (
    record_cache,
    record_integrity,
)
from spark_rapids_jni_tpu_torch.utils.config import get_option
from spark_rapids_jni_tpu_torch.utils.log import get_logger

__all__ = [
    "CacheKey",
    "ResultCache",
    "enabled",
    "subplan_enabled",
    "cache_key",
    "plan_signature",
    "input_fingerprint",
    "table_fingerprint",
    "source_fingerprint",
    "apply_subplans",
]

_log = get_logger("spark_rapids_jni_tpu_torch.resultcache")


def enabled() -> bool:
    """True when the ``cache.enabled`` option is on."""
    return bool(get_option("cache.enabled"))


def subplan_enabled() -> bool:
    return enabled() and bool(get_option("cache.subplan_enabled"))


class CacheKey(NamedTuple):
    """The two-part key: ``signature`` names the computation,
    ``fingerprint`` the input content. Both are mandatory."""

    signature: str
    fingerprint: str

    @property
    def short(self) -> str:
        return f"{self.signature[:12]}@{self.fingerprint[:12]}"


# ---------------------------------------------------------------------------
# key derivation
# ---------------------------------------------------------------------------


def plan_signature(plan: fusion.Plan, bindings: dict) -> str:
    """sha256 over ``fusion.plan_fingerprint`` (the plan's name left
    out). Raises ``ValueError`` for callables that are not module-level
    and ``KeyError`` for unbound scans."""
    fp = fusion.plan_fingerprint(plan, bindings)
    return hashlib.sha256(repr(fp).encode()).hexdigest()


def _hash_buffer(h, buf) -> None:
    if buf is None:
        h.update(b"\xff")
        return
    if isinstance(buf, tuple):  # a codec or zstd pack of a spilled tier
        h.update(repr(buf[:-1]).encode())
        h.update(bytes(buf[-1]))
        return
    x = buf.detach().contiguous()
    h.update(str(x.dtype).encode())
    h.update(repr(tuple(x.shape)).encode())
    h.update(x.reshape(-1).view(torch.uint8).cpu().numpy())


def _hash_column(h, col) -> None:
    h.update(repr(col.dtype).encode())
    _hash_buffer(h, col.data)
    _hash_buffer(h, col.validity)
    _hash_buffer(h, col.chars)
    for child in (col.children or ()):
        _hash_column(h, child)


def _hash_snap(h, snap) -> None:
    dtype, data, validity, chars, children = snap
    h.update(repr(dtype).encode())
    _hash_buffer(h, data)
    _hash_buffer(h, validity)
    _hash_buffer(h, chars)
    for ch in (children or ()):
        _hash_snap(h, ch)


def _version_token(table) -> tuple:
    """What must not change under a memoized fingerprint: each tensor's
    in-place write counter, storage address, dtype and shape."""
    return tuple((x._version, x.data_ptr(), x.dtype, tuple(x.shape))
                 for x in table_tensors(table))


# one digest at a time: two sessions submitting over one table hash it
# once between them (the second finds the first's memo)
_fp_lock = threading.Lock()


def table_fingerprint(table) -> str:
    """Content digest of a Table: every column's data, validity and
    chars with their dtype and shape, children included. Memoized on the
    Table object against :func:`_version_token`, so an in-place write
    to any of its tensors (or a column swapped for another) hashes
    again."""
    token = _version_token(table)
    cached = getattr(table, "_resultcache_fp", None)
    if cached is not None and cached[0] == token:
        return cached[1]
    with _fp_lock:
        cached = getattr(table, "_resultcache_fp", None)
        if cached is not None and cached[0] == token:
            return cached[1]
        h = hashlib.sha256()
        for col in table.columns:
            _hash_column(h, col)
        fp = h.hexdigest()
        try:
            table._resultcache_fp = (token, fp)
        except (AttributeError, TypeError):
            pass  # a table type without attributes: hashed again next time
    return fp


def _chunk_fingerprint(chunk: HostTableChunk) -> str:
    h = hashlib.sha256()
    for snap in chunk.cols:
        _hash_snap(h, snap)
    return h.hexdigest()


def source_fingerprint(path: str) -> str:
    """A file-backed scan's fingerprint: path, size and mtime. Any
    rewrite of the file changes it; pass it as ``submit(...,
    cache_fingerprint=...)``."""
    st = os.stat(path)
    token = f"{os.path.abspath(path)}\0{st.st_size}\0{st.st_mtime_ns}"
    return hashlib.sha256(token.encode()).hexdigest()


def input_fingerprint(bindings: dict) -> str:
    """Content digest over every bound input, by name, in name order:
    tables hash their buffers (memoized), host-decoded chunks their
    snapshots. ``TypeError`` for a binding that is neither."""
    h = hashlib.sha256()
    for name in sorted(bindings):
        value = bindings[name]
        h.update(str(name).encode())
        h.update(b"\0")
        if isinstance(value, HostTableChunk):
            h.update(_chunk_fingerprint(value).encode())
        elif hasattr(value, "columns"):
            h.update(table_fingerprint(value).encode())
        else:
            raise TypeError(
                f"binding {name!r} is not fingerprintable: "
                f"{type(value).__name__}")
    return h.hexdigest()


def cache_key(plan: fusion.Plan, bindings: dict,
              fingerprint: Optional[str] = None) -> CacheKey:
    """The two-part key of one submission; ``fingerprint`` replaces the
    content digest (e.g. a ``source_fingerprint``)."""
    fp = str(fingerprint) if fingerprint else input_fingerprint(bindings)
    if not fp:
        raise ValueError("cache key requires a non-empty input fingerprint")
    return CacheKey(plan_signature(plan, bindings), fp)


# ---------------------------------------------------------------------------
# meta snapshots
# ---------------------------------------------------------------------------


def _snap_meta(meta: dict) -> dict:
    return {k: v.detach().cpu() if isinstance(v, torch.Tensor) else v
            for k, v in (meta or {}).items()}


def _rehydrate_meta(meta: dict, device: torch.device) -> dict:
    return {k: v.to(device) if isinstance(v, torch.Tensor) else v
            for k, v in (meta or {}).items()}


def _table_device(table) -> torch.device:
    return table.columns[0].device if table.columns else torch.device("cpu")


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------


class ResultCache:
    """LRU of ``FusedResult``\\ s stored in a sealed :class:`SpillStore`,
    their resident bytes charged against a shared
    :class:`MemoryLimiter`.

    Locking: the cache's RLock first, then (inside put/get/shed) the
    store's and the limiter's. The limiter never takes the cache's lock
    (it reads ``evictable_bytes``, a plain int, and calls ``shed()``
    outside its own lock), so the order is acyclic; the lock is
    re-entrant because a reserve inside ``put`` can cross the high
    watermark and call back into ``shed`` on this thread."""

    def __init__(self, store: SpillStore, limiter: MemoryLimiter,
                 max_bytes: Optional[int] = None):
        self._store = store
        self._limiter = limiter
        self._max_bytes_override = max_bytes
        self._lock = threading.RLock()
        # key -> {handle, nbytes, stored, meta, charged}; the order is
        # the LRU order (move_to_end on touch)
        self._entries: "collections.OrderedDict[CacheKey, dict]" = (
            collections.OrderedDict())
        self._bytes = 0          # logical bytes of every entry
        self._stored_bytes = 0   # resident bytes: what the LRU charges
        # resident charged bytes a pressure event could reclaim; updated
        # in the same critical section as the charge it mirrors
        self.evictable_bytes = 0

    def _max_bytes(self) -> int:
        if self._max_bytes_override is not None:
            return int(self._max_bytes_override)
        return int(get_option("cache.max_bytes"))

    @staticmethod
    def _validate_key(key) -> CacheKey:
        if not isinstance(key, CacheKey):
            raise ValueError(
                f"result-cache keys must be CacheKey instances, got "
                f"{type(key).__name__}")
        if not key.fingerprint or not str(key.fingerprint).strip():
            raise ValueError(
                "result-cache key is missing its input fingerprint "
                "(signature-only keying serves stale results)")
        if not key.signature or not str(key.signature).strip():
            raise ValueError("result-cache key is missing its plan signature")
        return key

    def _count(self, event: str) -> None:
        REGISTRY.counter(f"cache.{event}").inc()

    def _refresh_stored_locked(self, entry: dict) -> None:
        """Fold an entry's current resident footprint into the LRU sum."""
        try:
            stored = self._store.stored_nbytes(entry["handle"])
        except KeyError:
            return
        self._stored_bytes += stored - entry["stored"]
        entry["stored"] = stored

    def _uncharge_locked(self, entry: dict) -> None:
        if entry["charged"]:
            entry["charged"] = False
            self.evictable_bytes -= entry["nbytes"]
            self._limiter.release(entry["nbytes"])

    def _reconcile_locked(self, entry: dict) -> None:
        """The store's own LRU may have spilled a charged entry: release
        the charge of bytes the device no longer holds."""
        self._refresh_stored_locked(entry)
        if not entry["charged"]:
            return
        try:
            state = self._store.state(entry["handle"])
        except KeyError:
            state = "host"
        if state != "device":
            self._uncharge_locked(entry)

    def _discard_locked(self, key: CacheKey, entry: dict,
                        event: str) -> None:
        self._uncharge_locked(entry)
        self._entries.pop(key, None)
        self._bytes -= entry["nbytes"]
        self._stored_bytes -= entry["stored"]
        try:
            self._store.drop(entry["handle"])
        except KeyError:
            pass
        self._count(event)

    def _stale_locked(self, key: CacheKey, entry: dict) -> bool:
        """Discard a device-resident entry whose tensors were written in
        place since it was stored (True when it was)."""
        try:
            if self._store.state(entry["handle"]) != "device":
                return False
            table = self._store.get(entry["handle"])
        except KeyError:
            return False
        if _version_token(table) == entry["token"]:
            return False
        self._discard_locked(key, entry, "stale_discard")
        record_cache("result_cache", "stale_discard", key=key.short,
                     nbytes=entry["nbytes"])
        return True

    def _shed_locked(self, nbytes: int) -> int:
        """Spill resident charged entries, coldest first, releasing their
        charges; the entries stay (a later hit stages them back)."""
        freed = 0
        for key, entry in list(self._entries.items()):
            if freed >= nbytes:
                break
            self._reconcile_locked(entry)
            if not entry["charged"]:
                continue
            if self._stale_locked(key, entry):
                freed += entry["nbytes"]
                continue
            try:
                self._store.spill(entry["handle"])
            except KeyError:
                self._discard_locked(key, entry, "eviction")
                continue
            self._uncharge_locked(entry)
            self._refresh_stored_locked(entry)
            freed += entry["nbytes"]
            record_cache("result_cache", "shed", key=key.short,
                         nbytes=entry["nbytes"])
        if freed:
            REGISTRY.counter("cache.shed_bytes").inc(freed)
        return freed

    def shed(self, nbytes: int) -> int:
        """The limiter's pressure hook: free up to ``nbytes`` of resident
        cache bytes before any live query's working set is spilled."""
        with self._lock:
            return self._shed_locked(max(int(nbytes), 0))

    def make_room(self, nbytes: int) -> int:
        """Before an admission: if ``nbytes`` does not fit the limiter's
        free bytes, shed enough cache bytes that it could."""
        need = int(nbytes) - (self._limiter.budget - self._limiter.used)
        if need <= 0:
            return 0
        with self._lock:
            return self._shed_locked(need)

    def _charge_locked(self, nbytes: int) -> bool:
        """Reserve ``nbytes`` for a resident entry, shedding colder
        entries for room; False when the budget cannot take it."""
        try:
            self._limiter.reserve(nbytes)
            return True
        except MemoryLimitExceeded:
            pass
        need = nbytes - (self._limiter.budget - self._limiter.used)
        if need > 0:
            self._shed_locked(need)
        try:
            self._limiter.reserve(nbytes)
            return True
        except MemoryLimitExceeded:
            return False

    def put(self, key: CacheKey, result: fusion.FusedResult) -> bool:
        """Keep one result (sharing its device tensors), charged while
        resident; an entry the budget cannot take goes straight to the
        sealed host tier. True when stored."""
        if not enabled():
            return False
        self._validate_key(key)
        table = result.table
        nbytes = table_nbytes(table)
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return True
            if nbytes > self._max_bytes():
                self._count("too_big")
                return False
            while (self._stored_bytes + nbytes > self._max_bytes()
                   and self._entries):
                old_key, old = next(iter(self._entries.items()))
                self._discard_locked(old_key, old, "eviction")
                record_cache("result_cache", "evict", key=old_key.short,
                             nbytes=old["nbytes"])
            charged = self._charge_locked(nbytes)
            handle = self._store.put(table, integrity_seam="integrity.cache")
            if not charged:
                self._store.spill(handle)
            entry = {"handle": handle, "nbytes": nbytes, "stored": nbytes,
                     "meta": _snap_meta(result.meta), "charged": charged,
                     "device": _table_device(table),
                     "token": _version_token(table)}
            self._entries[key] = entry
            self._bytes += nbytes
            self._stored_bytes += nbytes
            if charged:
                self.evictable_bytes += nbytes
            else:
                self._refresh_stored_locked(entry)
        self._count("put")
        record_cache("result_cache", "put", key=key.short, nbytes=nbytes)
        return True

    def get(self, key: CacheKey) -> Optional[fusion.FusedResult]:
        """The memoized result, or None. A spilled entry is charged again
        before it is staged back (verified before decode); a corrupt
        payload discards the entry and counts ``cache.corrupt_discard``,
        leaving no charge behind."""
        if not enabled():
            return None
        self._validate_key(key)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self._count("miss")
                record_cache("result_cache", "miss", key=key.short)
                return None
            nbytes = entry["nbytes"]
            self._reconcile_locked(entry)
            if self._stale_locked(key, entry):
                self._count("miss")
                return None
            reserved = False
            if not entry["charged"]:
                if not self._charge_locked(nbytes):
                    self._count("bypass")
                    record_cache("result_cache", "miss", key=key.short,
                                 reason="no budget to stage")
                    return None
                reserved = True
            try:
                table = self._store.get(entry["handle"])
            except resilience.CorruptDataError as exc:
                if reserved:
                    self._limiter.release(nbytes)
                else:
                    self._uncharge_locked(entry)
                entry["charged"] = False
                self._discard_locked(key, entry, "corrupt_discard")
                record_integrity(
                    "result_cache", "mismatch", seam="integrity.cache",
                    nbytes=nbytes, reason=str(exc))
                record_cache("result_cache", "corrupt_discard",
                             key=key.short, nbytes=nbytes)
                _log.warning("corrupt cached entry %s discarded: %s",
                             key.short, exc)
                return None
            except KeyError:
                if reserved:
                    self._limiter.release(nbytes)
                self._entries.pop(key, None)
                self._bytes -= nbytes
                self._stored_bytes -= entry["stored"]
                self._count("miss")
                return None
            if reserved:
                # staged back: new tensors, new versions
                entry["charged"] = True
                entry["token"] = _version_token(table)
                self.evictable_bytes += nbytes
            self._refresh_stored_locked(entry)
            self._entries.move_to_end(key)
            meta = _rehydrate_meta(entry["meta"], entry["device"])
        self._count("hit")
        record_cache("result_cache", "hit", key=key.short, nbytes=nbytes)
        return fusion.FusedResult(table, meta)

    def invalidate(self, key: CacheKey) -> bool:
        """Drop one entry (e.g. the caller knows its source changed);
        False when there was none."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return False
            self._discard_locked(key, entry, "invalidated")
        return True

    def clear(self) -> None:
        with self._lock:
            for key, entry in list(self._entries.items()):
                self._discard_locked(key, entry, "cleared")

    def close(self) -> None:
        self.clear()

    def stats(self) -> dict:
        c = REGISTRY.counters("cache.")
        with self._lock:
            entries = len(self._entries)
            total = self._bytes
            stored = self._stored_bytes
            resident = self.evictable_bytes
        hits = c.get("cache.hit", 0)
        misses = c.get("cache.miss", 0)
        return {
            "entries": entries,
            "bytes": total,
            "stored_bytes": stored,
            "resident_bytes": resident,
            "max_bytes": self._max_bytes(),
            "hits": hits,
            "misses": misses,
            "hit_rate": round(hits / (hits + misses), 4)
            if hits + misses else None,
            "puts": c.get("cache.put", 0),
            "evictions": c.get("cache.eviction", 0),
            "shed_bytes": c.get("cache.shed_bytes", 0),
            "corrupt_discards": c.get("cache.corrupt_discard", 0),
            "stale_discards": c.get("cache.stale_discard", 0),
            "subplan_hits": c.get("cache.subplan_hit", 0),
            "subplan_materializations": c.get(
                "cache.subplan_materialize", 0),
        }


# ---------------------------------------------------------------------------
# subplan-prefix reuse
# ---------------------------------------------------------------------------

# a prefix of fewer non-Scan nodes reruns faster than it round-trips the
# cache
_MIN_PREFIX_NODES = 2


def apply_subplans(cache: Optional[ResultCache], plan: fusion.Plan,
                   bindings: dict, *, cancel_token=None):
    """Rewrite ``plan`` so each cacheable Filter / rowwise-Project prefix
    over a bucketed Scan (at least ``_MIN_PREFIX_NODES`` deep) is served
    from ``cache``: on a hit the prefix becomes a Scan of the cached
    table; on a miss it runs once as a plan of its own, is cached, and
    becomes the same Scan. The result is the same bits: a Filter masks
    validity in place and a rowwise Project stays in its scan's rows, so
    the cached intermediate is what the next node would have seen.
    Returns ``(plan, bindings, rewritten)``. A prefix that cannot be
    fingerprinted, or whose run fails (other than by cancellation), is
    left in the plan."""
    if cache is None or not subplan_enabled():
        return plan, bindings, False
    root = plan.root
    out_bindings = dict(bindings)
    rewritten = False
    for scan, top, length in fusion.scan_prefix_chains(plan.root):
        if length < _MIN_PREFIX_NODES or scan.name not in out_bindings:
            continue
        binding = out_bindings[scan.name]
        sub_plan = fusion.Plan(f"{plan.name}.prefix.{scan.name}", top)
        try:
            key = cache_key(sub_plan, {scan.name: binding})
        except (ValueError, KeyError, TypeError):
            continue
        hit = cache.get(key)
        if hit is not None:
            REGISTRY.counter("cache.subplan_hit").inc()
            record_cache(sub_plan.name, "subplan_hit", key=key.short)
            table = hit.table
        else:
            try:
                with spans.child(f"cache.subplan.{scan.name}",
                                 mode="materialize"):
                    res = fusion.execute(sub_plan, {scan.name: binding},
                                         cancel_token=cancel_token)
            except resilience.QueryCancelled:
                raise
            except Exception:
                REGISTRY.counter("cache.subplan_abort").inc()
                continue
            REGISTRY.counter("cache.subplan_materialize").inc()
            record_cache(sub_plan.name, "subplan_materialize",
                         key=key.short)
            cache.put(key, res)
            table = res.table
        alias = f"__subplan_{key.signature[:12]}"
        root = fusion.replace_node(root, top, fusion.Scan(alias, True))
        out_bindings[alias] = table
        rewritten = True
    if not rewritten:
        return plan, bindings, False
    return fusion.Plan(plan.name, root), out_bindings, True
