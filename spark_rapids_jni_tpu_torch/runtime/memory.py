"""Device and host memory management (counterpart of the reference's
``runtime/memory.py``, the RMM-role layer):

- ``device_memory_stats()``: the card's live, peak, reserved and total
  bytes from the CUDA caching allocator and ``mem_get_info``;
- ``MemoryLimiter``: a soft budget gate with a capped pool's fail-fast
  contract (``reserve`` beyond the budget raises), a blocking FIFO form
  (``reserve_blocking``, the pipeline's backpressure), high and low
  watermarks that proactively spill an attached ``SpillStore``, and the
  drain wait of the degradation ladder's parked rung;
- ``HostStagingPool``: size-classed pinned host buffers for reuse;
- ``SpillStore``: device tables under a device budget, spilled least
  recently used first to pinned host memory or to checksummed files in
  ``memory.spill_dir``, optionally re-encoded by ``runtime/compress.py``
  and sealed by ``runtime/integrity.py``, and staged back on touch
  (``get_reserved`` reserves before the host-to-device copy);
- host-to-device staging of decoded reads (``HostTableChunk``) and the
  byte-budget chunk plan the Parquet and ORC chunked readers share.

Accounting is in logical bytes (``table_nbytes``: data, validity, chars
and children), as in the reference. The caching allocator keeps freed
blocks, so ``torch.cuda.memory_allocated`` (not ``mem_get_info``) is the
reading that shows a spill freed device memory. A ``ResultCache``
attached to a limiter (``attach_result_cache``) is the first thing its
pressure sheds, before any live query's partials spill, and its
evictable bytes do not count against a parked query's drain wait
(``reclaim_cache`` then makes that discount real).

Staging a decoded read: the native engine's copy-out
(``tpudf_read_col_copy``) writes into buffers the caller gives, so the
readers allocate those buffers as page-locked (pinned) CPU tensors when
the target is a CUDA device, let the copy-out land there, and stage each
buffer with one ``non_blocking`` host-to-device copy on the current
stream. A column whose storage differs from the file's physical values
(a narrowing cast, a view, a decimal widening) carries a ``finish``
function that ``stage()`` applies after the copy, on the target device.
PyTorch's caching host allocator keeps a pinned block from reuse until
the copies that read it have run, so a snapshot may be dropped as soon
as it is staged. For a CPU target nothing is pinned and staging hands
the tensors over as they are.

A column snapshot is the reference's tuple ``(dtype, data, validity,
chars, children)``, with CPU tensors in place of numpy arrays (or codec
packs on the spilled tiers); where the column has a ``finish``, ``data``
holds the physical values it is applied to.
"""

from __future__ import annotations

import collections
import logging
import os
import pickle
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterator, NamedTuple, Optional, Sequence

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.runtime import compress, faults, integrity
from spark_rapids_jni_tpu_torch.utils.config import get_option
from spark_rapids_jni_tpu_torch.utils.tracing import trace_range


def host_empty(numel: int, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """An uninitialised CPU buffer for the native copy-out, pinned when
    it will be staged to a CUDA device."""
    return torch.empty(max(int(numel), 0), dtype=dtype,
                       pin_memory=device.type == "cuda")


def stage_tensor(x: Optional[torch.Tensor],
                 device: torch.device) -> Optional[torch.Tensor]:
    """``x`` on ``device``: one asynchronous copy from pinned memory on
    the current stream for CUDA (raises without a CUDA device), ``x``
    itself for the CPU."""
    if x is None or device.type == "cpu":
        return x
    return x.to(device, non_blocking=True)


def _col_from_host(snap, device: torch.device,
                   finish: Optional[Callable] = None):
    """A column snapshot staged to ``device``, ``finish`` applied to its
    data there."""
    from spark_rapids_jni_tpu_torch.columnar import Column

    dtype, data, validity, chars, children = snap
    data = stage_tensor(data, device)
    if finish is not None:
        data = finish(data)
    return Column(
        dtype, data, stage_tensor(validity, device),
        chars=stage_tensor(chars, device),
        children=None if children is None
        else [_col_from_host(ch, device) for ch in children])


class HostTableChunk(NamedTuple):
    """A host-decoded table chunk awaiting device staging.

    ``cols`` holds column snapshots (CPU tensors, pinned for a CUDA
    target) and ``finish`` each column's function from staged physical
    values to storage (None: the data is its storage). ``nbytes`` is
    the device footprint of the table that ``stage()`` returns, so a
    caller can reserve it before the copy; a finished column also holds
    its physical buffer on the device until its ``finish`` has run.
    ``device`` is where ``stage()`` puts the table."""

    cols: tuple
    nbytes: int
    num_rows: int
    device: torch.device
    finish: tuple

    def stage(self):
        """The host-to-device copy: a Table on ``device``."""
        from spark_rapids_jni_tpu_torch.columnar import Table

        return Table([_col_from_host(snap, self.device, fin)
                      for snap, fin in zip(self.cols, self.finish,
                                           strict=True)])


def host_table_chunk(snaps, num_rows: int, device: torch.device,
                     finish: Optional[Sequence] = None) -> HostTableChunk:
    snaps = tuple(snaps)
    finish = tuple(finish) if finish is not None else (None,) * len(snaps)
    nbytes = sum(_host_snap_nbytes(s, num_rows if f is not None else None)
                 for s, f in zip(snaps, finish, strict=True))
    return HostTableChunk(snaps, nbytes, int(num_rows),
                          torch.device(device), finish)


def _host_snap_nbytes(snap, finished_rows: Optional[int] = None) -> int:
    """A snapshot's device bytes; with ``finished_rows``, its data
    counts as that many values of the column's storage type."""
    dtype, data, validity, chars, children = snap
    n = sum(x.nbytes for x in (validity, chars) if x is not None)
    if finished_rows is not None:
        n += finished_rows * dtype.size_bytes
    elif data is not None:
        n += data.nbytes
    for ch in (children or []):
        n += _host_snap_nbytes(ch)
    return n


def _col_tensors(c) -> list:
    return [x for x in (c.data, c.validity, c.chars) if x is not None] \
        + [b for ch in (c.children or ()) for b in _col_tensors(ch)]


def table_tensors(table) -> list:
    """Every tensor of ``table``: data, validity, chars, children's."""
    return [x for c in table.columns for x in _col_tensors(c)]


def table_nbytes(table) -> int:
    """A table's device bytes: data, validity, chars and children."""
    return sum(x.nbytes for x in table_tensors(table))


class ByteBudgetChunks:
    """A file as a sequence of Tables bounded by a byte budget, cuDF's
    chunked-reader contract at the file's own unit (a Parquet row group,
    an ORC stripe): each chunk is the longest run of units whose summed
    on-disk size fits ``chunk_read_limit``, and always at least one unit.

    ``infos`` is ``[(num_rows, byte_size)]`` per unit; ``read(units,
    stage)`` decodes a run of unit indices (``stage`` as the readers'
    ``read_table`` takes it)."""

    def __init__(self, infos: Sequence[tuple[int, int]],
                 chunk_read_limit: int, read: Callable):
        self._infos = list(infos)
        self._limit = max(int(chunk_read_limit), 1)
        self._read = read
        self._next = 0

    def has_next(self) -> bool:
        return self._next < len(self._infos)

    def _chunk_end(self, start: int) -> int:
        total = 0
        end = start
        while end < len(self._infos):
            total += self._infos[end][1]
            if end > start and total > self._limit:
                break
            end += 1
        return end

    def read_chunk(self):
        if not self.has_next():
            raise StopIteration
        start = self._next
        end = self._chunk_end(start)
        self._next = end
        return self._read(list(range(start, end)), "device")

    def chunk_plan(self) -> list[list[int]]:
        """Unit index runs, one per remaining chunk; decodes nothing and
        leaves the cursor where it is."""
        plans = []
        start = self._next
        while start < len(self._infos):
            end = self._chunk_end(start)
            plans.append(list(range(start, end)))
            start = end
        return plans

    def chunk_sources(self, stage: str = "host") -> list:
        """Zero-argument decode thunks, one per remaining chunk, each
        decoding its own run of units (safe on pool threads: the native
        decode and copy-out release the GIL). ``stage="host"`` gives
        ``HostTableChunk``s, staged by their ``stage()``."""
        read = self._read
        return [(lambda units=units: read(units, stage))
                for units in self.chunk_plan()]

    def __iter__(self) -> Iterator:
        while self.has_next():
            yield self.read_chunk()


_log = logging.getLogger("spark_rapids_jni_tpu_torch.memory")


# ---- device memory statistics -----------------------------------------------


@dataclass(frozen=True)
class DeviceMemoryStats:
    """The card's memory as the caching allocator and CUDA see it:
    ``bytes_in_use`` (``memory_allocated``), ``peak_bytes_in_use``,
    ``bytes_reserved`` (the allocator's blocks, in use or cached) and
    ``bytes_limit`` (the card's total). ``bytes_cached`` is reserved but
    free: the allocator holds it for reuse, CUDA counts it used."""

    bytes_in_use: int
    peak_bytes_in_use: int
    bytes_limit: int
    bytes_reserved: int = 0

    @property
    def bytes_free(self) -> int:
        return max(self.bytes_limit - self.bytes_in_use, 0)

    @property
    def bytes_cached(self) -> int:
        return max(self.bytes_reserved - self.bytes_in_use, 0)


def device_memory_stats(device=None) -> DeviceMemoryStats:
    """Live device memory of ``device`` (default: the current CUDA
    device) from ``torch.cuda.memory_stats`` and ``mem_get_info``; zeros
    for a CPU device or without CUDA."""
    if device is None:
        if not torch.cuda.is_available():
            return DeviceMemoryStats(0, 0, 0)
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return DeviceMemoryStats(0, 0, 0)
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return DeviceMemoryStats(
        bytes_in_use=int(stats.get("allocated_bytes.all.current", 0)),
        peak_bytes_in_use=int(stats.get("allocated_bytes.all.peak", 0)),
        bytes_limit=int(total),
        bytes_reserved=int(stats.get("reserved_bytes.all.current", 0)))


# ---- the limiter ------------------------------------------------------------


class MemoryLimitExceeded(MemoryError):
    pass


# the reference's default watermark fractions of a limiter's budget
DEFAULT_HIGH_WATERMARK = 0.85
DEFAULT_LOW_WATERMARK = 0.6


class _Waiter:
    """One blocked ``reserve_blocking`` ticket; ``admission`` lets the
    head-of-line check tell a pressure-parked admission (which must not
    hold the FIFO line) from an ordinary blocked reservation."""

    __slots__ = ("admission",)

    def __init__(self, admission: bool):
        self.admission = bool(admission)


class MemoryLimiter:
    """Soft budget gate with capped-pool semantics: ``reserve`` beyond
    the budget raises ``MemoryLimitExceeded`` instead of letting a large
    batch run the card out of memory mid-kernel.

    Watermarks (fractions of the budget, per instance;
    ``DEFAULT_HIGH_WATERMARK`` / ``DEFAULT_LOW_WATERMARK`` otherwise): with a ``SpillStore``
    attached and ``degrade.enabled``, a grant that lifts usage across
    the high watermark enters the pressure state: the ``memory.pressure``
    seam fires, a ``degrade`` pressure event is recorded, the store's
    coldest entries are spilled, and ``reserve_blocking(admission=True)``
    callers park until usage drains below the low watermark. Reservations
    of running work are never paused, and a parked admission does not
    hold the FIFO line against them."""

    def __init__(self, budget_bytes: int, *,
                 high_watermark: float = DEFAULT_HIGH_WATERMARK,
                 low_watermark: float = DEFAULT_LOW_WATERMARK):
        if budget_bytes <= 0:
            raise ValueError("budget must be positive")
        self.budget = int(budget_bytes)
        self._used = 0
        self._peak = 0
        self._high_frac = float(high_watermark)
        self._low_frac = float(low_watermark)
        self._pressure = False
        self._pressure_crossings = 0
        self._spill_store: Optional["SpillStore"] = None
        self._result_cache = None
        self._lock = threading.Condition()
        # blocked reserve_blocking tickets, served first come first served
        self._waiters: "collections.deque[_Waiter]" = collections.deque()

    @property
    def used(self) -> int:
        return self._used

    @property
    def peak(self) -> int:
        return self._peak

    @property
    def pressure(self) -> bool:
        """True between a high-watermark crossing and the drain below
        low."""
        return self._pressure

    @property
    def pressure_crossings(self) -> int:
        """High-watermark crossings so far (the ``memory.pressure``
        seam's sequence number)."""
        return self._pressure_crossings

    def attach_spill_store(self, store: Optional["SpillStore"]) -> None:
        """Register the SpillStore whose coldest entries a high-watermark
        crossing spills (None detaches)."""
        self._spill_store = store

    def attach_result_cache(self, cache) -> None:
        """Register the ``ResultCache`` whose resident entries a
        high-watermark crossing sheds before the spill store's, and whose
        evictable bytes a parked drain wait does not count (None
        detaches). The limiter reads the cache's ``evictable_bytes`` int
        under its own lock and calls ``shed()`` outside it; the cache
        takes its lock and then the limiter's, never the reverse."""
        self._result_cache = cache

    def _evictable_cache_bytes(self) -> int:
        """Resident charged cache bytes a pressure event could reclaim
        (a lock-free read of a plain int)."""
        cache = self._result_cache
        if cache is None:
            return 0
        return max(int(cache.evictable_bytes), 0)

    def reclaim_cache(self, nbytes: Optional[int] = None) -> int:
        """Shed evictable cache entries for up to ``nbytes`` (default:
        usage above the low watermark): the parked rung calls this after
        its drain wait, so the retry finds the bytes the wait discounted.
        Called outside the limiter's lock; the bytes shed."""
        cache = self._result_cache
        if cache is None:
            return 0
        target = (max(self._used - self._low_bytes(), 0)
                  if nbytes is None else max(int(nbytes), 0))
        if target <= 0:
            return 0
        return cache.shed(target)

    def watermarks(self) -> dict:
        """One consistent snapshot of the watermark state."""
        with self._lock:
            return {
                "used": self._used,
                "budget": self.budget,
                "peak": self._peak,
                "pressure": self._pressure,
                "pressure_crossings": self._pressure_crossings,
                "high_bytes": self._high_bytes(),
                "low_bytes": self._low_bytes(),
                "waiters": len(self._waiters),
                "admission_waiters": sum(
                    1 for w in self._waiters if w.admission),
            }

    def _high_bytes(self) -> int:
        return int(self.budget * self._high_frac)

    def _low_bytes(self) -> int:
        # low above high would make pressure impossible to clear
        return min(int(self.budget * self._low_frac), self._high_bytes())

    def _held_back_locked(self, ticket: _Waiter) -> bool:
        """Under the lock: does an earlier waiter hold the FIFO line
        against ``ticket``? A pressure-parked admission does not: the
        running work behind it is what drains the pressure."""
        for w in self._waiters:
            if w is ticket:
                return False
            if not (w.admission and self._pressure):
                return True
        return False

    def _note_grant_locked(self) -> bool:
        """Under the lock, after ``_used`` grew: True exactly when this
        grant crossed the high watermark (the caller reacts outside the
        lock)."""
        if (not self._pressure and self._spill_store is not None
                and self._used >= self._high_bytes()
                and get_option("degrade.enabled")):
            self._pressure = True
            self._pressure_crossings += 1
            return True
        return False

    def _enter_pressure(self) -> None:
        """The reaction to a high-watermark crossing, outside the lock:
        the seam, the event, then down to the low watermark the attached
        cache's resident entries shed first and the store's coldest
        entries spilled for the rest. An injected fault propagates to
        the reserving caller, which rolls its grant back."""
        faults.fire("memory.pressure", self._pressure_crossings,
                    used=self._used, budget=self.budget,
                    watermark=self._high_bytes())
        freed = 0
        shed = 0
        target = max(self._used - self._low_bytes(), 1)
        cache = self._result_cache
        if cache is not None:
            shed = cache.shed(target)
        store = self._spill_store
        if store is not None and shed < target:
            freed = store.spill_coldest(target - shed)
        telemetry.record_degrade(
            "memory_limiter", "pressure", tier="high", trigger="watermark",
            rung=0, used=self._used, budget=self.budget,
            proactive_spill_bytes=freed, cache_shed_bytes=shed)
        if get_option("memory.log_level") >= 1:
            _log.info("memory pressure: %d/%d in use (high watermark %d), "
                      "proactively spilled %d bytes", self._used,
                      self.budget, self._high_bytes(), freed)

    def _grant_locked(self, nbytes: int) -> bool:
        self._used += nbytes
        self._peak = max(self._peak, self._used)
        if get_option("memory.log_level") >= 2:
            _log.info("reserve %d bytes (%d in use)", nbytes, self._used)
        return self._note_grant_locked()

    def _after_grant(self, crossed: bool, nbytes: int) -> None:
        if not crossed:
            return
        try:
            self._enter_pressure()
        except BaseException:
            # an injected pressure fault must not leak the grant
            self.release(nbytes)
            raise

    def reserve(self, nbytes: int) -> None:
        """Reserve ``nbytes`` or raise ``MemoryLimitExceeded``. The seam
        fires before the lock, so an injected failure leaves the
        accounting untouched."""
        faults.fire("memory.reserve", nbytes, blocking=False)
        with self._lock:
            if self._used + nbytes > self.budget:
                raise MemoryLimitExceeded(
                    f"reservation of {nbytes} bytes exceeds budget "
                    f"({self._used}/{self.budget} in use)")
            crossed = self._grant_locked(nbytes)
        self._after_grant(crossed, nbytes)

    def reserve_blocking(self, nbytes: int, cancel=None,
                         timeout: Optional[float] = None,
                         admission: bool = False) -> bool:
        """Wait until ``nbytes`` fits, then reserve it: the pipeline's
        backpressure, so a tight budget degrades toward serial instead of
        raising. A request larger than the whole budget raises
        ``MemoryLimitExceeded`` at once. Returns True on success, False
        when ``cancel`` (anything with ``is_set()``) fired or ``timeout``
        seconds passed first (polled every 50 ms).

        Blocked reservers are served first come first served: a later,
        smaller request never passes an earlier blocked one.
        ``admission=True`` marks new work: while the limiter is under
        pressure it parks until usage drains below the low watermark."""
        faults.fire("memory.reserve", nbytes, blocking=True)
        if nbytes > self.budget:
            raise MemoryLimitExceeded(
                f"reservation of {nbytes} bytes exceeds the whole budget "
                f"({self.budget}): can never fit")
        deadline = None if timeout is None else time.monotonic() + timeout
        ticket = _Waiter(admission)
        with self._lock:
            self._waiters.append(ticket)
            try:
                while (self._held_back_locked(ticket)
                       or self._used + nbytes > self.budget
                       or (admission and self._pressure)):
                    if cancel is not None and cancel.is_set():
                        return False
                    wait = 0.05
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            return False
                        wait = min(wait, remaining)
                    self._lock.wait(wait)
                crossed = self._grant_locked(nbytes)
            finally:
                # leaving for any reason lets the next ticket try
                self._waiters.remove(ticket)
                self._lock.notify_all()
        self._after_grant(crossed, nbytes)
        return True

    def wait_below_low(self, timeout: Optional[float] = None, cancel=None,
                       own_held: int = 0) -> bool:
        """Park until usage, less the caller's own ``own_held`` bytes and
        the attached cache's evictable bytes, drains below the low
        watermark (the parked rung's wait). True once drained, False
        when ``cancel`` fired or ``timeout`` passed."""
        deadline = None if timeout is None else time.monotonic() + timeout
        own = max(int(own_held), 0)
        with self._lock:
            while (self._used - own - self._evictable_cache_bytes()
                   > self._low_bytes()):
                if cancel is not None and cancel.is_set():
                    return False
                wait = 0.05
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                    wait = min(wait, remaining)
                self._lock.wait(wait)
        return True

    def release(self, nbytes: int) -> None:
        with self._lock:
            self._used = max(self._used - nbytes, 0)
            cleared = self._pressure and self._used <= self._low_bytes()
            if cleared:
                self._pressure = False
            self._lock.notify_all()
            if get_option("memory.log_level") >= 2:
                _log.info("release %d bytes (%d in use)", nbytes, self._used)
        if cleared:
            telemetry.record_degrade(
                "memory_limiter", "pressure", tier="low",
                trigger="watermark", rung=0, used=self._used,
                budget=self.budget)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        with self._lock:
            self._used = 0
            self._pressure = False
            self._lock.notify_all()
        return False


# ---- the host staging pool --------------------------------------------------


class HostStagingPool:
    """Free lists of host staging buffers in power-of-two size classes:
    ``take(nbytes)`` returns a uint8 CPU tensor of at least ``nbytes``
    (callers slice), pinned when ``pinned`` (default: when CUDA is
    available), and ``give(buf)`` recycles it. Thread-safe; bounded per
    class so a burst cannot pin unbounded host memory."""

    def __init__(self, max_buffers_per_class: int = 8,
                 pinned: Optional[bool] = None):
        self._free: dict[int, list[torch.Tensor]] = {}
        self._max = max_buffers_per_class
        self._pinned = torch.cuda.is_available() if pinned is None \
            else bool(pinned)
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _size_class(nbytes: int) -> int:
        return 1 << max(int(nbytes - 1).bit_length(), 6)  # at least 64 B

    def take(self, nbytes: int) -> torch.Tensor:
        cls = self._size_class(max(nbytes, 1))
        with self._lock:
            bucket = self._free.get(cls)
            if bucket:
                self.hits += 1
                return bucket.pop()
            self.misses += 1
        if get_option("memory.log_level") >= 1:
            _log.info("staging alloc %d bytes (class %d)", nbytes, cls)
        return torch.empty(cls, dtype=torch.uint8, pin_memory=self._pinned)

    def give(self, buf: torch.Tensor) -> None:
        cls = int(buf.numel())
        # only buffers this pool could have made: uint8, a power of two,
        # at least the smallest class, pinned as the pool's
        if (buf.dtype != torch.uint8 or cls < 64 or cls & (cls - 1)
                or buf.is_pinned() != self._pinned):
            return
        with self._lock:
            bucket = self._free.setdefault(cls, [])
            if len(bucket) < self._max:
                bucket.append(buf)

    def clear(self) -> None:
        with self._lock:
            self._free.clear()


_default_pool: Optional[HostStagingPool] = None
_default_pool_lock = threading.Lock()


def default_staging_pool() -> HostStagingPool:
    """The process's shared staging pool, made at first use."""
    global _default_pool
    with _default_pool_lock:
        if _default_pool is None:
            _default_pool = HostStagingPool()
        return _default_pool


# ---- the spill store --------------------------------------------------------


def _pack_array(x: torch.Tensor, cctx, codec_seam):
    """One host buffer for the spilled tiers: a codec pack through
    ``runtime/compress.py`` when ``codec_seam`` is given, else a
    whole-buffer zstd pack when ``cctx`` is, else the tensor itself."""
    if codec_seam is not None:
        return compress.pack_array(x.numpy(), codec_seam)
    if cctx is None:
        return x
    a = np.ascontiguousarray(x.numpy())
    return ("zstd", a.dtype.str, a.shape, cctx.compress(a))


def _unpack_array(obj, dctx, seam: str):
    """A snapshot buffer back as a CPU tensor (codec packs re-check their
    frame after the seam's trailer verified)."""
    if obj is None or isinstance(obj, torch.Tensor):
        return obj
    if isinstance(obj, np.ndarray):
        arr = obj
    elif compress.is_codec_pack(obj):
        arr = compress.unpack_array(obj, seam=seam, op="spill_store.unpack")
    else:
        _, dtype_str, shape, blob = obj
        arr = np.frombuffer(dctx.decompress(blob),
                            dtype=np.dtype(dtype_str)).reshape(shape)
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())


def _packed_nbytes(obj) -> int:
    if obj is None:
        return 0
    if isinstance(obj, tuple):
        return len(obj[3])
    return int(obj.nbytes)


def _copy_to_host(table) -> dict:
    """Every buffer of ``table`` copied to host memory: for a CUDA table,
    one ``non_blocking`` copy each into pinned tensors on the current
    stream, then a wait on that copy's event, so the host bytes may be
    read, checksummed or compressed; for a CPU table, a clone each.
    Returns ``{id(device tensor): host tensor}``."""
    bufs = table_tensors(table)
    if not bufs or bufs[0].device.type != "cuda":
        return {id(b): b.clone() for b in bufs}
    out = {}
    for b in bufs:
        host = torch.empty(b.shape, dtype=b.dtype, pin_memory=True)
        host.copy_(b, non_blocking=True)
        out[id(b)] = host
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return out


def _col_to_host(c, host: dict, cctx=None, codec_seam=None) -> tuple:
    """A column's host snapshot (children included) from the copies of
    :func:`_copy_to_host`, each buffer packed for its tier."""

    def pack(x):
        return None if x is None else _pack_array(host[id(x)], cctx,
                                                  codec_seam)

    return (c.dtype, pack(c.data), pack(c.validity), pack(c.chars),
            None if not c.children
            else [_col_to_host(ch, host, cctx, codec_seam)
                  for ch in c.children])


def _stage_snap(snap, device: torch.device, dctx, seam: str,
                sources: list):
    """A spilled snapshot staged back to ``device``. For a CUDA device
    each buffer goes through pinned memory with one ``non_blocking``
    copy, and its pinned source is appended to ``sources``, which the
    caller keeps alive until the copies' event completes."""
    from spark_rapids_jni_tpu_torch.columnar import Column

    def stage(obj):
        x = _unpack_array(obj, dctx, seam)
        if x is None or device.type != "cuda":
            return x
        if not x.is_pinned():
            x = x.pin_memory()
        sources.append(x)
        return x.to(device, non_blocking=True)

    dtype, data, validity, chars, children = snap
    return Column(dtype, stage(data), stage(validity), chars=stage(chars),
                  children=None if children is None
                  else [_stage_snap(ch, device, dctx, seam, sources)
                        for ch in children])


def _disk_snap(snap) -> tuple:
    """A snapshot with every tensor as a numpy array: the disk tier's
    pickle holds no torch objects."""
    dtype, data, validity, chars, children = snap

    def arr(x):
        return x.numpy() if isinstance(x, torch.Tensor) else x

    return (dtype, arr(data), arr(validity), arr(chars),
            None if children is None else [_disk_snap(ch) for ch in children])


def _snaps_nbytes(snaps) -> int:
    n = 0
    for s in snaps:
        _, data, validity, chars, children = s
        n += _packed_nbytes(data) + _packed_nbytes(validity) \
            + _packed_nbytes(chars) + _snaps_nbytes(children or ())
    return n


def _unlink_quiet(path: Optional[str]) -> None:
    if not path:
        return
    try:
        os.unlink(path)
    except OSError:
        pass


def _inject_snap_corruption(snaps: list, seam: str, eid: int) -> None:
    """The fault-script window for in-memory spill snapshots: the first
    host buffer goes through ``faults.fire_corrupt`` so a test can plant
    corruption that the unspill must detect. A raw buffer takes only a
    length-preserving mutation; a pack takes any. One ``is None`` check
    without an injector."""
    if faults.active_injector() is None:
        return
    for si, snap in enumerate(snaps):
        dtype, data, validity, chars, children = snap
        for bi, buf in enumerate((data, validity, chars)):
            if buf is None:
                continue
            if isinstance(buf, tuple):
                blob = buf[3]
                mutated = faults.fire_corrupt(seam, eid, blob)
                if mutated is blob:
                    continue
                new_buf = (buf[0], buf[1], buf[2], mutated)
            else:
                arr = buf.numpy()
                raw = arr.tobytes()
                mutated = faults.fire_corrupt(seam, eid, raw)
                if mutated is raw or len(mutated) != len(raw):
                    continue
                new_buf = torch.from_numpy(np.frombuffer(
                    bytearray(mutated), dtype=arr.dtype).reshape(arr.shape))
            bufs = [data, validity, chars]
            bufs[bi] = new_buf
            snaps[si] = (dtype, bufs[0], bufs[1], bufs[2], children)
            return


class SpillStore:
    """The device budget's overflow valve, RMM's spillable pool for the
    Spark plugin: registered tables count against ``budget_bytes``; a
    registration that would exceed it spills the least recently used
    tables to host memory (their device tensors dropped, so the caching
    allocator frees them), and touching a spilled table stages it back,
    spilling others as needed.

    A spill copies each buffer device-to-pinned-host with one
    ``non_blocking`` copy and waits on that copy's event before the host
    bytes are checksummed, compressed or written. An unspill keeps each
    pinned source alive until its copy's event completes (``_inflight``,
    pruned as events complete and drained by ``close``).

    ``compress_spill`` zstd-compresses spilled buffers (raises
    ``ModuleNotFoundError`` without ``zstandard``); with
    ``compress.spill`` on, buffers ride the columnar codec of
    ``runtime/compress.py`` instead. ``spill_dir`` (default: the
    ``memory.spill_dir`` option; "" keeps payloads in host memory) moves
    spilled payloads to crash-safe files, sealed when
    ``integrity.enabled``; in memory, the snapshot is checksummed at
    spill and verified at unspill. Logical device bytes stay the unit of
    account; ``stats()`` reports the stored footprints apart.
    Thread-safe."""

    def __init__(self, budget_bytes: int, compress_spill: bool = False,
                 compress_level: int = 3, spill_dir: Optional[str] = None):
        if budget_bytes <= 0:
            raise ValueError("budget must be positive")
        self.budget = int(budget_bytes)
        if spill_dir is None:
            spill_dir = str(get_option("memory.spill_dir")) or None
        self._spill_dir = spill_dir or None
        self._spill_prefix = ""
        if self._spill_dir:
            os.makedirs(self._spill_dir, exist_ok=True)
            # stores may share a directory: name this store's files apart
            self._spill_prefix = f"spill-{os.getpid()}-{id(self):x}"
        self._lock = threading.Lock()
        self._next_id = 1
        self._entries: dict[int, dict] = {}
        self._tick = 0
        self._inflight: list = []  # (event, pinned sources) of unspills
        self.spill_count = 0
        self.unspill_count = 0
        self.spilled_bytes = 0
        self.unspilled_bytes = 0
        self._cctx = None
        self._dctx = None
        if compress_spill:
            self._cctx, self._dctx = compress.zstd_codec(compress_level)

    def _device_bytes_locked(self) -> int:
        return sum(e["nbytes"] for e in self._entries.values()
                   if e["state"] == "device")

    @property
    def device_bytes(self) -> int:
        with self._lock:
            return self._device_bytes_locked()

    def _coldest_device_locked(self) -> Optional[int]:
        candidates = [(e["tick"], eid) for eid, e in self._entries.items()
                      if e["state"] == "device"]
        return min(candidates)[1] if candidates else None

    def _prune_inflight_locked(self) -> None:
        self._inflight = [(ev, src) for ev, src in self._inflight
                          if not ev.query()]

    def _spill_entry_locked(self, eid: int, reason: str) -> int:
        """Spill one resident entry to host or disk; its device bytes."""
        e = self._entries[eid]
        # before any change: an injected spill failure leaves the victim
        # resident and the store consistent
        faults.fire("spill.spill", eid, nbytes=e["nbytes"])
        seam = e.get("iseam", "integrity.spill")
        # compress, then seal: the trailer covers the stored bytes
        codec_seam = seam if compress.seam_enabled(seam) else None
        with trace_range("spill"):
            host = _copy_to_host(e["table"])
            e["host_cols"] = [_col_to_host(c, host, self._cctx, codec_seam)
                              for c in e["table"].columns]
            del host
            if self._spill_dir is not None:
                payload = pickle.dumps(
                    [_disk_snap(s) for s in e["host_cols"]],
                    protocol=pickle.HIGHEST_PROTOCOL)
                sealed = integrity.enabled()
                blob = integrity.seal(payload) if sealed else payload
                blob = faults.fire_corrupt(seam, eid, blob,
                                           nbytes=e["nbytes"])
                path = os.path.join(self._spill_dir,
                                    f"{self._spill_prefix}-{eid}.bin")
                integrity.write_payload_file(path, blob)
                e["host_cols"] = None
                e["path"] = path
                e["sealed"] = sealed
                e["stored_bytes"] = len(blob)
            elif integrity.enabled():
                e["crc"] = integrity.snaps_checksum(e["host_cols"])
                _inject_snap_corruption(e["host_cols"], seam, eid)
        e["table"] = None  # the device tensors go back to the allocator
        e["state"] = "disk" if self._spill_dir is not None else "host"
        self.spill_count += 1
        self.spilled_bytes += e["nbytes"]
        telemetry.record_spill("spill_store", reason,
                               bytes_moved=e["nbytes"],
                               direction="device_to_host")
        if get_option("memory.log_level") >= 1:
            _log.info("spill table %d (%d bytes) to host", eid, e["nbytes"])
        return e["nbytes"]

    def _spill_lru_locked(self, need: int) -> None:
        """Spill least recently used entries until ``need`` fits."""
        while self._device_bytes_locked() + need > self.budget:
            eid = self._coldest_device_locked()
            if eid is None:
                raise MemoryLimitExceeded(
                    f"table of {need} bytes exceeds the spill budget "
                    f"({self.budget}) even with everything spilled")
            self._spill_entry_locked(
                eid, "device spill budget exceeded: LRU eviction to host")

    def spill_coldest(self, nbytes: int) -> int:
        """Spill resident entries, coldest first, until at least
        ``nbytes`` device bytes are freed or none is left; the bytes
        freed (the limiter's pressure valve)."""
        freed = 0
        with self._lock:
            while freed < nbytes:
                eid = self._coldest_device_locked()
                if eid is None:
                    break
                freed += self._spill_entry_locked(
                    eid, "memory pressure: proactive spill of coldest entry")
        return freed

    def spill(self, handle: int) -> int:
        """Demote one entry to the host or disk tier (no-op if spilled);
        the device bytes freed."""
        with self._lock:
            e = self._entries.get(handle)
            if e is None:
                raise KeyError(f"unknown spill-store handle {handle}")
            if e["state"] != "device":
                return 0
            return self._spill_entry_locked(handle,
                                            "explicit demotion to host")

    def state(self, handle: int) -> str:
        """The entry's tier ("device", "host" or "disk"), its LRU tick
        untouched."""
        with self._lock:
            e = self._entries.get(handle)
            if e is None:
                raise KeyError(f"unknown spill-store handle {handle}")
            return e["state"]

    def put(self, table, *, integrity_seam: str = "integrity.spill") -> int:
        """Register a device table; its handle. May spill others.
        ``integrity_seam`` names the verification boundary of the entry's
        payload (``integrity.checkpoint`` for out-of-core partials), for
        the corruption window and the mismatch's classification."""
        nbytes = table_nbytes(table)
        with self._lock:
            self._prune_inflight_locked()
            self._spill_lru_locked(nbytes)
            self._tick += 1
            eid = self._next_id
            self._next_id += 1
            self._entries[eid] = {
                "state": "device", "table": table, "host_cols": None,
                "nbytes": nbytes, "tick": self._tick,
                "iseam": str(integrity_seam),
                "device": table.columns[0].device if table.columns
                else torch.device("cpu"),
            }
            return eid

    def get(self, handle: int):
        """The table, staged back to its device if it was spilled."""
        from spark_rapids_jni_tpu_torch.columnar import Table

        with self._lock:
            e = self._entries.get(handle)
            if e is None:
                raise KeyError(f"unknown spill-store handle {handle}")
            self._tick += 1
            e["tick"] = self._tick
            if e["state"] == "device":
                return e["table"]
            # before any staging: an injected unspill failure leaves the
            # entry spilled and its host copy intact
            faults.fire("spill.unspill", handle, nbytes=e["nbytes"])
            seam = e.get("iseam", "integrity.spill")
            with trace_range("unspill"):
                # verify before any byte is decoded or staged
                if e["state"] == "disk":
                    blob = integrity.read_payload_file(
                        e["path"], seam=seam, sealed=e["sealed"],
                        op="spill_store.get", handle=handle)
                    snaps = pickle.loads(blob)
                else:
                    snaps = e["host_cols"]
                    if e.get("crc") is not None:
                        integrity.verify_snaps(
                            snaps, e["crc"], seam=seam,
                            op="spill_store.get", handle=handle)
                self._prune_inflight_locked()
                self._spill_lru_locked(e["nbytes"])
                device = e["device"]
                sources: list = []
                cols = [_stage_snap(s, device, self._dctx, seam, sources)
                        for s in snaps]
                if sources:
                    done = torch.cuda.Event()
                    done.record()
                    self._inflight.append((done, sources))
            e["table"] = Table(cols)
            e["host_cols"] = None
            e["crc"] = None
            if e["state"] == "disk":
                _unlink_quiet(e.pop("path"))
                e.pop("stored_bytes", None)
            e["state"] = "device"
            self.unspill_count += 1
            self.unspilled_bytes += e["nbytes"]
            telemetry.record_spill(
                "spill_store", "spilled table touched: staging back to "
                "device", bytes_moved=e["nbytes"],
                direction="host_to_device")
            if get_option("memory.log_level") >= 1:
                _log.info("unspill table %d (%d bytes)", handle, e["nbytes"])
            return e["table"]

    def get_reserved(self, handle: int, limiter: MemoryLimiter):
        """``(table, nbytes)`` with the table's bytes reserved against
        ``limiter`` before the host-to-device copy runs: a spilled entry
        that does not fit raises ``MemoryLimitExceeded`` before anything
        is staged. On success the caller owns the reservation; on any
        failure none is left behind."""
        nb = self.nbytes(handle)
        limiter.reserve(nb)
        try:
            return self.get(handle), nb
        except BaseException:
            limiter.release(nb)
            raise

    def nbytes(self, handle: int) -> int:
        """Logical device size of an entry, without staging it."""
        with self._lock:
            if handle not in self._entries:
                raise KeyError(f"unknown spill handle {handle}")
            return self._entries[handle]["nbytes"]

    def stored_nbytes(self, handle: int) -> int:
        """An entry's footprint in its tier: its logical bytes on the
        device, its (possibly encoded) snapshot bytes on the host, its
        file's bytes on disk. The result cache's LRU charges this."""
        with self._lock:
            e = self._entries.get(handle)
            if e is None:
                raise KeyError(f"unknown spill handle {handle}")
            if e["state"] == "device":
                return e["nbytes"]
            if e["state"] == "disk":
                return int(e.get("stored_bytes", 0))
            return _snaps_nbytes(e["host_cols"])

    def drop(self, handle: int) -> None:
        with self._lock:
            e = self._entries.pop(handle, None)
            if e is not None and e["state"] == "disk":
                _unlink_quiet(e.get("path"))

    def close(self) -> None:
        """Drop every entry, unlink this store's spill files and wait for
        the unspill copies still in flight."""
        with self._lock:
            for e in self._entries.values():
                if e["state"] == "disk":
                    _unlink_quiet(e.get("path"))
            self._entries.clear()
            for ev, _ in self._inflight:
                ev.synchronize()
            self._inflight.clear()

    def stats(self) -> dict:
        with self._lock:
            entries = list(self._entries.values())
            return {
                "device_bytes": self._device_bytes_locked(),
                "host_bytes": sum(e["nbytes"] for e in entries
                                  if e["state"] == "host"),
                "host_stored_bytes": sum(
                    _snaps_nbytes(e["host_cols"]) for e in entries
                    if e["state"] == "host"),
                "disk_bytes": sum(e["nbytes"] for e in entries
                                  if e["state"] == "disk"),
                "disk_stored_bytes": sum(e.get("stored_bytes", 0)
                                         for e in entries
                                         if e["state"] == "disk"),
                "spill_dir": self._spill_dir or "",
                "budget_bytes": self.budget,
                "spills": self.spill_count,
                "unspills": self.unspill_count,
                "spilled_bytes": self.spilled_bytes,
                "unspilled_bytes": self.unspilled_bytes,
                "tables": len(self._entries),
            }
