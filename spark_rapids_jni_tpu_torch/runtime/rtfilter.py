"""Runtime bloom-join filters: the learned gate and its state
(counterpart of the reference's ``runtime/rtfilter.py``).

A selective join's build side is put into a Spark-compatible bloom
filter and the probe side is pruned of rows whose key the filter proves
absent, before they are staged or joined. The planner pass that places
the filter inside a plan is ``runtime/fusion.inject_runtime_filters``;
this module makes every on/off and sizing choice for it, and prunes
chunks on the out-of-core paths. Results are the same bits whatever it
decides: a bloom filter has no false negatives, so it only drops rows
the join was about to drop.

Every decision is recorded with its reason (``record_rtfilter`` and the
``rtfilter.decision.*`` counters). Learned gating: each ``(plan, join
label)`` signature keeps an EMA of its observed pass fraction
(``rows_pass / rows_in``); above ``rtfilter.gate_pass_frac`` the filter
is judged non-selective and switched off for it, and a signature with no
history runs optimistically. The EMAs persist in ``rtfilter.path`` (""
keeps them in process) with the learned admission estimates' discipline
(``runtime/server.py``): a sidecar ``fcntl`` lock, read-merge-replace
through ``atomic_write_json``, a corrupt file discarded and counted.

Pruning a chunk (``prune_chunk``): a device table is pruned on the
device, the bloom probe and then a compaction, with one host read of the
kept count. A host-decoded ``HostTableChunk`` is pruned before it is
staged: its key column goes to the filter's device for the probe and the
keep mask comes back (one read), then the host buffers are compacted
into pinned memory, so only the kept rows are reserved and staged.
Either way null-keyed rows are kept (the plan's own masking decides
them), row order is kept, and at least ``min_rows`` rows survive: when
fewer pass, the earliest dropped rows are kept as well (the reference
keeps the first ``min_rows`` rows of the chunk, which can drop a passing
row once ``min_rows`` > 1; the rows added here are proven non-matching,
so the result is the same).

Config: ``rtfilter.enabled`` / ``max_build_rows`` / ``fpp`` /
``gate_pass_frac`` / ``alpha`` / ``path`` / ``save_interval_s``.
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple, Optional

import torch

from spark_rapids_jni_tpu_torch import types as t
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.ops.bloom_filter import (
    BloomFilter,
    bloom_might_contain_spark,
    bloom_put_spark,
    optimal_params,
)
from spark_rapids_jni_tpu_torch.runtime.memory import (
    HostTableChunk,
    host_empty,
    host_table_chunk,
)
from spark_rapids_jni_tpu_torch.telemetry import REGISTRY, spans
from spark_rapids_jni_tpu_torch.telemetry.events import record_rtfilter
from spark_rapids_jni_tpu_torch.utils.atomic_io import (
    atomic_write_json,
    load_json,
)
from spark_rapids_jni_tpu_torch.utils.config import get_option

try:
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX
    fcntl = None  # type: ignore[assignment]

__all__ = [
    "Decision",
    "decide",
    "observe",
    "build_filter",
    "prune_chunk",
    "pruned_chunks",
    "packed_table",
    "learned_pass_frac",
    "flush",
    "reset",
    "stats",
]


class Decision(NamedTuple):
    """One recorded planner choice for one join of one plan."""

    apply: bool
    reason: str
    num_bits: int
    num_hashes: int


# ---------------------------------------------------------------------------
# learned selectivity state
# ---------------------------------------------------------------------------


class _SelectivityStore:
    """Per-signature pass-fraction EMAs, written under a sidecar lock
    with a merge of what another writer left (one file, N writers)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._ema: dict[str, float] = {}
        self._dirty = False
        self._last_save: Optional[float] = None
        self._loaded_from = ""

    @staticmethod
    def _resolve_path() -> str:
        return str(get_option("rtfilter.path") or "")

    def _read_file(self, path: str) -> Optional[dict]:
        state, corrupt = load_json(path)
        if corrupt is not None:
            REGISTRY.counter("rtfilter.state_discarded").inc()
            record_rtfilter("rtfilter.state", "state_discarded",
                            reason="corrupt", path=path, detail=corrupt)
            return None
        if not isinstance(state, dict):
            return None
        return {
            str(k): float(v) for k, v in state.items()
            if isinstance(v, (int, float)) and 0.0 <= float(v) <= 1.0
        }

    @staticmethod
    def _merge(mine: dict, disk: dict) -> dict:
        # a 50/50 blend of two EMAs is a fair co-estimate and converges
        # under repeated merges
        merged = dict(disk)
        for sig, v in mine.items():
            dv = merged.get(sig)
            merged[sig] = float(v) if dv is None \
                else 0.5 * float(v) + 0.5 * float(dv)
        return merged

    def _maybe_load(self) -> None:
        path = self._resolve_path()
        with self._lock:
            if path == self._loaded_from:
                return
            self._loaded_from = path
        if not path:
            return
        disk = self._read_file(path)
        if disk is None:
            return
        with self._lock:
            self._ema = self._merge(self._ema, disk)

    def get(self, sig: str) -> Optional[float]:
        self._maybe_load()
        with self._lock:
            return self._ema.get(sig)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._ema)

    def update(self, sig: str, pass_frac: float) -> float:
        self._maybe_load()
        alpha = float(get_option("rtfilter.alpha"))
        with self._lock:
            old = self._ema.get(sig)
            new = float(pass_frac) if old is None \
                else (1.0 - alpha) * old + alpha * float(pass_frac)
            self._ema[sig] = new
            self._dirty = True
            last = self._last_save
        interval = float(get_option("rtfilter.save_interval_s"))
        if last is None or time.monotonic() - last >= interval:
            self.save()
        return new

    def save(self) -> None:
        path = self._resolve_path()
        if not path:
            return
        with self._lock:
            if not self._dirty:
                return
            snapshot = dict(self._ema)
            self._dirty = False
            self._last_save = time.monotonic()
        lock_fh = None
        try:
            if fcntl is not None:
                lock_fh = open(path + ".lock", "a")
                fcntl.flock(lock_fh.fileno(), fcntl.LOCK_EX)
            disk = self._read_file(path)
            atomic_write_json(path, self._merge(snapshot, disk or {}))
        except OSError:
            # losing a write costs the next process one optimistic run,
            # never a result
            with self._lock:
                self._dirty = True
            REGISTRY.counter("rtfilter.state_write_error").inc()
        finally:
            if lock_fh is not None:
                try:
                    fcntl.flock(lock_fh.fileno(), fcntl.LOCK_UN)
                finally:
                    lock_fh.close()

    def reset(self) -> None:
        with self._lock:
            self._ema = {}
            self._dirty = False
            self._last_save = None
            self._loaded_from = ""


_STORE = _SelectivityStore()


def _signature(plan_name: str, label: str) -> str:
    return f"{plan_name}/{label}"


def learned_pass_frac(plan_name: str, label: str) -> Optional[float]:
    """The signature's current EMA (None: no history)."""
    return _STORE.get(_signature(plan_name, label))


def flush() -> None:
    """Persist dirty selectivity state now."""
    _STORE.save()


def reset() -> None:
    """Drop the in-memory selectivity state (the file is untouched)."""
    _STORE.reset()


# ---------------------------------------------------------------------------
# decisions
# ---------------------------------------------------------------------------


def decide(plan_name: str, label: str, build_rows: int) -> Decision:
    """Gate one join: the filter on or off, and its bits. Every path
    records its reason."""
    sig = _signature(plan_name, label)

    def _skip(reason: str) -> Decision:
        REGISTRY.counter("rtfilter.decision.skip").inc()
        record_rtfilter(sig, "skip", reason=reason, build_rows=build_rows)
        return Decision(False, reason, 0, 0)

    if not get_option("rtfilter.enabled"):
        return _skip("disabled")
    if build_rows > int(get_option("rtfilter.max_build_rows")):
        return _skip("build_too_large")
    ema = _STORE.get(sig)
    gate = float(get_option("rtfilter.gate_pass_frac"))
    if ema is not None and ema > gate:
        return _skip("learned_nonselective")
    reason = "no_history_optimistic" if ema is None else "selective"
    num_bits, num_hashes = optimal_params(
        build_rows, float(get_option("rtfilter.fpp")))
    REGISTRY.counter("rtfilter.decision.apply").inc()
    record_rtfilter(sig, "apply", reason=reason, build_rows=build_rows,
                    num_bits=num_bits, num_hashes=num_hashes,
                    pass_frac_ema=ema)
    return Decision(True, reason, num_bits, num_hashes)


def observe(plan_name: str, probe_label: str, rows_in, rows_pass) -> None:
    """Fold one probe's measured pass fraction into the learned EMA (and
    the ``rtfilter.rows_in`` / ``rows_pruned`` counters). Takes host
    integers: the caller reads the device side outputs."""
    if rows_in is None or rows_pass is None:
        return
    n_in, n_pass = int(rows_in), int(rows_pass)
    if n_in <= 0:
        return  # an empty probe side says nothing about selectivity
    label = probe_label[4:] if probe_label.startswith("rtf_") \
        else probe_label
    sig = _signature(plan_name, label)
    pass_frac = n_pass / n_in
    REGISTRY.counter("rtfilter.rows_in").inc(n_in)
    REGISTRY.counter("rtfilter.rows_pruned").inc(n_in - n_pass)
    REGISTRY.counter("rtfilter.observations").inc()
    ema = _STORE.update(sig, pass_frac)
    record_rtfilter(sig, "observed", reason="measured", rows_in=n_in,
                    rows_pass=n_pass, pass_frac=pass_frac,
                    pass_frac_ema=ema)


# ---------------------------------------------------------------------------
# the chunked paths
# ---------------------------------------------------------------------------


def build_filter(values: torch.Tensor, valid=None, *, expected_items: int,
                 fpp: Optional[float] = None) -> BloomFilter:
    """Put the build keys into a filter on their device (null keys
    skipped), sized for ``expected_items``. ``rtfilter.build_us`` holds
    the host time of the build's launches: nothing waits for the
    device."""
    num_bits, num_hashes = optimal_params(
        expected_items,
        float(get_option("rtfilter.fpp")) if fpp is None else float(fpp))
    start = time.monotonic()
    with spans.child("rtfilter.build", num_bits=num_bits,
                     num_hashes=num_hashes):
        bf = bloom_put_spark(
            BloomFilter.empty(num_bits, num_hashes, device=values.device),
            values, valid)
    REGISTRY.counter("rtfilter.builds").inc()
    REGISTRY.histogram("rtfilter.build_us").observe(
        (time.monotonic() - start) * 1e6)
    return bf


def _min_rows(keep: torch.Tensor, n_pass: int, min_rows: int
              ) -> tuple[torch.Tensor, int]:
    """``keep`` with the earliest dropped rows added until ``min_rows``
    rows (or every row) survive; (mask, kept count)."""
    n = int(keep.shape[0])
    need = min(int(min_rows), n) - n_pass
    if need <= 0:
        return keep, n_pass
    dropped = ~keep
    return keep | (dropped & (torch.cumsum(dropped, 0) <= need)), n_pass + need


def _prune_device(chunk: Table, bf: BloomFilter, key: int,
                  min_rows: int) -> tuple:
    """A device chunk pruned on the device: one host read (the passing
    count), then a compaction sized by it."""
    from spark_rapids_jni_tpu_torch.ops.sort import gather

    col = chunk.columns[key]
    keep = bloom_might_contain_spark(bf, col.data) | ~col.valid_mask()
    n_pass = int(keep.sum())
    keep, n_keep = _min_rows(keep, n_pass, min_rows)
    if n_keep == chunk.num_rows:
        return chunk, n_pass, n_keep
    idx = torch.nonzero_static(keep, size=n_keep).flatten()
    return gather(chunk, idx), n_pass, n_keep


# row widths in bytes gathered as one machine word a row
_WORDS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _compact_snap(snap, idx: torch.Tensor, n: int, device: torch.device):
    """One host column snapshot's rows ``idx``, into buffers pinned for a
    CUDA ``device``. A buffer holds ``n`` rows of equal width: the
    decoded bytes of a fixed-width column (``finish`` reinterprets them
    after staging), its validity, a padded string's chars."""
    dtype, data, validity, chars, children = snap
    if children or (chars is not None and chars.shape[0] != n):
        raise NotImplementedError(
            "prune_chunk: nested and Arrow string columns of a host chunk "
            "are not compacted before staging")
    m = idx.numel()

    def rows(x):
        if x is None:
            return None
        width = x.numel() // n
        if width * n != x.numel():
            raise ValueError(f"prune_chunk: a buffer of {x.numel()} "
                             f"elements does not hold {n} rows")
        out = host_empty(m * width, x.dtype, device)
        word = _WORDS.get(width * x.element_size())
        if word is not None:
            # a row is one machine word: a 1-D gather of words
            torch.index_select(x.reshape(-1).view(word), 0, idx,
                               out=out.view(word))
        else:
            torch.index_select(x.reshape(n, width), 0, idx,
                               out=out.view(m, width))
        return out.view(m, *x.shape[1:]) if x.ndim > 1 else out

    return (dtype, rows(data), rows(validity), rows(chars), children)


def _prune_host(chunk: HostTableChunk, bf: BloomFilter, key: int,
                min_rows: int) -> tuple:
    """A host chunk pruned before staging: the key column probed on the
    filter's device, the keep mask read back (one read), the host
    buffers compacted."""
    _, data, validity, _, _ = chunk.cols[key]
    fin = chunk.finish[key]
    keys = data.to(bf.bits.device)
    if fin is not None:
        keys = fin(keys)
    hit = bloom_might_contain_spark(bf, keys)
    if validity is not None:
        hit = hit | ~validity.to(keys.device).bool()
    keep = hit.cpu()
    n_pass = int(keep.sum())
    keep, n_keep = _min_rows(keep, n_pass, min_rows)
    if n_keep == chunk.num_rows:
        return chunk, n_pass, n_keep
    idx = torch.nonzero(keep).flatten()
    cols = [_compact_snap(snap, idx, chunk.num_rows, chunk.device)
            for snap in chunk.cols]
    return (host_table_chunk(cols, n_keep, chunk.device, chunk.finish),
            n_pass, n_keep)


def prune_chunk(chunk, bf: BloomFilter, key: int, *, plan_name: str = "",
                label: str = "", min_rows: int = 1):
    """``chunk`` (a device ``Table`` or a ``HostTableChunk``) cut down to
    the rows whose ``key`` the filter may hold, null keys kept, order
    kept, at least ``min_rows`` rows. With ``plan_name``/``label`` the
    measured pass fraction feeds the learned gate (:func:`observe`).
    ``rtfilter.prune_us`` holds each call's host time (the host chunk's
    includes its two synchronous copies)."""
    n = int(chunk.num_rows)
    prune = _prune_host if isinstance(chunk, HostTableChunk) \
        else _prune_device
    start = time.monotonic()
    with spans.child("rtfilter.prune", rows_in=n):
        out, n_pass, n_keep = prune(chunk, bf, key, min_rows)
    REGISTRY.histogram("rtfilter.prune_us").observe(
        (time.monotonic() - start) * 1e6)
    if plan_name and label:
        observe(plan_name, label, n, n_pass)
    else:
        REGISTRY.counter("rtfilter.rows_in").inc(n)
        REGISTRY.counter("rtfilter.rows_pruned").inc(n - n_pass)
    record_rtfilter("rtfilter.chunk", "prune", reason="measured",
                    rows_in=n, rows_out=n_keep)
    return out


class _PrunedReader:
    """A chunked reader whose chunks are pruned; forwards
    ``chunk_sources()`` so the pipelined executor keeps its decode
    overlap (each thunk decodes, then prunes, before staging)."""

    def __init__(self, inner, prune) -> None:
        self._inner = inner
        self._prune = prune

    def __iter__(self):
        return (self._prune(c) for c in self._inner)

    def chunk_sources(self):
        return [(lambda s=s: self._prune(s()))
                for s in self._inner.chunk_sources()]


def pruned_chunks(chunks, bf: BloomFilter, key: int, *, plan_name: str = "",
                  label: str = ""):
    """Wrap a chunk iterable (or a reader with ``chunk_sources()``) so
    every chunk is pruned before the out-of-core runner reserves or
    stages it."""
    def _prune(chunk):
        return prune_chunk(chunk, bf, key, plan_name=plan_name, label=label)

    if hasattr(chunks, "chunk_sources"):
        return _PrunedReader(chunks, _prune)
    return (_prune(c) for c in chunks)


def packed_table(bf: BloomFilter) -> Table:
    """The filter's ``to_packed`` wire form as a one-column uint8 table,
    for a ``BloomProbe(packed=True)`` over a Scan bound to it."""
    return Table([Column(t.UINT8, bf.to_packed())])


def stats() -> dict:
    """The runtime filter's counters."""
    c = REGISTRY.counters("rtfilter.")
    rows_in = c.get("rtfilter.rows_in", 0)
    pruned = c.get("rtfilter.rows_pruned", 0)
    return {
        "decisions_apply": c.get("rtfilter.decision.apply", 0),
        "decisions_skip": c.get("rtfilter.decision.skip", 0),
        "observations": c.get("rtfilter.observations", 0),
        "builds": c.get("rtfilter.builds", 0),
        "build_us_p50": REGISTRY.histogram(
            "rtfilter.build_us").percentile(50),
        "rows_in": rows_in,
        "rows_pruned": pruned,
        "pass_frac": (rows_in - pruned) / rows_in if rows_in else None,
        "state_discarded": c.get("rtfilter.state_discarded", 0),
        "learned_signatures": len(_STORE.snapshot()),
    }
