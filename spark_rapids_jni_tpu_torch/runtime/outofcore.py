"""Out-of-core chunked execution under a device memory budget
(counterpart of the reference's ``runtime/outofcore.py``).

A fact table larger than the card's budget streams through in chunks:
the chunked readers (``ParquetChunkedReader``, ``OrcChunkedReader``)
give row-group or stripe runs under an on-disk byte budget, the
``MemoryLimiter`` turns "would run out of memory" into a failing
reservation, each chunk's mergeable partial goes into a ``SpillStore``
(device while its budget allows, pinned host memory or disk after,
through the columnar codec and the integrity seal), and a merge runs
over the partials at the end: the two-phase aggregation run over the
chunk sequence instead of a device mesh.

The executor is host-driven: chunk iteration, spill decisions and
compaction happen between the plans' walks, where dynamic sizes cost
nothing.
"""

from __future__ import annotations

import logging
from typing import Callable, Iterable, NamedTuple, Optional

from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.columnar import Table
from spark_rapids_jni_tpu_torch.runtime import faults, resilience
from spark_rapids_jni_tpu_torch.runtime.memory import (
    MemoryLimiter,
    SpillStore,
    table_nbytes,
)
from spark_rapids_jni_tpu_torch.utils.tracing import func_range, trace_range

_log = logging.getLogger(__name__)


def prefetch_chunks(chunks, depth: int = 1,
                    limiter: Optional[MemoryLimiter] = None):
    """Overlap the next chunks' decode and staging with the current
    chunk's compute: a producer thread drains ``chunks`` ``depth`` ahead
    (the native decode releases the GIL). With a ``limiter`` each chunk
    is reserved in the producer and the caller releases it after use; up
    to ``depth + 2`` chunks are reserved at once (``depth`` queued, one
    in the producer's hand, one in the consumer's). The producer's
    exceptions, ``MemoryLimitExceeded`` included, re-raise at the
    consumer; on early exit every undelivered reservation is released.
    Neither thread keeps a delivered chunk: the producer drops its
    reference once the chunk is queued, the consumer once it is yielded,
    so a chunk the caller released is freed while the next one is
    awaited."""
    import queue
    import threading

    if depth <= 0:
        yield from chunks
        return
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    cancel = threading.Event()

    def _put_cancellable(item):
        # never block on a consumer that left (its join would deadlock)
        while not cancel.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for chunk in chunks:
                if limiter is not None:
                    limiter.reserve(table_nbytes(chunk))
                if not _put_cancellable(("ok", chunk)):
                    # cancelled before the put landed: release it here (a
                    # chunk that landed is the drain's to release)
                    if limiter is not None:
                        limiter.release(table_nbytes(chunk))
                    return
                del chunk  # not held while the next one decodes
        except BaseException as exc:  # re-raised at the consumer
            _put_cancellable(("err", exc))
            return
        _put_cancellable(("end", None))

    th = threading.Thread(target=producer, daemon=True)
    th.start()
    try:
        while True:
            kind, payload = q.get()
            if kind == "err":
                raise payload
            if kind == "end":
                break
            yield payload
            del payload  # not held while the next one is awaited
    finally:
        cancel.set()
        th.join()
        while True:
            try:
                kind, payload = q.get_nowait()
            except queue.Empty:
                break
            if kind == "ok" and limiter is not None:
                limiter.release(table_nbytes(payload))


class OutOfCoreResult(NamedTuple):
    table: Table
    chunks: int           # chunks streamed
    peak_bytes: int       # the limiter's high-water mark over the run
    spill_stats: dict     # the SpillStore's counters


@func_range("run_chunked_aggregate")
def run_chunked_aggregate(
    chunks: Iterable[Table],
    partial_fn: Callable[[Table], Table],
    merge_fn: Callable[[Table], Table],
    *,
    limiter: MemoryLimiter,
    spill: Optional[SpillStore] = None,
    spill_budget_bytes: Optional[int] = None,
    prefetch_depth: int = 0,
    pipeline: Optional[bool] = None,
    cancel_token=None,
) -> OutOfCoreResult:
    """Stream an aggregation over table chunks under a memory budget.

    With ``prefetch_depth == 0`` and no pipeline, at no point are two
    chunks resident together: each is reserved while its partial is
    computed and released before the next. With ``prefetch_depth > 0``
    up to ``prefetch_depth + 2`` are (``prefetch_chunks``). Exceeding the
    budget raises ``MemoryLimitExceeded``. Partials go through the
    SpillStore, so the merge input holds no unaccounted device bytes.

    ``pipeline`` selects ``runtime/pipeline.py`` (None follows
    ``pipeline.enabled``): ``chunks`` may then also be a chunked reader
    with ``chunk_sources()`` or an iterable of decode thunks; decode runs
    in a thread pool and each chunk's exact bytes are reserved before its
    copy. Results are bit-identical to the serial path.
    ``prefetch_depth > 0`` is then the pipeline's queue depth.

    ``partial_fn`` maps a chunk to a small table of mergeable partial
    rows; ``merge_fn`` maps the concatenated partials to the result.

    With resilience on, each chunk's partial and the merge retry
    transient faults; a transient fault inside the pipelined stream
    resumes a fresh pipeline at the failed chunk (the chunks before it
    are checkpointed as spill handles), and a corrupt checkpoint is
    dropped and its chunk replayed from source. ``cancel_token`` is
    checked at every chunk boundary, before each restore and before the
    merge. Every failure path leaves no reservation behind."""
    from spark_rapids_jni_tpu_torch.ops.table_ops import concatenate
    from spark_rapids_jni_tpu_torch.runtime import pipeline as pl

    use_pipeline = pl.pipeline_enabled() if pipeline is None \
        else bool(pipeline)
    if spill is None:
        spill = SpillStore(spill_budget_bytes if spill_budget_bytes
                           is not None else limiter.budget)
    handles: list[int] = []
    nchunks = 0
    pol = resilience.policy()
    # pipeline and prefetch: the producer owns each chunk's reservation
    # and this loop releases it; serial: _process reserves and releases
    producer_owns = use_pipeline or prefetch_depth > 0
    sources = None
    if use_pipeline:
        sources = chunks.chunk_sources() \
            if hasattr(chunks, "chunk_sources") else chunks
        if pol.enabled:
            # resume needs a re-enterable list (of thunks, not data)
            sources = list(sources)

    def _make_stream():
        if use_pipeline:
            src = sources[nchunks:] if pol.enabled else sources
            return pl.pipeline_chunks(
                src, limiter=limiter,
                depth=prefetch_depth if prefetch_depth > 0 else None,
                cancel_token=cancel_token)
        if prefetch_depth > 0:
            return prefetch_chunks(chunks, prefetch_depth, limiter)
        return chunks

    def _process(chunk, seq, nb):
        """One chunk's partial, checkpointed into the spill store; holds
        no reservation between attempts."""
        if not producer_owns:
            limiter.reserve(nb)
        try:
            with trace_range("outofcore.chunk"):
                faults.fire("outofcore.chunk", seq, nbytes=nb)
                if use_pipeline:
                    pl._maybe_fault("compute", seq)
                    with trace_range("pipeline.compute"):
                        partial = partial_fn(chunk)
                else:
                    partial = partial_fn(chunk)
                return spill.put(partial,
                                 integrity_seam="integrity.checkpoint")
        finally:
            if not producer_owns:
                limiter.release(nb)

    run_attempt = 1
    while True:
        stream = _make_stream()
        resumed = False
        try:
            for chunk in stream:
                nb = table_nbytes(chunk)
                try:
                    if cancel_token is not None:
                        cancel_token.check("outofcore.chunk")
                    if pol.enabled:
                        handles.append(resilience.retrying(
                            "run_chunked_aggregate",
                            lambda: _process(chunk, nchunks, nb),
                            seam="outofcore.chunk", rung="replay_chunk",
                            pol=pol, chunk=nchunks))
                    else:
                        handles.append(_process(chunk, nchunks, nb))
                finally:
                    if producer_owns:
                        limiter.release(nb)
                del chunk
                nchunks += 1
        except BaseException as exc:
            # resume: the stream tore down with its reservations released;
            # chunks 0..nchunks-1 are checkpointed, so a fresh pipeline
            # starts at the failed chunk
            if not (use_pipeline and pol.enabled
                    and resilience.is_transient(exc)):
                raise
            if run_attempt >= pol.max_attempts:
                telemetry.record_resilience(
                    "run_chunked_aggregate", "fatal", seam="outofcore.chunk",
                    attempt=run_attempt, rung="replay_chunk", chunk=nchunks)
                raise resilience.FatalExecutionError(
                    f"run_chunked_aggregate: resume retries exhausted after "
                    f"{run_attempt} attempts at chunk {nchunks}: {exc}",
                    chunk=nchunks, attempts=run_attempt) from exc
            telemetry.record_resilience(
                "run_chunked_aggregate", "retry", seam="outofcore.chunk",
                attempt=run_attempt, rung="replay_chunk", chunk=nchunks)
            run_attempt += 1
            resumed = True
        finally:
            # stops the producer and releases its in-flight reservations
            if producer_owns:
                stream.close()
        if not resumed:
            break
    if run_attempt > 1:
        telemetry.record_resilience(
            "run_chunked_aggregate", "recovered", seam="outofcore.chunk",
            attempt=run_attempt, rung="replay_chunk", chunk=nchunks)
    if not handles:
        raise ValueError("no chunks: empty input stream")
    stream_stats = spill.stats()
    _log.info("out-of-core: %d chunks streamed, spill=%s", nchunks,
              stream_stats)
    if stream_stats["spills"]:
        # the store records each table's movement; this marks the run
        telemetry.record_spill(
            "run_chunked_aggregate", "partials exceeded the device spill "
            "budget during chunk streaming: LRU-spilled to host",
            bytes_moved=stream_stats["spilled_bytes"], chunks=nchunks,
            spills=stream_stats["spills"])

    def _replay_chunk(idx: int):
        """A corrupt checkpoint's recovery: recompute chunk ``idx``'s
        partial from its source; ``(partial, nbytes)`` with the partial's
        bytes reserved, as ``get_reserved`` hands them."""
        src = sources[idx]
        obj = src() if callable(src) else src
        staged = hasattr(obj, "stage")
        nb_c = obj.nbytes if staged else table_nbytes(obj)
        limiter.reserve(nb_c)
        try:
            chunk_tbl = obj.stage() if staged else obj
            partial = partial_fn(chunk_tbl)
            nb_p = table_nbytes(partial)
            limiter.reserve(nb_p)
            return partial, nb_p
        finally:
            limiter.release(nb_c)

    # the merge window: each restored partial is reserved before it is
    # staged; during the concatenate the partials and the merged input
    # are reserved together, and the partials release once it exists
    partials: list[Table] = []
    partial_bytes = 0
    try:
        for idx, h in enumerate(handles):
            if cancel_token is not None:
                cancel_token.check("outofcore.restore")
            try:
                if pol.enabled:
                    tbl, nb_p = resilience.retrying(
                        "run_chunked_aggregate",
                        lambda: spill.get_reserved(h, limiter),
                        seam="spill.unspill", rung="replay_chunk",
                        pol=pol, handle=h)
                else:
                    tbl, nb_p = spill.get_reserved(h, limiter)
            except resilience.CorruptDataError:
                # a consumed serial stream cannot replay: propagate
                if sources is None:
                    raise
                telemetry.record_integrity(
                    "run_chunked_aggregate", "replay",
                    seam="integrity.checkpoint", chunk=idx)
                spill.drop(h)
                tbl, nb_p = _replay_chunk(idx)
                telemetry.record_integrity(
                    "run_chunked_aggregate", "recovered",
                    seam="integrity.checkpoint", chunk=idx)
            partial_bytes += nb_p
            partials.append(tbl)
            spill.drop(h)
        if len(partials) > 1:
            merged_in = concatenate(partials)
            nb = table_nbytes(merged_in)
            limiter.reserve(nb)
            del partials
            limiter.release(partial_bytes)
            partial_bytes = 0
        else:
            merged_in = partials[0]
            nb = partial_bytes
            partial_bytes = 0
    except BaseException:
        # the limiter may be the caller's and reused: no phantom usage
        limiter.release(partial_bytes)
        raise

    def _merge():
        if cancel_token is not None:
            cancel_token.check("outofcore.merge")
        with trace_range("outofcore.merge"):
            faults.fire("outofcore.merge", nchunks)
            if use_pipeline:
                pl._maybe_fault("merge", nchunks)
                with trace_range("pipeline.merge"):
                    return merge_fn(merged_in)
            return merge_fn(merged_in)

    try:
        if pol.enabled:
            # the merged input's reservation is held across merge retries
            # and released once below
            out = resilience.retrying(
                "run_chunked_aggregate", _merge, seam="outofcore.merge",
                rung="replay_chunk", pol=pol)
        else:
            out = _merge()
    finally:
        limiter.release(nb)
    return OutOfCoreResult(out, nchunks, limiter.peak, spill.stats())
