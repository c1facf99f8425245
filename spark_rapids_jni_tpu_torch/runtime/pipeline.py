"""Pipelined out-of-core execution: host decode overlapped with device
transfer and compute (counterpart of the reference's
``runtime/pipeline.py``).

    read/decode     host staging        device transfer     merge
    (thread pool) -> (sequence-ordered -> (copy stream,    -> (consumer,
                     exact-bytes          then compute)       outofcore)
                     admission)

- **Determinism**: chunks reach the consumer in source order whatever
  order they decode in, so the partial and merge algebra sees the
  serial sequence and the results are bit-identical to it.
- **Backpressure through the MemoryLimiter**: decode yields a
  ``HostTableChunk``, so each chunk's exact device bytes are reserved
  before its host-to-device copy, in sequence order through a
  turnstile: a blocked admission waits only on releases of chunks
  already delivered, so a minimum budget degrades to serial instead of
  deadlocking.
- **Streams**: a worker thread stages on a copy stream of its own
  pipeline, not its thread's current stream; the consumer's stream waits
  on the copy's event, and every staged tensor is marked with
  ``record_stream`` for the consumer's stream before compute uses it, so
  the caching allocator cannot hand its block out again early.
- **Errors**: a stage failure surfaces at that chunk's position in the
  output order; the generator's cleanup cancels the pump and the
  workers and releases every undelivered reservation.
- **Instrumentation**: ``pipeline.*`` counters (chunks, decode and
  transfer microseconds, producer and consumer stalls) and gauges (queue
  depth, chunks in flight) in ``telemetry``, an NVTX range per stage,
  and the ``pipeline.<stage>`` fault seams (``inject_fault`` adapts a
  stage hook to them).

``pipeline.enabled`` puts the out-of-core executor on this path;
``pipeline.prefetch_depth`` (or ``SPARK_RAPIDS_TPU_PIPELINE_PREFETCH``)
bounds how far the producer runs ahead; ``pipeline.decode_threads``
sizes the decode pool (the native decode releases the GIL, so threads
overlap).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from typing import Callable, Iterable, Iterator, Optional, Union

import torch

from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.runtime import faults
from spark_rapids_jni_tpu_torch.runtime.memory import (
    HostTableChunk,
    MemoryLimiter,
    table_nbytes,
    table_tensors,
)
from spark_rapids_jni_tpu_torch.utils.config import get_option
from spark_rapids_jni_tpu_torch.utils.tracing import trace_range

#: Stage names, in execution order, as ``inject_fault`` hooks see them.
STAGES = ("decode", "staging", "transfer", "compute", "merge")

#: One work item: a device Table, or a zero-argument thunk returning a
#: HostTableChunk (exact admission before the copy) or a device Table.
ChunkSource = Union[Callable[[], object], object]


def pipeline_enabled() -> bool:
    return bool(get_option("pipeline.enabled"))


def configured_prefetch_depth() -> int:
    """``SPARK_RAPIDS_TPU_PIPELINE_PREFETCH`` first, then the
    ``pipeline.prefetch_depth`` option."""
    env = os.environ.get("SPARK_RAPIDS_TPU_PIPELINE_PREFETCH")
    if env is not None and env.strip():
        return max(int(env), 1)
    return max(int(get_option("pipeline.prefetch_depth")), 1)


def configured_decode_threads() -> int:
    return max(int(get_option("pipeline.decode_threads")), 1)


# ---- the shared decode pool -------------------------------------------------

_shared_pool: Optional[ThreadPoolExecutor] = None
_shared_pool_lock = threading.Lock()


def shared_decode_pool() -> ThreadPoolExecutor:
    """The process-wide decode pool (``pipeline.decode_threads``
    workers), made on first use, so concurrent pipelines share one set
    of decode threads. Callers never shut it down;
    ``reset_shared_decode_pool`` does."""
    global _shared_pool
    with _shared_pool_lock:
        if _shared_pool is None:
            _shared_pool = ThreadPoolExecutor(
                max_workers=configured_decode_threads(),
                thread_name_prefix="pipeline-decode-shared")
        return _shared_pool


def reset_shared_decode_pool() -> None:
    """Shut down and drop the shared pool."""
    global _shared_pool
    with _shared_pool_lock:
        pool, _shared_pool = _shared_pool, None
    if pool is not None:
        pool.shutdown(wait=True)


# ---- fault injection ----------------------------------------------------------


@contextmanager
def inject_fault(hook):
    """Install ``hook(stage, seq)`` at every pipeline stage (the bare
    stage name of ``STAGES`` and the chunk's sequence number); it may
    sleep or raise. An adapter over ``faults.inject``: only the
    ``pipeline.*`` seams reach it."""

    def _adapter(seam, seq, ctx):
        if seam.startswith("pipeline."):
            hook(seam[len("pipeline."):], seq)

    with faults.inject(_adapter):
        yield


def _maybe_fault(stage: str, seq: int) -> None:
    try:
        faults.fire("pipeline." + stage, seq)
    except BaseException:
        telemetry.count("pipeline.faults_injected")
        raise


class _Cancelled(Exception):
    """Internal: a worker saw the cancel flag mid-stage."""


def _us(seconds: float) -> int:
    return max(int(seconds * 1e6), 0)


def pipeline_chunks(sources: Iterable[ChunkSource], *,
                    limiter: Optional[MemoryLimiter] = None,
                    depth: Optional[int] = None,
                    decode_threads: Optional[int] = None,
                    pool: Optional[ThreadPoolExecutor] = None,
                    cancel_token=None) -> Iterator:
    """Run chunk sources through the pipeline; yield device Tables in
    source order.

    ``sources``: zero-argument decode thunks returning a
    ``HostTableChunk`` (the chunked readers' ``chunk_sources()``) or a
    Table, or Tables themselves.

    With a ``limiter``, each chunk is reserved before it is delivered and
    the caller releases ``table_nbytes(chunk)`` after use. For
    ``HostTableChunk`` thunks the reservation is exact and taken before
    the copy, blocking until budget frees. A source that makes device
    Tables directly is resident when its size is learned, so up to
    ``depth + decode_threads`` chunks can be resident then. On error or
    early close every undelivered reservation is released.

    ``pool`` lends a decode executor (``shared_decode_pool()``), which
    is never shut down here. ``cancel_token`` (a
    ``resilience.CancelToken``) is checked in the decode pool before each
    chunk and at each delivery, and wakes a blocked admission;
    cancellation raises ``QueryCancelled`` through the same cleanup as
    any failure."""
    depth = configured_prefetch_depth() if depth is None \
        else max(int(depth), 1)
    workers = configured_decode_threads() if decode_threads is None \
        else max(int(decode_threads), 1)

    telemetry.count("pipeline.runs")
    cancel = threading.Event()
    # one copy stream per device this run stages to, made on first use
    copy_streams: dict = {}
    streams_lock = threading.Lock()

    class _either_cancel:
        """For reserve_blocking: set when the pipeline's own cancel or
        the caller's token fired (``cancelled()`` latches a deadline)."""

        @staticmethod
        def is_set() -> bool:
            return cancel.is_set() or (
                cancel_token is not None and cancel_token.cancelled())

    out_q: "queue.Queue" = queue.Queue(maxsize=depth)
    admit = threading.Condition()
    admit_seq = [0]  # the next sequence number allowed to reserve

    def _advance_turnstile(seq: int) -> None:
        with admit:
            admit_seq[0] = seq + 1
            admit.notify_all()

    def _admission(seq: int, nbytes: int) -> bool:
        """Sequence-ordered budget admission; False when cancelled."""
        t0 = time.perf_counter()
        with admit:
            while admit_seq[0] != seq:
                if _either_cancel.is_set():
                    return False
                admit.wait(0.05)
        ok = True
        try:
            if limiter is not None:
                ok = limiter.reserve_blocking(nbytes, cancel=_either_cancel)
        finally:
            # advance on failure too, so later workers see the cancel
            _advance_turnstile(seq)
        telemetry.count("pipeline.producer_stall_us",
                        _us(time.perf_counter() - t0))
        if ok:
            telemetry.gauge_add("pipeline.chunks_in_flight", 1)
        return ok

    def _copy_stream(device: torch.device):
        with streams_lock:
            if device not in copy_streams:
                copy_streams[device] = torch.cuda.Stream(device)
            return copy_streams[device]

    def _stage(payload: HostTableChunk):
        """The host-to-device copy; on a CUDA device on this run's copy
        stream, with the event the consumer's stream waits on."""
        if payload.device.type != "cuda":
            return payload.stage(), None
        stream = _copy_stream(payload.device)
        with torch.cuda.stream(stream):
            table = payload.stage()
            done = torch.cuda.Event()
            done.record(stream)
        return table, done

    def _work(seq: int, src):
        """Decode, admission and transfer of one chunk on a pool thread:
        ``(table, reserved bytes, copy event or None)``; the reservation
        passes to whoever reads the future."""
        if cancel.is_set():
            raise _Cancelled()
        if cancel_token is not None:
            cancel_token.check("pipeline.decode")
        _maybe_fault("decode", seq)
        t0 = time.perf_counter()
        with trace_range("pipeline.decode"):
            payload = src() if callable(src) else src
        telemetry.count("pipeline.decode_us", _us(time.perf_counter() - t0))
        host_staged = isinstance(payload, HostTableChunk)
        nb = payload.nbytes if host_staged else table_nbytes(payload)
        _maybe_fault("staging", seq)
        with trace_range("pipeline.staging"):
            if not _admission(seq, nb):
                if cancel_token is not None and cancel_token.cancelled():
                    cancel_token.check("pipeline.staging")
                raise _Cancelled()
        held = nb if limiter is not None else 0
        try:
            _maybe_fault("transfer", seq)
            if not host_staged:
                return payload, nb, None
            t1 = time.perf_counter()
            with trace_range("pipeline.transfer"):
                table, done = _stage(payload)
            telemetry.count("pipeline.transfer_us",
                            _us(time.perf_counter() - t1))
            # the consumer releases table_nbytes(chunk): true the
            # reservation up to it (equal by construction)
            actual = table_nbytes(table)
            if limiter is not None and actual != held:
                if actual > held:
                    limiter.reserve(actual - held)
                else:
                    limiter.release(held - actual)
                held = actual
            return table, actual, done
        except BaseException:
            if limiter is not None and held:
                limiter.release(held)
            telemetry.gauge_add("pipeline.chunks_in_flight", -1)
            raise

    owns_pool = pool is None
    if pool is None:
        pool = ThreadPoolExecutor(max_workers=workers,
                                  thread_name_prefix="pipeline-decode")
    submitted: list = []

    def _put_cancellable(item) -> bool:
        while not cancel.is_set():
            try:
                out_q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _pump():
        try:
            seq = 0
            for src in sources:
                if _either_cancel.is_set():
                    return
                fut = pool.submit(_work, seq, src)
                submitted.append(fut)
                if not _put_cancellable(("ok", fut)):
                    return
                seq += 1
        except BaseException as exc:  # re-raised at the consumer
            _put_cancellable(("err", exc))
            return
        _put_cancellable(("end", None))

    pump = threading.Thread(target=_pump, daemon=True, name="pipeline-pump")
    pump.start()
    delivered = 0
    try:
        while True:
            t0 = time.perf_counter()
            kind, payload = out_q.get()
            if kind == "err":
                raise payload
            if kind == "end":
                break
            if cancel_token is not None:
                # before result(): the future's reservation stays with
                # the drain below
                cancel_token.check("pipeline.deliver")
            table, nb, done = payload.result()
            # a delivered chunk is the caller's: keep no reference to it
            submitted[delivered] = payload = None
            if done is not None:
                consumer = torch.cuda.current_stream(
                    table.columns[0].device)
                consumer.wait_event(done)
                for x in table_tensors(table):
                    x.record_stream(consumer)
            telemetry.count("pipeline.consumer_stall_us",
                            _us(time.perf_counter() - t0))
            telemetry.gauge_set("pipeline.queue_depth", out_q.qsize())
            telemetry.gauge_add("pipeline.chunks_in_flight", -1)
            telemetry.count("pipeline.chunks")
            delivered += 1
            yield table
            table = None
    finally:
        cancel.set()
        pump.join()
        if owns_pool:
            pool.shutdown(wait=True)
        # every submitted chunk not delivered that completed holds a
        # reservation nobody else will release; failed workers released
        # their own
        for fut in submitted[delivered:]:
            # exception(), not result(): a re-raise would chain this frame
            # into the stored exception's traceback, a cycle through the
            # futures that keeps their chunks until a cyclic collection
            if fut.exception() is not None:  # propagated, or cancelled
                continue
            nb = fut.result()[1]
            telemetry.gauge_add("pipeline.chunks_in_flight", -1)
            if limiter is not None and nb:
                limiter.release(nb)
        # a failure's traceback holds this frame, and the failed future
        # holds the failure: drop the futures and the last chunk
        submitted.clear()
        table = payload = None
