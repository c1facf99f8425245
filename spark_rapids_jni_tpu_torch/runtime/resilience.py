"""Resilient execution: one error taxonomy, one retry and escalation
policy (counterpart of the reference's ``runtime/resilience.py``).

- **Taxonomy**: every runtime seam classifies a failure as
  :class:`TransientDeviceError` / :class:`CapacityOverflow` /
  :class:`ResourceExhausted` / :class:`CorruptDataError` /
  :class:`MalformedInputError` / :class:`FatalExecutionError` /
  :class:`QueryCancelled`. Transient kinds are retried; the rest
  propagate at once. A foreign exception is classified for labelling
  (:func:`classify`) and never retried blindly.
- **Retry** (:func:`retrying`, :func:`retry_or_none`): bounded attempts
  (``resilience.max_attempts``) with optional geometric backoff;
  exhaustion raises a :class:`FatalExecutionError` chaining the cause.
- **Capacity escalation** (:func:`escalate`): the shared grow-and-retry
  of the groupby, join and planner auto loops.

Where the port differs from the reference:

- ``torch.OutOfMemoryError`` (the caching allocator's refusal, a
  ``RuntimeError``, not a ``MemoryError``) classifies as
  :class:`ResourceExhausted`, as the reference classifies XLA's HBM
  exhaustion and the limiter's ``MemoryLimitExceeded``.
- The transport seam is ``shuffle.transport`` (``parallel/``): there a
  socket error is a :class:`TransportError` and is retried, and a
  :class:`CorruptDataError` is refetchable, as in the reference. The
  ``dcn.transport`` and fleet seams (``fleet.*``) and
  ``classify_worker_exit`` come with ROADMAP.md Queue 1 entry 12b; away
  from the transport seam a socket error is foreign (fatal, not
  retried) and a :class:`CorruptDataError` is never transient.

Every retry, recovery, escalation and dead end is recorded through
``telemetry.record_resilience`` with its attempt and ladder rung.
``resilience.enabled=false`` makes :func:`retrying` a plain call, and
every call site takes its verbatim pre-resilience path.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional, Tuple, TypeVar

import torch

from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.runtime import faults
from spark_rapids_jni_tpu_torch.utils.config import get_option

__all__ = [
    "ResilienceError",
    "TransientDeviceError",
    "CapacityOverflow",
    "ResourceExhausted",
    "TransportError",
    "CorruptDataError",
    "MalformedInputError",
    "FatalExecutionError",
    "QueryCancelled",
    "ReplicaDeadError",
    "CancelToken",
    "Policy",
    "policy",
    "enabled",
    "classify",
    "classify_worker_exit",
    "is_transient",
    "retrying",
    "retry_or_none",
    "escalate",
]

T = TypeVar("T")


# ---------------------------------------------------------------------------
# taxonomy
# ---------------------------------------------------------------------------


class ResilienceError(RuntimeError):
    """Base of the taxonomy. ``context`` carries the seam's diagnostics
    (rows, capacity, seam, attempt) into the message as ``[k=v, ...]``;
    ``transient`` is the class's retry eligibility."""

    transient = False

    def __init__(self, message: str, **context: Any) -> None:
        if context:
            detail = ", ".join(f"{k}={v}" for k, v in sorted(context.items()))
            message = f"{message} [{detail}]"
        super().__init__(message)
        self.context = context


class TransientDeviceError(ResilienceError):
    """A device-local failure expected to clear on replay."""

    transient = True


class CapacityOverflow(TransientDeviceError):
    """A static capacity (groups, join slots) was too small: recovered
    by :func:`escalate` growing it, not by replay at the same capacity."""


class ResourceExhausted(ResilienceError):
    """A memory budget was exceeded (the MemoryLimiter, the card's
    memory). Not retried blindly: the recovery is structural (spill,
    smaller chunks, less admitted work) and belongs to the budget's
    owner."""

    transient = False


class TransportError(ResilienceError):
    """Transport loss between executors, processes or hosts."""

    transient = True


class CorruptDataError(ResilienceError):
    """A checksummed payload (spill entry, out-of-core checkpoint) failed
    verification. Re-reading the same bytes reproduces the mismatch, so
    it is not transient: the owning seam discards the payload and
    replays from source, or dies classified."""

    transient = False


class MalformedInputError(ResilienceError):
    """Untrusted input (a Parquet/ORC file, filters that disagree on
    their geometry) failed structural validation. Never retried and
    never degraded: the input is wrong, not the engine."""

    transient = False


class FatalExecutionError(ResilienceError):
    """Classified dead end: retries exhausted or failure unrecoverable."""

    transient = False


class QueryCancelled(ResilienceError):
    """Cooperative cancellation (deadline or caller). Never retried,
    never degraded: the query releases everything it holds and stops."""

    transient = False


class ReplicaDeadError(ResilienceError):
    """A serving-fleet replica died (entry 12). Not transient."""

    transient = False


class CancelToken:
    """Cooperative cancellation and wall-clock deadline for one query,
    checked at the boundaries where a query can stop cleanly (chunk and
    merge boundaries, the pipeline's decode pool, a plan's start).
    ``check(where)`` raises :class:`QueryCancelled` once cancelled or past
    the deadline; ``event`` is set on cancellation, so a blocked
    ``MemoryLimiter.reserve_blocking(cancel=...)`` wakes within its poll.
    Every ``check`` fires the ``server.cancel`` seam with its ordinal."""

    def __init__(self, deadline_ms: int = 0, *, label: str = "query") -> None:
        self.label = str(label)
        self.event = threading.Event()
        self.reason: Optional[str] = None
        self._deadline = (None if not deadline_ms
                          else time.monotonic() + float(deadline_ms) / 1000.0)
        self._deadline_ms = int(deadline_ms or 0)
        self._checks = 0

    def cancel(self, reason: str = "cancelled") -> None:
        """Request cancellation; the first reason wins."""
        if not self.event.is_set():
            self.reason = str(reason)
            self.event.set()

    def expired(self) -> bool:
        return self._deadline is not None and time.monotonic() >= self._deadline

    def remaining_s(self) -> Optional[float]:
        """Seconds to the deadline (at least 0), None without one."""
        if self._deadline is None:
            return None
        return max(0.0, self._deadline - time.monotonic())

    def cancelled(self) -> bool:
        """True once cancelled or past the deadline (latches expiry)."""
        if self.event.is_set():
            return True
        if self.expired():
            self.cancel(f"deadline of {self._deadline_ms}ms expired")
            return True
        return False

    def check(self, where: str = "") -> None:
        """Raise :class:`QueryCancelled` if cancellation was requested."""
        self._checks += 1
        faults.fire("server.cancel", self._checks, where=where,
                    label=self.label)
        if self.cancelled():
            raise QueryCancelled(
                f"{self.label}: cancelled at {where or 'checkpoint'}",
                reason=self.reason or "cancelled",
                where=where or "checkpoint")


# Message markers of transient device conditions (XLA's status names in
# the reference; kept for errors that carry them).
_TRANSIENT_MARKERS = ("RESOURCE_EXHAUSTED", "UNAVAILABLE", "DEADLINE_EXCEEDED")
# Transport seams: a socket-layer failure there is a TransportError and
# retry is a protocol concern (``dcn.transport`` comes with entry 12b).
_TRANSPORT_SEAMS = ("shuffle.transport",)


def classify(exc: BaseException, *, seam: str = "") -> type:
    """The taxonomy class of ``exc`` (for labelling and policy).

    Taxonomy exceptions are their own class. A ``MemoryError`` (the
    limiter's ``MemoryLimitExceeded``) and the caching allocator's
    ``torch.OutOfMemoryError`` are :class:`ResourceExhausted`; a message
    with a transient status marker is :class:`TransientDeviceError`;
    a socket-layer error at a transport seam is :class:`TransportError`;
    anything else is :class:`FatalExecutionError`. The exception itself
    is never converted: a caller that gives up re-raises the original.
    The fleet seams that also read ``seam`` come with entry 12b."""
    if isinstance(exc, ResilienceError):
        return type(exc)
    if isinstance(exc, (MemoryError, torch.OutOfMemoryError)):
        return ResourceExhausted
    if seam in _TRANSPORT_SEAMS and isinstance(
            exc, (ConnectionError, TimeoutError, OSError)):
        return TransportError
    if any(marker in str(exc) for marker in _TRANSIENT_MARKERS):
        return TransientDeviceError
    return FatalExecutionError


def is_transient(exc: BaseException, *, seam: str = "") -> bool:
    """Retry eligibility: taxonomy exceptions whose class is transient,
    and foreign socket errors at a transport seam, where retry is a
    protocol concern. A corrupt frame is refetchable at a transport seam
    (the peer still holds a pristine copy) and nowhere else. A foreign
    exception that merely looks transient is not retried, so resilience
    changes no propagation it does not own."""
    if isinstance(exc, CorruptDataError):
        return seam in _TRANSPORT_SEAMS
    if isinstance(exc, ResilienceError):
        return exc.transient
    if seam in _TRANSPORT_SEAMS and isinstance(
            exc, (ConnectionError, TimeoutError)):
        return True
    return False


def classify_worker_exit(returncode: Optional[int], **context: Any):
    """A reaped fleet worker's exit as a classified error: the serving
    fleet is ROADMAP.md Queue 1 entry 12."""
    raise NotImplementedError(
        "classify_worker_exit belongs to the serving fleet, which waits "
        "for ROADMAP.md Queue 1 entries 11-12")


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------


class Policy:
    """A snapshot of the ``resilience.*`` options (one read per run)."""

    __slots__ = ("enabled", "max_attempts", "growth", "backoff_ms",
                 "backoff_multiplier")

    def __init__(self) -> None:
        self.enabled = bool(get_option("resilience.enabled"))
        self.max_attempts = max(1, int(get_option("resilience.max_attempts")))
        self.growth = max(2, int(get_option("resilience.growth")))
        self.backoff_ms = max(0, int(get_option("resilience.backoff_ms")))
        self.backoff_multiplier = max(
            1.0, float(get_option("resilience.backoff_multiplier")))


def policy() -> Policy:
    return Policy()


def enabled() -> bool:
    return bool(get_option("resilience.enabled"))


def _backoff(pol: Policy, attempt: int) -> None:
    if pol.backoff_ms <= 0:
        return
    time.sleep(pol.backoff_ms * (pol.backoff_multiplier ** (attempt - 1))
               / 1000.0)


# ---------------------------------------------------------------------------
# retry
# ---------------------------------------------------------------------------


def retrying(op: str, fn: Callable[[], T], *, seam: str,
             rung: str = "same_capacity", pol: Optional[Policy] = None,
             **context: Any) -> T:
    """Run ``fn`` under the bounded-retry policy.

    Transient failures (:func:`is_transient`) are retried up to
    ``resilience.max_attempts`` attempts in all, with the configured
    backoff; each retry and the recovery are recorded with the attempt
    and ``rung``. A non-transient failure re-raises at once. Exhaustion
    raises :class:`FatalExecutionError` chaining the last cause, whose
    message it embeds. With ``resilience.enabled=false`` this is
    ``fn()``."""
    pol = pol or policy()
    if not pol.enabled:
        return fn()
    attempt = 1
    while True:
        try:
            result = fn()
        except BaseException as exc:
            if not is_transient(exc, seam=seam):
                raise
            error_kind = classify(exc, seam=seam).__name__
            if attempt >= pol.max_attempts:
                telemetry.record_resilience(
                    op, "fatal", seam=seam, attempt=attempt, rung=rung,
                    error_kind=error_kind, **context)
                raise FatalExecutionError(
                    f"{op}: retries exhausted after {attempt} attempts at "
                    f"seam {seam}: {exc}",
                    seam=seam, attempts=attempt, **context) from exc
            telemetry.record_resilience(
                op, "retry", seam=seam, attempt=attempt, rung=rung,
                error_kind=error_kind, **context)
            _backoff(pol, attempt)
            attempt += 1
            continue
        if attempt > 1:
            telemetry.record_resilience(
                op, "recovered", seam=seam, attempt=attempt, rung=rung,
                **context)
        return result


def retry_or_none(op: str, fn: Callable[[], T], *, seam: str,
                  rung: str = "same_capacity", pol: Optional[Policy] = None,
                  **context: Any
                  ) -> Tuple[Optional[T], Optional[BaseException]]:
    """:func:`retrying` that never raises: ``(result, None)`` on success,
    ``(None, final_exc)`` on give-up, for seams that decide themselves
    what follows a give-up."""
    try:
        return retrying(op, fn, seam=seam, rung=rung, pol=pol,
                        **context), None
    except BaseException as exc:  # returned to the caller, which decides
        return None, exc


# ---------------------------------------------------------------------------
# capacity escalation (the grow-static-capacity rung)
# ---------------------------------------------------------------------------


def escalate(op: str,
             attempt_fn: Callable[[int], Tuple[T, bool, Optional[int]]], *,
             seam: str, initial: int, growth: Optional[int] = None,
             max_capacity: Optional[int] = None,
             quantize: Optional[Callable[[int], int]] = None,
             pol: Optional[Policy] = None,
             exhaust: Optional[Callable[[int, int], BaseException]] = None,
             **context: Any) -> T:
    """Bounded geometric capacity escalation, the shared grow-and-retry.

    ``attempt_fn(capacity)`` returns ``(result, needs_more, required)``:
    ``needs_more`` says the capacity overflowed; ``required``, when the
    attempt knows its exact need, jumps the schedule there. Growth is
    geometric (``growth`` or the policy's), optionally quantized,
    clamped to ``max_capacity``; each attempt runs under
    :func:`retrying`. Still overflowing at ``max_capacity`` raises
    ``exhaust(capacity, steps)`` when given, else a classified
    :class:`FatalExecutionError`. Each step records an ``escalate``
    event on rung ``grow_capacity``."""
    pol = pol or policy()
    grow = int(growth) if growth is not None else pol.growth
    cap = max(1, int(initial))
    if max_capacity is not None:
        cap = min(cap, max(1, int(max_capacity)))
    step = 0
    while True:
        result, needs_more, required = retrying(
            op, lambda: attempt_fn(cap), seam=seam, pol=pol,
            capacity=cap, **context)
        if not needs_more:
            if step > 0:
                telemetry.record_resilience(
                    op, "recovered", seam=seam, attempt=step + 1,
                    rung="grow_capacity", capacity=cap, **context)
            return result
        if max_capacity is not None and cap >= int(max_capacity):
            telemetry.record_resilience(
                op, "fatal", seam=seam, attempt=step + 1,
                rung="grow_capacity", capacity=cap, **context)
            if exhaust is not None:
                raise exhaust(cap, step + 1)
            raise FatalExecutionError(
                f"{op}: capacity escalation exhausted at {cap}",
                seam=seam, capacity=cap, steps=step + 1, **context)
        new_cap = cap * grow
        if required is not None:
            new_cap = max(int(required), new_cap)
        if quantize is not None:
            new_cap = int(quantize(new_cap))
        if max_capacity is not None:
            new_cap = min(new_cap, max(1, int(max_capacity)))
        new_cap = max(new_cap, cap + 1)
        step += 1
        telemetry.record_resilience(
            op, "escalate", seam=seam, attempt=step, rung="grow_capacity",
            capacity=new_cap, previous_capacity=cap, **context)
        cap = new_cap
