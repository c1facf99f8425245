"""Graceful degradation under memory pressure: the execution-tier
ladder (counterpart of the reference's ``runtime/degrade.py``).

When a classified ``ResourceExhausted`` / ``CapacityOverflow`` escapes
the retry budget, the controller steps the query down a ladder of
bit-identical tiers instead of failing it:

    rung 0  fused       ``fusion.execute``, the port's one plan walk
    rung 2  outofcore   row-chunked partial -> merge under the limiter,
                        the chunk halving on each further pressure
                        failure (completed partials checkpoint in the
                        SpillStore)
    rung 3  parked      wait for the limiter to drain below its low
                        watermark, then retry the most degraded tier

The tier names and rung numbers are the reference's. Its rung 1,
"staged" (the op-by-op oracle beside a fused executable), does not
exist in the port: ``fusion.execute`` has one walk and no second path
to fall to. A pressure failure at "fused" therefore passes rung 1 and
lands on "outofcore" (or on "parked", rung 2, for a query without an
out-of-core runner), and the step that passes it counts as the
reference's two steps did: ``observer`` and the ``degrade`` events read
as the reference's with rung 1 left out, and ``degrade.max_steps``
bounds the same ladder. After a parked wait the most degraded tier that
runs is retried ("outofcore", else "fused").

There is no donation in the port (a plan's walk never consumes its
bound tables), so the reference's liveness check of donated bindings
before each step (``_bindings_live``) has nothing to check and is not
here: every lower tier replays against intact inputs.

Every step records a ``degrade`` step event (tier, trigger, rung) and
fires the ``degrade.step`` seam. A query that exhausts the ladder
re-raises its original classified failure. ``QueryCancelled`` passes
straight through. ``degrade.enabled=false`` makes
:meth:`DegradationController.execute` a plain ``fusion.execute``.
"""

from __future__ import annotations

import logging
from typing import Callable, NamedTuple, Optional

from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.runtime import faults, fusion, resilience
from spark_rapids_jni_tpu_torch.runtime.memory import MemoryLimiter, SpillStore
from spark_rapids_jni_tpu_torch.utils.config import get_option
from spark_rapids_jni_tpu_torch.utils.tracing import trace_range

_log = logging.getLogger(__name__)

__all__ = [
    "DegradableQuery",
    "DegradationController",
    "row_chunked_tier",
]


class DegradableQuery(NamedTuple):
    """One query and what the ladder needs to re-execute it: ``plan`` and
    ``bindings`` as ``fusion.execute`` takes them, and the optional
    out-of-core runner ``outofcore(chunk_rows, cancel_token) -> Table``
    (:func:`row_chunked_tier` builds one); without it the ladder is
    fused -> parked."""

    plan: object
    bindings: dict
    outofcore: Optional[Callable[[int, object], object]] = None


def _row_sliceable(table) -> bool:
    """Can :func:`_row_slice` chunk this table? Nested columns and string
    payloads without a per-row leading dimension (Arrow chars) cannot be
    sliced by row range."""
    n = table.num_rows
    for c in table.columns:
        if c.children:
            return False
        chars = c.chars
        if chars is not None and not (chars.ndim >= 1
                                      and chars.shape[0] == n):
            return False
    return True


def _row_slice(table, start: int, stop: int):
    """A row-range view of a flat table, the out-of-core rung's chunk."""
    from spark_rapids_jni_tpu_torch.columnar import Column, Table

    n = table.num_rows
    cols = []
    for c in table.columns:
        if c.children:
            raise ValueError("row_chunked_tier: nested (LIST/STRUCT) "
                             "columns are not row-sliceable")
        data = c.data
        if data.ndim >= 1 and data.shape[0] == n:
            data = data[start:stop]
        validity = None if c.validity is None else c.validity[start:stop]
        chars = c.chars
        if chars is not None:
            if chars.ndim >= 1 and chars.shape[0] == n:
                chars = chars[start:stop]
            else:
                raise ValueError(
                    "row_chunked_tier: string payload without a per-row "
                    "leading dimension is not row-sliceable")
        cols.append(Column(c.dtype, data, validity, chars=chars))
    return Table(cols)


def row_chunked_tier(bindings: dict, chunk_scan: str, partial_fn: Callable,
                     merge_fn: Callable, *, limiter: MemoryLimiter,
                     spill_budget_bytes: Optional[int] = None,
                     spill_store: Optional[SpillStore] = None
                     ) -> Optional[Callable[[int, object], object]]:
    """A rung-2 runner from a partial -> merge algebra:
    ``bindings[chunk_scan]`` streams in row chunks through
    ``run_chunked_aggregate`` under ``limiter``, partials checkpointed in
    a SpillStore (``spill_store``, or a new one of
    ``spill_budget_bytes``, default the limiter's budget). None when the
    scan is not row-sliceable: the query then has no rung 2, decided
    here and not in the middle of a step."""
    from spark_rapids_jni_tpu_torch.runtime.outofcore import (
        run_chunked_aggregate,
    )

    table = bindings[chunk_scan]
    if not _row_sliceable(table):
        telemetry.record_degrade(
            f"degrade.{chunk_scan}", "tier_unavailable", tier="outofcore",
            trigger="not_row_sliceable", rung=2)
        _log.info("row_chunked_tier: %r is not row-sliceable: no rung 2",
                  chunk_scan)
        return None

    def run(chunk_rows: int, cancel_token=None):
        n = int(table.num_rows)
        rows = max(1, min(int(chunk_rows), n))
        chunks = (_row_slice(table, s, min(s + rows, n))
                  for s in range(0, n, rows))
        spill = spill_store if spill_store is not None else SpillStore(
            spill_budget_bytes if spill_budget_bytes is not None
            else limiter.budget)
        res = run_chunked_aggregate(chunks, partial_fn, merge_fn,
                                    limiter=limiter, spill=spill,
                                    cancel_token=cancel_token)
        return res.table

    return run


def _pressure_kind(exc: BaseException) -> Optional[str]:
    """The pressure class name that makes ``exc`` a ladder trigger, or
    None. Walks the ``__cause__`` chain, so a ``FatalExecutionError`` of
    exhausted retries over a ``CapacityOverflow`` still reads as
    pressure; a ``torch.OutOfMemoryError`` is ``ResourceExhausted``."""
    seen: set = set()
    e: Optional[BaseException] = exc
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        kind = resilience.classify(e)
        if kind is resilience.ResourceExhausted or issubclass(
                kind, resilience.CapacityOverflow):
            return kind.__name__
        e = e.__cause__
    return None


class DegradationController:
    """Steps a live query down the tier ladder on classified pressure;
    one per :class:`MemoryLimiter`."""

    def __init__(self, limiter: MemoryLimiter, *, session: str = "") -> None:
        self.limiter = limiter
        self.session = str(session)

    def execute(self, query: DegradableQuery, *, cancel_token=None,
                label: Optional[str] = None, held_bytes: int = 0,
                observer: Optional[Callable[[str, int, int, Optional[int]],
                                            None]] = None):
        """Run ``query``; a ``fusion.FusedResult``.

        With ``degrade.enabled=false`` this is ``fusion.execute(plan,
        bindings)``. Otherwise a classified ``ResourceExhausted`` /
        ``CapacityOverflow`` steps the ladder (at most
        ``degrade.max_steps`` steps); anything else, and
        ``QueryCancelled`` always, re-raises at once, and exhaustion
        re-raises the original failure. ``held_bytes`` is the caller's
        own reservation, which the parked rung's drain wait discounts.
        ``observer(tier, rung, steps, chunk_rows)`` is called at the
        start of every tier attempt."""
        op = label or f"degrade.{getattr(query.plan, 'name', 'query')}"
        attrs = {"session": self.session} if self.session else {}

        if not get_option("degrade.enabled"):
            return fusion.execute(query.plan, query.bindings,
                                  cancel_token=cancel_token)

        # the reference's ladder; "staged" is passed, never run
        tiers = ["fused", "staged"]
        if query.outofcore is not None:
            tiers.append("outofcore")
        tiers.append("parked")
        max_steps = max(1, int(get_option("degrade.max_steps")))
        park_timeout = float(get_option("degrade.park_timeout_s"))
        chunk_rows = max(1, int(get_option("degrade.chunk_rows")))
        rung = 0        # position in ``tiers``
        steps = 0       # downward steps taken (the telemetry ordinal)
        original: Optional[BaseException] = None
        trigger = "initial"

        while True:
            tier = tiers[min(rung, len(tiers) - 1)]
            if observer is not None:
                observer(tier, rung, steps,
                         chunk_rows if tier == "outofcore" else None)
            try:
                with trace_range(f"rung.{tier}"):
                    if tier == "fused":
                        result = fusion.execute(query.plan, query.bindings,
                                                cancel_token=cancel_token)
                    elif tier == "outofcore":
                        table = query.outofcore(chunk_rows, cancel_token)
                        result = fusion.FusedResult(
                            table, {"degrade.chunk_rows": chunk_rows})
                    else:  # parked
                        telemetry.record_degrade(
                            op, "parked", tier="parked", trigger=trigger,
                            rung=steps, **attrs)
                        drained = self.limiter.wait_below_low(
                            timeout=park_timeout,
                            cancel=None if cancel_token is None
                            else cancel_token.event,
                            own_held=held_bytes)
                        if cancel_token is not None:
                            cancel_token.check("degrade.park")
                        if not drained:
                            telemetry.record_degrade(
                                op, "exhausted", tier="parked",
                                trigger=trigger, rung=steps, **attrs)
                            raise original
                        telemetry.record_degrade(
                            op, "resumed", tier="parked", trigger=trigger,
                            rung=steps, **attrs)
                        # the drain wait discounted evictable cache
                        # bytes: shed them before the retry reserves
                        self.limiter.reclaim_cache()
                        # retry the most degraded tier that runs
                        rung = len(tiers) - 2
                        if tiers[rung] == "staged":
                            rung = 0
                        continue
            except resilience.QueryCancelled:
                raise
            except BaseException as exc:
                if exc is original:
                    raise  # the parked rung re-raising exhaustion
                kind = _pressure_kind(exc)
                if kind is None:
                    raise
                original = original or exc
                steps += 1
                if tier == "outofcore" and chunk_rows > 1:
                    # same rung, half the chunk
                    chunk_rows = max(chunk_rows // 2, 1)
                else:
                    rung += 1
                    if tiers[rung] == "staged":  # no rung 1: pass it
                        rung += 1
                        steps += 1
                if steps > max_steps:
                    telemetry.record_degrade(op, "exhausted", tier=tier,
                                             trigger=kind, rung=steps,
                                             **attrs)
                    raise original from exc
                next_tier = tiers[min(rung, len(tiers) - 1)]
                trigger = kind
                extra = dict(attrs)
                if next_tier == "outofcore":
                    extra["chunk_rows"] = chunk_rows
                # before the step commits: a test can inject here
                faults.fire("degrade.step", steps, tier=next_tier,
                            trigger=kind, chunk_rows=chunk_rows)
                telemetry.record_degrade(op, "step", tier=next_tier,
                                         trigger=kind, rung=steps, **extra)
                _log.info("%s: %s -> %s after %s (step %d)", op, tier,
                          next_tier, kind, steps)
                continue
            if steps > 0:
                telemetry.record_degrade(op, "completed", tier=tier,
                                         trigger=trigger, rung=steps,
                                         **attrs)
            return result
