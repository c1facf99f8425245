"""Fault injection at named seams (counterpart of the reference's
``runtime/faults.py``).

A seam is a point where a deployment can fail: a memory reservation,
spill IO, a chunk boundary, a pipeline stage, a plan's region, a
degradation step, an integrity boundary. Production code calls
``fire(seam, seq)`` there, and routes managed payload bytes through
``fire_corrupt``; with no injector installed each is one ``is None``
check. Tests install an injector with ``inject(...)``: a callable
``(seam, seq, ctx)`` that raises to inject a fault (a
:class:`FaultScript` of deterministic :class:`FaultSpec`\\ s or seeded
random chaos), which may also corrupt payloads through a
``corrupt_payload(seam, seq, payload, ctx)`` method
(:class:`CorruptionSpec`). Injected raises count ``faults.injected``
and ``faults.injected.<seam>``; mutations ``faults.corrupted`` and
``faults.corrupted.<seam>``.

The seams are the reference's that the port fires. The dispatch seams
(``dispatch.*``) have no counterpart: the port compiles nothing at
dispatch. ``dcn.transport`` and the exchange and fleet seams come with
ROADMAP.md Queue 1 entry 12b.
"""

from __future__ import annotations

import contextlib
import random
import threading
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

from spark_rapids_jni_tpu_torch import telemetry

__all__ = [
    "SEAMS",
    "FaultSpec",
    "CorruptionSpec",
    "FaultScript",
    "fire",
    "fire_corrupt",
    "inject",
    "active_injector",
]

SEAMS: Tuple[str, ...] = (
    # memory layer (runtime/memory.py)
    "memory.reserve",
    "spill.spill",
    "spill.unspill",
    # out-of-core chunk boundaries (runtime/outofcore.py)
    "outofcore.chunk",
    "outofcore.merge",
    # pipelined executor stages (runtime/pipeline.py)
    "pipeline.decode",
    "pipeline.staging",
    "pipeline.transfer",
    "pipeline.compute",
    "pipeline.merge",
    # the shuffle's exchange (parallel/distributed.py)
    "shuffle.transport",
    # a plan's walk (runtime/fusion.py)
    "fusion.region",
    # the serving runtime (runtime/server.py)
    "server.admit",
    "server.execute",
    # cooperative cancellation checkpoints (resilience.CancelToken)
    "server.cancel",
    # degradation ladder steps (runtime/degrade.py)
    "degrade.step",
    # high-watermark crossings of the memory limiter
    "memory.pressure",
    # payload-corruption seams, fired through fire_corrupt()
    "integrity.spill",
    "integrity.checkpoint",
    "integrity.ingest",
    "integrity.cache",
)

_SEAM_SET = frozenset(SEAMS)

_active: Optional[Callable[[str, int, dict], None]] = None
_lock = threading.Lock()


def _check_seam(seam: str) -> None:
    if seam not in _SEAM_SET:
        raise ValueError(f"unknown fault seam {seam!r}; registered: "
                         f"{sorted(_SEAM_SET)}")


def active_injector() -> Optional[Callable[[str, int, dict], None]]:
    """The installed injector, or None."""
    return _active


def fire(seam: str, seq: int = 0, **ctx: Any) -> None:
    """The production seam hook: a no-op unless an injector is
    installed. ``seq`` is the seam's sequence number (chunk index,
    attempt, ordinal); ``ctx`` what the seam knows. An injected raise is
    counted and propagates to the seam's recovery as a real failure
    would."""
    hook = _active
    if hook is None:
        return
    _check_seam(seam)
    try:
        hook(seam, int(seq), ctx)
    except BaseException:
        telemetry.count("faults.injected")
        telemetry.count(f"faults.injected.{seam}")
        raise


def fire_corrupt(seam: str, seq: int, payload: bytes, **ctx: Any) -> bytes:
    """Let the installed injector mutate ``payload`` at ``seam`` before it
    is written or decoded. What ``corrupt_payload`` returns replaces the
    payload (None leaves it alone); detection is the integrity layer's
    job."""
    hook = _active
    if hook is None:
        return payload
    _check_seam(seam)
    corrupt = getattr(hook, "corrupt_payload", None)
    if corrupt is None:
        return payload
    mutated = corrupt(seam, int(seq), payload, ctx)
    if mutated is None or mutated is payload:
        return payload
    telemetry.count("faults.corrupted")
    telemetry.count(f"faults.corrupted.{seam}")
    return mutated


@contextlib.contextmanager
def inject(injector: Callable[[str, int, dict], None]) -> Iterator[None]:
    """Install ``injector`` for the with-block (nested installs stack:
    the inner wins, the outer comes back on exit)."""
    global _active
    with _lock:
        prev = _active
        _active = injector
    try:
        yield
    finally:
        with _lock:
            _active = prev


def _raise_fault(exc) -> None:
    """``exc`` is an exception class, a zero-argument factory or an
    instance; a class gets a standard message."""
    if isinstance(exc, BaseException):
        raise exc
    if isinstance(exc, type) and issubclass(exc, BaseException):
        raise exc("injected fault")
    raise exc()


class FaultSpec:
    """One scheduled fault: raise ``exc`` at a firing of ``seam``.
    ``seq=None`` matches any sequence number; ``times`` bounds how often
    it fires (once by default)."""

    def __init__(self, seam: str, exc, *, seq: Optional[int] = None,
                 times: int = 1) -> None:
        _check_seam(seam)
        self.seam = seam
        self.exc = exc
        self.seq = seq
        self.times = int(times)
        self.fired = 0

    def matches(self, seam: str, seq: int) -> bool:
        if seam != self.seam or self.fired >= self.times:
            return False
        return self.seq is None or int(seq) == self.seq

    def __repr__(self) -> str:
        return (f"FaultSpec(seam={self.seam!r}, seq={self.seq}, "
                f"times={self.times}, fired={self.fired})")


class CorruptionSpec:
    """One scheduled payload corruption at an ``integrity.*`` seam:
    ``"flip"`` XORs one bit of one byte, ``"truncate"`` cuts the payload
    short, ``"trailer"`` clobbers its last 16 bytes. The mutation derives
    from ``(seed, seam, seq, fired)``, never a shared generator, so it
    repeats whatever the thread interleaving, and it always changes the
    bytes."""

    MODES = ("flip", "truncate", "trailer")

    def __init__(self, seam: str, mode: str = "flip", *,
                 seq: Optional[int] = None, times: int = 1,
                 seed: int = 0) -> None:
        _check_seam(seam)
        if mode not in self.MODES:
            raise ValueError(f"unknown corruption mode {mode!r}; one of "
                             f"{self.MODES}")
        self.seam = seam
        self.mode = mode
        self.seq = seq
        self.times = int(times)
        self.seed = int(seed)
        self.fired = 0

    def matches(self, seam: str, seq: int) -> bool:
        if seam != self.seam or self.fired >= self.times:
            return False
        return self.seq is None or int(seq) == self.seq

    def apply(self, payload: bytes, seq: int) -> bytes:
        rng = random.Random(f"{self.seed}|{self.seam}|{int(seq)}|{self.fired}")
        if not payload:
            return payload
        buf = bytearray(payload)
        if self.mode == "flip":
            buf[rng.randrange(len(buf))] ^= 1 << rng.randrange(8)
        elif self.mode == "truncate":
            return bytes(buf[: rng.randrange(len(buf))])
        else:  # trailer
            for i in range(max(0, len(buf) - 16), len(buf)):
                buf[i] ^= rng.randrange(1, 256)
        return bytes(buf)

    def __repr__(self) -> str:
        return (f"CorruptionSpec(seam={self.seam!r}, mode={self.mode!r}, "
                f"seq={self.seq}, times={self.times}, fired={self.fired})")


class FaultScript:
    """A schedule of faults, and the injector itself
    (``with faults.inject(script): ...``).

    ``specs`` fire at their seam and sequence up to their ``times``;
    ``seed`` + ``rate`` (optionally restricted to ``seams``) inject
    ``exc`` with probability ``rate`` at each firing, decided from
    ``(seed, seam, seq, nth)`` so that it repeats whatever the thread
    interleaving; ``corruptions`` mutate payloads at ``integrity.*``
    seams. ``max_faults`` bounds the injections; ``fired`` records
    ``(seam, seq)``."""

    def __init__(self, specs: Optional[Sequence[FaultSpec]] = None, *,
                 corruptions: Optional[Sequence[CorruptionSpec]] = None,
                 seed: Optional[int] = None, rate: float = 0.0,
                 seams: Optional[Sequence[str]] = None, exc=RuntimeError,
                 max_faults: Optional[int] = None) -> None:
        self.specs: List[FaultSpec] = list(specs or [])
        self.corruptions: List[CorruptionSpec] = list(corruptions or [])
        if seams is not None:
            unknown = set(seams) - _SEAM_SET
            if unknown:
                raise ValueError(f"unknown fault seams {sorted(unknown)}")
        self.seed = seed
        self.rate = float(rate)
        self.seams = frozenset(seams) if seams is not None else None
        self.exc = exc
        self.max_faults = max_faults
        self.fired: List[Tuple[str, int]] = []
        self._counts: dict = {}
        self._lock = threading.Lock()

    def __call__(self, seam: str, seq: int, ctx: dict) -> None:
        with self._lock:
            if self.max_faults is not None \
                    and len(self.fired) >= self.max_faults:
                return
            for spec in self.specs:
                if spec.matches(seam, seq):
                    spec.fired += 1
                    self.fired.append((seam, seq))
                    _raise_fault(spec.exc)
            if self.rate > 0.0 and self.seed is not None:
                if self.seams is not None and seam not in self.seams:
                    return
                # the nth firing of this (seam, seq): a retry of the same
                # chunk does not re-hit the same fault by construction
                nth = self._counts.get((seam, seq), 0)
                self._counts[(seam, seq)] = nth + 1
                rng = random.Random(f"{self.seed}|{seam}|{int(seq)}|{nth}")
                if rng.random() < self.rate:
                    self.fired.append((seam, seq))
                    _raise_fault(self.exc)

    def corrupt_payload(self, seam: str, seq: int, payload: bytes,
                        ctx: dict) -> Optional[bytes]:
        """Apply the first matching :class:`CorruptionSpec`, or leave the
        payload alone."""
        with self._lock:
            if self.max_faults is not None \
                    and len(self.fired) >= self.max_faults:
                return None
            for spec in self.corruptions:
                if spec.matches(seam, seq):
                    mutated = spec.apply(payload, seq)
                    spec.fired += 1
                    self.fired.append((seam, seq))
                    return mutated
        return None

    def __repr__(self) -> str:
        return (f"FaultScript(specs={len(self.specs)}, seed={self.seed}, "
                f"rate={self.rate}, fired={len(self.fired)})")
