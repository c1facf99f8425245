"""Live serving introspection: the ``top`` view over in-flight queries
(counterpart of the server view of the reference's ``telemetry/top.py``).

``python -m spark_rapids_jni_tpu_torch.telemetry top`` renders, per
in-flight query: session, plan, ticket status, degradation tier and
rung, held reservation, age, deadline remaining and the deepest open
span; above them the limiter's watermark state and the per-session queue
depths that explain why a query waits.

Two sources feed one renderer: :func:`collect` snapshots every open
``QueryServer`` of this process through ``runtime.server.live_servers()``
(looked up in ``sys.modules``, never imported: no server module loaded
means no servers), and the CLI's optional path argument reads a JSON
snapshot saved from ``inspect()``. The fleet's and the cluster's views
wait for ROADMAP.md Queue 1 entry 12b. Rendering never raises on a
missing key.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional

__all__ = ["collect", "render_top"]


def collect() -> List[Dict[str, Any]]:
    """Snapshot every open QueryServer in this process (may be [])."""
    mod = sys.modules.get("spark_rapids_jni_tpu_torch.runtime.server")
    if mod is None:
        return []
    return [srv.inspect() for srv in mod.live_servers()]


def _fmt_bytes(n: Optional[int]) -> str:
    if n is None:
        return "-"
    n = int(n)
    if n >= 1 << 30:
        return f"{n / (1 << 30):.2f}GiB"
    if n >= 1 << 20:
        return f"{n / (1 << 20):.2f}MiB"
    if n >= 1 << 10:
        return f"{n / (1 << 10):.1f}KiB"
    return str(n)


def _render_one(snap: Dict[str, Any]) -> List[str]:
    lines: List[str] = []
    lim = snap.get("limiter") or {}
    used = lim.get("used", 0)
    budget = lim.get("budget", 0)
    pct = (100.0 * used / budget) if budget else 0.0
    pressure = "PRESSURE" if lim.get("pressure") else "ok"
    lines.append(
        f"limiter: {_fmt_bytes(used)} / {_fmt_bytes(budget)} "
        f"({pct:.0f}%)  peak={_fmt_bytes(lim.get('peak'))}  "
        f"state={pressure}  waiters={lim.get('waiters', 0)} "
        f"(admission={lim.get('admission_waiters', 0)})")
    queues = snap.get("queues") or {}
    if queues:
        depth = "  ".join(f"{sid}={n}" for sid, n in sorted(queues.items()))
        lines.append(f"queued: {snap.get('queued', 0)}  [{depth}]")
    else:
        lines.append(f"queued: {snap.get('queued', 0)}")
    inflight = snap.get("inflight") or []
    headers = ("session", "plan", "status", "tier", "rung", "held",
               "age_s", "deadline_s", "span")
    rows = []
    for q in inflight:
        deadline = q.get("deadline_remaining_s")
        rows.append((
            str(q.get("session", "?")),
            str(q.get("plan", "?")),
            str(q.get("status", "?")),
            str(q.get("tier", "-")),
            str(q.get("rung", "-")),
            _fmt_bytes(q.get("held_bytes")),
            f"{q.get('age_s', 0.0):.3f}",
            "-" if deadline is None else f"{deadline:.3f}",
            str(q.get("current_span") or "-"),
        ))
    if not rows:
        lines.append("(no queries in flight)")
        return lines
    widths = [max(len(headers[i]), max(len(r[i]) for r in rows))
              for i in range(len(headers))]
    lines.append("  ".join(h.ljust(widths[i])
                           for i, h in enumerate(headers)).rstrip())
    lines.append("  ".join("-" * w for w in widths))
    for r in rows:
        lines.append("  ".join(c.ljust(widths[i])
                               for i, c in enumerate(r)).rstrip())
    return lines


def render_top(snapshots: Any) -> str:
    """Text view of one ``inspect()`` snapshot or a list of them."""
    if isinstance(snapshots, dict):
        snapshots = [snapshots]
    if not snapshots:
        return "no live query servers in this process"
    blocks = []
    for i, snap in enumerate(snapshots):
        lines = _render_one(snap)
        if len(snapshots) > 1:
            lines.insert(0, f"server {i}:")
        blocks.append("\n".join(lines))
    return "\n\n".join(blocks)
