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
snapshot saved from ``inspect()``. :func:`collect_fleet` and
:func:`collect_cluster` snapshot the open ``QueryFleet`` and
``QueryCluster`` supervisors the same way (``runtime.fleet`` and
``runtime.cluster``), rendered as the per-replica table
(:func:`render_fleet`) and, for a cluster, the per-host table with the
partition map and routing counters (:func:`render_cluster`). Rendering
never raises on a missing key.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional

__all__ = ["collect", "collect_fleet", "collect_cluster", "render_top",
           "render_fleet", "render_cluster"]


def collect() -> List[Dict[str, Any]]:
    """Snapshot every open QueryServer in this process (may be [])."""
    mod = sys.modules.get("spark_rapids_jni_tpu_torch.runtime.server")
    if mod is None:
        return []
    return [srv.inspect() for srv in mod.live_servers()]


def collect_fleet() -> List[Dict[str, Any]]:
    """Snapshot every open QueryFleet supervisor in this process (may be
    []). Same ``sys.modules`` posture as :func:`collect` — no fleet
    module loaded means no fleets. Mesh clusters subclass the fleet and
    register in the same live set; they render through the cluster view
    (:func:`collect_cluster`) instead, so they are skipped here."""
    mod = sys.modules.get("spark_rapids_jni_tpu_torch.runtime.fleet")
    if mod is None:
        return []
    return [f.inspect() for f in mod.live_fleets()
            if not getattr(f, "is_cluster", False)]


def collect_cluster() -> List[Dict[str, Any]]:
    """Snapshot every open QueryCluster mesh supervisor in this process
    (may be []). Same ``sys.modules`` posture — no cluster module loaded
    means no clusters."""
    mod = sys.modules.get("spark_rapids_jni_tpu_torch.runtime.cluster")
    if mod is None:
        return []
    return [c.inspect() for c in mod.live_clusters()]


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


def _render_fleet_one(snap: Dict[str, Any]) -> List[str]:
    lines: List[str] = []
    counters = snap.get("counters") or {}
    lines.append(
        f"pending={snap.get('pending_queries', 0)}  "
        f"memo={snap.get('memo_entries', 0)}  "
        f"learned={snap.get('learned_signatures', 0)}  "
        f"served={counters.get('fleet.served', 0)}  "
        f"failovers={counters.get('fleet.failovers', 0)}  "
        f"deaths={counters.get('fleet.replica_deaths', 0)}  "
        f"quarantines={counters.get('fleet.quarantines', 0)}")
    headers = ("replica", "state", "pid", "gen", "inflight", "served",
               "crashes", "pong_age_s", "restart_in_s", "queued", "leaked")
    rows = []
    for r in snap.get("replicas") or []:
        pong = r.get("last_pong_age_s")
        restart = r.get("restart_in_s")
        load = r.get("load") or {}
        rows.append((
            str(r.get("replica", "?")),
            str(r.get("state", "?")),
            str(r.get("pid") or "-"),
            str(r.get("generation", "-")),
            str(r.get("inflight", 0)),
            str(r.get("served", 0)),
            str(r.get("crashes", 0)),
            "-" if pong is None else f"{pong:.2f}",
            "-" if restart is None else f"{restart:.2f}",
            str(load.get("queued", "-")),
            _fmt_bytes(load.get("leaked")) if "leaked" in load else "-",
        ))
    if not rows:
        lines.append("(no replicas)")
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


def render_fleet(snapshots: Any) -> str:
    """Text view of one :meth:`QueryFleet.inspect` snapshot or a list."""
    if isinstance(snapshots, dict):
        snapshots = [snapshots]
    if not snapshots:
        return "no live query fleets in this process"
    blocks = []
    for i, snap in enumerate(snapshots):
        lines = _render_fleet_one(snap)
        if len(snapshots) > 1:
            lines.insert(0, f"fleet {i}:")
        blocks.append("\n".join(lines))
    return "\n\n".join(blocks)


def _render_cluster_one(snap: Dict[str, Any]) -> List[str]:
    # the host table IS the replica table (one worker per simulated
    # host), rendered by the shared fleet renderer; the cluster adds its
    # partition map and routing counters on top
    lines = _render_fleet_one(snap)
    counters = snap.get("counters") or {}
    lines.insert(1, (
        f"routing: local={counters.get('cluster.route_local', 0)}  "
        f"rehomed={counters.get('cluster.route_rehomed', 0)}  "
        f"fanouts={counters.get('cluster.fanouts', 0)}  "
        f"merges={counters.get('cluster.merges', 0)}  "
        f"host_deaths={counters.get('cluster.host_deaths', 0)}"))
    tables = snap.get("tables") or {}
    for name in sorted(tables):
        t = tables[name]
        owners = t.get("owners") or []
        parts = "  ".join(f"p{i}->{o or '?'}" for i, o in enumerate(owners))
        lines.append(
            f"table {name}: parts={t.get('parts', len(owners))} "
            f"keys={t.get('keys')} rows={t.get('rows', '-')}  [{parts}]")
    return lines


def render_cluster(snapshots: Any) -> str:
    """Text view of one :meth:`QueryCluster.inspect` snapshot or a
    list: per-host worker table + partition map + routing counters."""
    if isinstance(snapshots, dict):
        snapshots = [snapshots]
    if not snapshots:
        return "no live query clusters in this process"
    blocks = []
    for i, snap in enumerate(snapshots):
        lines = _render_cluster_one(snap)
        if len(snapshots) > 1:
            lines.insert(0, f"cluster {i}:")
        blocks.append("\n".join(lines))
    return "\n\n".join(blocks)


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
