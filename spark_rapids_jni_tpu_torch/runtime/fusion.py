"""The plan IR and its executor (counterpart of the reference's
``runtime/fusion.py``).

A query is a small logical plan: scan / filter / project / groupby /
join / sort / limit nodes over ``Table`` (plus the dense-PK join, the
runtime bloom filter's build and probe, and the exchange boundary),
named by a ``Plan``. The models build their queries as plans and run
them through ``execute``, as the reference's models do; the out-of-core
runtime (``runtime/outofcore.py``, ``runtime/degrade.py``) and the
serving stack (``runtime/server.py``, ``fleet.py``, ``cluster.py``)
consume the same plans.

The reference traces a plan's region into ONE XLA executable through
``dispatch.call``, over bucket-padded inputs with a ``row_valid`` mask
per input, and keeps its staged op-by-op walk as the bit-identity oracle
and the fallback. The port runs one evaluator: the reference's node walk
(``_eval_plan``) over the inputs as they are, no padding, every
``row_valid`` None, each node's output dropped once its last consumer
has run (XLA frees a traced region's intermediates the same way). Each
node calls the port's operators, which launch the hand-written kernels
where the reference's ops reach Pallas (planned groupby: the accumulate
kernel; joins: the probe kernel). So:

- ``execute`` has no ``force_staged``, ``donate_inputs`` or
  ``surface_pressure``: there is one path and no executable to donate
  into.
- The walk fires the ``fusion.region`` seam first and runs under
  ``resilience.retrying`` (a plain call with ``resilience.enabled``
  off), as the reference's fused region runs under ``retry_or_none``:
  a transient failure replays the walk. There is no staged rung to fall to: when the retries are spent
  (or the failure is not transient) the final exception is raised,
  memory pressure or not, and the degradation ladder
  (``runtime/degrade.py``) takes a pressure failure from there.
- An ``Exchange`` is a host boundary and never runs inside the walk. As
  the root, the child region runs and ``runtime/exchange.py`` packs its
  result into the wire form (``execute_exchange_root``). Mid-plan, the
  plan splits at the deepest interior Exchange
  (``split_at_exchange``) and runs as region -> exchange -> region: the
  pack half as an Exchange root, the remainder once per non-empty
  destination over its rows, the results concatenated in part order
  (counter ``fusion.midplan_exchanges``).
- With ``rtfilter.enabled`` the runtime-filter pass
  (``inject_runtime_filters``, the gate in ``runtime/rtfilter.py``)
  places a ``BloomBuild``/``BloomProbe`` pair at each join it decides to
  filter, before the walk.
- The executor makes no host sync of its own: meta values stay device
  tensors, and every shape comes from the plan and the inputs' row
  counts. The one exception is the runtime filter's harvest: with the
  pass on, each ``BloomProbe`` that ran costs exactly one host read
  after the walk (its ``rows_in`` and ``rows_pass`` stacked into one
  copy), which feeds the learned gate; ``fusion.host_reads`` counts
  them. With the pass off there is none.

Telemetry: ``fusion.regions`` and ``fusion.nodes_fused`` (``stats()``),
and the counters ``fusion.host_reads`` and ``fusion.midplan_exchanges``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.runtime import faults, resilience
from spark_rapids_jni_tpu_torch.telemetry import spans
from spark_rapids_jni_tpu_torch.utils.config import get_option
from spark_rapids_jni_tpu_torch.utils.tracing import trace_range

__all__ = [
    "Scan",
    "Filter",
    "Project",
    "GroupBy",
    "Join",
    "DensePkJoin",
    "BloomBuild",
    "BloomProbe",
    "Sort",
    "Limit",
    "Exchange",
    "Plan",
    "FusedResult",
    "rows_of",
    "min_rows_of",
    "execute",
    "split_at_exchange",
    "inject_runtime_filters",
    "estimate_hbm_bytes",
    "plan_fingerprint",
    "scan_prefix_chains",
    "replace_node",
    "stats",
]


# ---------------------------------------------------------------------------
# resolvable row specs: statics that depend on the inputs' row counts
# ---------------------------------------------------------------------------


def rows_of(name: str, factor: int = 1):
    """out_rows spec: ``factor *`` the bound table's row count."""
    return ("rows_of", name, int(factor))


def min_rows_of(name: str, cap: int):
    """max_groups spec: ``min(cap, row count)``."""
    return ("min_rows_of", name, int(cap))


def _resolve(spec, true_rows: dict) -> Optional[int]:
    if spec is None or isinstance(spec, int):
        return spec
    if isinstance(spec, tuple) and len(spec) == 3:
        kind, name, arg = spec
        if kind == "rows_of":
            return int(true_rows[name]) * arg
        if kind == "min_rows_of":
            return min(arg, int(true_rows[name]))
    raise ValueError(f"unresolvable row spec {spec!r}")


# ---------------------------------------------------------------------------
# logical-plan IR
# ---------------------------------------------------------------------------
#
# Nodes are NamedTuples forming a DAG (shared subplans are shared by
# object identity). Node callables (Filter predicates, Project fns) must
# be module-level functions: plans are fingerprinted by their qualified
# names, with all per-query variation carried in ``params``.


class Scan(NamedTuple):
    """A named input table. ``bucket=False`` marks a table whose row
    count is a planner fact (a clustered dense-PK build); the reference
    keeps it unpadded, and the port pads nothing."""

    name: str
    bucket: bool = True


class Filter(NamedTuple):
    """WHERE by masking: ``pred(table, *params) -> bool[n]``; rows where
    it is False get their validity nulled in every column (never
    compacted)."""

    child: Any
    pred: Callable
    params: tuple = ()


class Project(NamedTuple):
    """``fn(table, *params) -> Table``. ``rowwise=True`` promises output
    rows aligned 1:1 with the input rows. ``rowwise=False`` marks a
    shape-changing compute (q6's full-table multiply-accumulate); the fn
    then receives the region row_valid, always None here, as
    ``fn(table, row_valid, *params)``."""

    child: Any
    fn: Callable
    params: tuple = ()
    rowwise: bool = True


class GroupBy(NamedTuple):
    """``groupby_aggregate``, or ``plan_groupby`` when ``domains`` is
    given. ``max_groups`` may be an int, None or a ``min_rows_of`` spec.
    Meta: ``<label>.num_groups``/``overflowed``/``sum_overflow``, or
    ``<label>.present``/``domain_miss``/``overflowed``/``lowered`` on the
    planned lowering."""

    child: Any
    keys: tuple
    aggs: tuple
    max_groups: Any = None
    domains: Any = None
    budget: int = 4096
    label: str = "groupby"


class Join(NamedTuple):
    """Equi-join + ``apply_join_maps``: left columns then right columns,
    ``out_rows`` output rows (an int or a ``rows_of`` spec). Meta:
    ``<label>.total``."""

    left: Any
    right: Any
    left_on: tuple
    right_on: tuple
    out_rows: Any
    how: str = "inner"
    label: str = "join"


class DensePkJoin(NamedTuple):
    """Planner-declared dense-PK lookup join (``planner.dense_pk_join``):
    probe-aligned output, no capacity. ``key_hi`` may be a ``rows_of``
    spec. Meta: ``<label>.total``/``<label>.pk_violation``."""

    probe: Any
    build: Any
    probe_key: int
    build_key: int
    key_lo: int
    key_hi: Any
    clustered: bool = False
    label: str = "pk_join"


class BloomBuild(NamedTuple):
    """Runtime-filter build side: the child's key column put into a
    Spark-compatible bloom filter (``bloom_put_spark``, null keys
    skipped), emitted as a one-column uint8 bits table."""

    child: Any
    key: int
    num_bits: int
    num_hashes: int
    label: str = "rtf"


class BloomProbe(NamedTuple):
    """Runtime-filter probe side: rows whose key is definitely absent
    from the ``build`` filter get that key's validity nulled (no row is
    compacted, no data byte changes, so the plan's result is the same
    with the probe or without it). ``build`` is a ``BloomBuild`` or a
    Scan bound to a bits table (``packed=True``: the ``to_packed`` wire
    form). Meta: ``<label>.rows_in``/``<label>.rows_pass``."""

    child: Any
    build: Any
    key: int
    num_bits: int
    num_hashes: int
    packed: bool = False
    label: str = "rtf"


class Sort(NamedTuple):
    """``sort_table`` by ``keys``."""

    child: Any
    keys: tuple
    ascending: Any = None
    nulls_first: Any = None


class Limit(NamedTuple):
    """Positional head: the first ``min(count, rows)`` rows."""

    child: Any
    count: int


class Exchange(NamedTuple):
    """Hash repartition of the child's output by ``keys`` (column
    indices, Spark's ``partition_hash``) into ``parts`` destinations, or
    ``parts=0`` for a count chosen at execute time from the
    learned-selectivity store (``exchange.choose_parts``): the exchange
    boundary (``runtime/exchange.py``). ``capacity`` is the
    per-destination slot count (an int, a ``rows_of`` spec, or None for
    the escalation ladder's start); ``valid_meta`` names a child meta
    key holding the child's true row count (an unbounded groupby's
    ``<label>.num_groups``), so padding never rides the wire."""

    child: Any
    keys: tuple
    parts: int
    capacity: Any = None
    valid_meta: Optional[str] = None
    label: str = "exchange"


class Plan(NamedTuple):
    """A named region: one root node."""

    name: str
    root: Any


class FusedResult(NamedTuple):
    table: Table
    # side outputs of labeled nodes: "<label>.<field>" -> device tensor
    # (plus the static plan fact "<label>.lowered")
    meta: dict


# ---------------------------------------------------------------------------
# static plan analysis
# ---------------------------------------------------------------------------


def _children(node) -> tuple:
    if isinstance(node, Scan):
        return ()
    if isinstance(node, (Filter, Project, GroupBy, Sort, Limit, BloomBuild,
                         Exchange)):
        return (node.child,)
    if isinstance(node, Join):
        return (node.left, node.right)
    if isinstance(node, DensePkJoin):
        return (node.probe, node.build)
    if isinstance(node, BloomProbe):
        return (node.child, node.build)
    raise TypeError(f"not a plan node: {type(node).__name__}")


def _topo(root) -> list:
    """Children-first topological order over the node DAG."""
    order: list = []
    seen: set = set()

    def visit(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for c in _children(node):
            visit(c)
        order.append(node)

    visit(root)
    return order


def _scan_names(nodes) -> tuple[list, list]:
    """(bucketed, exact) scan names in first-appearance order. A name
    must be scanned consistently (one bucket flag per table)."""
    bucketed: list = []
    exact: list = []
    flags: dict = {}
    for node in nodes:
        if not isinstance(node, Scan):
            continue
        if node.name in flags:
            if flags[node.name] != node.bucket:
                raise ValueError(
                    f"scan {node.name!r} used both bucketed and exact")
            continue
        flags[node.name] = node.bucket
        (bucketed if node.bucket else exact).append(node.name)
    return bucketed, exact


def _fn_key(fn) -> tuple:
    mod = getattr(fn, "__module__", None)
    qual = getattr(fn, "__qualname__", None)
    if mod is None or qual is None or "<locals>" in (qual or ""):
        raise ValueError(
            "plan callables must be module-level functions (their "
            "qualified name keys the plan's fingerprint); got "
            f"{fn!r}: carry per-query variation in params instead")
    return (mod, qual)


def _fingerprint(nodes, resolved: dict) -> tuple:
    """Structural digest of the plan DAG: node kinds, static params,
    resolved row specs and child indices."""
    index = {id(n): i for i, n in enumerate(nodes)}
    out = []
    for node in nodes:
        kids = tuple(index[id(c)] for c in _children(node))
        if isinstance(node, Scan):
            entry = ("scan", node.name, node.bucket)
        elif isinstance(node, Filter):
            entry = ("filter", _fn_key(node.pred), node.params)
        elif isinstance(node, Project):
            entry = ("project", _fn_key(node.fn), node.params, node.rowwise)
        elif isinstance(node, GroupBy):
            doms = None
            if node.domains is not None:
                doms = tuple(
                    (None if d is None else (tuple(d.values), d.kind))
                    for d in node.domains)
            entry = ("groupby", node.keys, node.aggs,
                     resolved[id(node)], doms, node.budget)
        elif isinstance(node, Join):
            entry = ("join", node.left_on, node.right_on,
                     resolved[id(node)], node.how)
        elif isinstance(node, DensePkJoin):
            entry = ("pk_join", node.probe_key, node.build_key, node.key_lo,
                     resolved[id(node)], node.clustered)
        elif isinstance(node, BloomBuild):
            entry = ("bloom_build", node.key, node.num_bits, node.num_hashes)
        elif isinstance(node, BloomProbe):
            entry = ("bloom_probe", node.key, node.num_bits,
                     node.num_hashes, node.packed)
        elif isinstance(node, Sort):
            entry = ("sort", node.keys,
                     None if node.ascending is None else tuple(node.ascending),
                     None if node.nulls_first is None
                     else tuple(node.nulls_first))
        elif isinstance(node, Limit):
            entry = ("limit", resolved[id(node)])
        elif isinstance(node, Exchange):
            entry = ("exchange", node.keys, node.parts,
                     resolved[id(node)], node.valid_meta)
        else:  # pragma: no cover - _children already rejects
            raise TypeError(type(node).__name__)
        out.append(entry + (kids,))
    return tuple(out)


def _resolve_statics(nodes, true_rows: dict) -> dict:
    """Evaluate every row-count-derived static against the row counts."""
    resolved: dict = {}
    for node in nodes:
        if isinstance(node, GroupBy):
            resolved[id(node)] = _resolve(node.max_groups, true_rows)
        elif isinstance(node, Join):
            resolved[id(node)] = _resolve(node.out_rows, true_rows)
        elif isinstance(node, DensePkJoin):
            resolved[id(node)] = _resolve(node.key_hi, true_rows)
        elif isinstance(node, Limit):
            resolved[id(node)] = int(node.count)
        elif isinstance(node, Exchange):
            resolved[id(node)] = _resolve(node.capacity, true_rows)
    return resolved


def _spaces(nodes) -> dict:
    """Static row-space analysis: node id -> the scan name whose
    positional row space the node's output lives in, or None for
    fixed or derived shapes (group budgets, join capacities)."""
    spaces: dict = {}
    for node in nodes:
        if isinstance(node, Scan):
            spaces[id(node)] = node.name if node.bucket else None
        elif isinstance(node, (Filter, Sort, BloomProbe)):
            spaces[id(node)] = spaces[id(node.child)]
        elif isinstance(node, Project):
            spaces[id(node)] = (
                spaces[id(node.child)] if node.rowwise else None)
        elif isinstance(node, GroupBy):
            # max_groups=None pads the output to the input row count
            if node.max_groups is None and node.domains is None:
                spaces[id(node)] = spaces[id(node.child)]
            else:
                spaces[id(node)] = None
        elif isinstance(node, DensePkJoin):
            spaces[id(node)] = spaces[id(node.probe)]  # probe-aligned
        else:  # Join, Limit, Exchange, BloomBuild: shapes of their own
            spaces[id(node)] = None
    return spaces


def _limit_bound(nodes, resolved: dict, spaces: dict,
                 true_rows: dict) -> None:
    """Clamp Limit counts to the row count of their space."""
    for node in nodes:
        if isinstance(node, Limit):
            space = spaces[id(node.child)]
            if space is not None:
                resolved[id(node)] = min(resolved[id(node)],
                                         int(true_rows[space]))


def _planned_lowering(node: GroupBy) -> str:
    """The static ``lowered`` plan fact, mirroring ``plan_groupby``'s
    eligibility check (it never depends on data)."""
    bounded_ok = (
        all(d is not None for d in node.domains)
        and all(op in ("sum", "count", "mean", "min", "max")
                for _, op in node.aggs)
        and int(np.prod([len(d.values) + 1 for d in node.domains]))
        <= node.budget
    )
    return "bounded" if bounded_ok else "general"


def _bound_true_rows(plan: Plan, nodes, bindings: dict) -> dict:
    """Every scanned table's row count; raises on an unbound scan."""
    bucketed, exact = _scan_names(nodes)
    for name in bucketed + exact:
        if name not in bindings:
            raise KeyError(f"plan {plan.name!r} scans unbound table "
                           f"{name!r}")
    return {name: bindings[name].num_rows for name in bucketed + exact}


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------


def _null_all(table: Table, keep: torch.Tensor) -> Table:
    return Table([
        Column(c.dtype, c.data, c.valid_mask() & keep,
               chars=c.chars, children=c.children)
        for c in table.columns
    ])


def _flag(x, like: torch.Tensor) -> torch.Tensor:
    """A flag as a 0-d bool tensor on ``like``'s device; a Python bool
    becomes a device fill, never a host-to-device copy."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.full((), bool(x), dtype=torch.bool, device=like.device)


def _eval_node(node, kids: list, tables: dict, resolved: dict,
               side: list):
    """One node's output from its children's (``kids``, in
    ``_children`` order); side outputs are appended to ``side``."""
    from spark_rapids_jni_tpu_torch import types as _t
    from spark_rapids_jni_tpu_torch.ops import bloom_filter as _bloom
    from spark_rapids_jni_tpu_torch.ops.groupby import groupby_aggregate
    from spark_rapids_jni_tpu_torch.ops.join import apply_join_maps, join
    from spark_rapids_jni_tpu_torch.ops.planner import (
        dense_pk_join,
        plan_groupby,
    )
    from spark_rapids_jni_tpu_torch.ops.sort import sort_table
    from spark_rapids_jni_tpu_torch.ops.table_ops import trim_table

    if isinstance(node, Scan):
        return tables[node.name]
    if isinstance(node, Filter):
        return _null_all(kids[0], node.pred(kids[0], *node.params))
    if isinstance(node, Project):
        return (node.fn(kids[0], *node.params) if node.rowwise
                else node.fn(kids[0], None, *node.params))
    if isinstance(node, GroupBy):
        if node.domains is not None:
            res = plan_groupby(kids[0], list(node.keys), list(node.aggs),
                               list(node.domains), budget=node.budget)
            side.extend([
                (f"{node.label}.present", res.present),
                (f"{node.label}.domain_miss", res.domain_miss),
                (f"{node.label}.overflowed",
                 _flag(res.overflowed, res.present)),
            ])
            return res.table
        g = groupby_aggregate(kids[0], list(node.keys), list(node.aggs),
                              max_groups=resolved[id(node)])
        side.extend([
            (f"{node.label}.num_groups", g.num_groups),
            (f"{node.label}.overflowed", _flag(g.overflowed, g.num_groups)),
            (f"{node.label}.sum_overflow",
             _flag(g.sum_overflow, g.num_groups)),
        ])
        return g.table
    if isinstance(node, Join):
        maps = join(kids[0], kids[1], list(node.left_on),
                    list(node.right_on), out_size=resolved[id(node)],
                    how=node.how)
        side.append((f"{node.label}.total", maps.total))
        return apply_join_maps(kids[0], kids[1], maps)
    if isinstance(node, DensePkJoin):
        r = dense_pk_join(kids[0], kids[1], node.probe_key, node.build_key,
                          node.key_lo, resolved[id(node)],
                          clustered=node.clustered)
        side.extend([
            (f"{node.label}.total", r.total),
            (f"{node.label}.pk_violation", r.pk_violation),
        ])
        return r.table
    if isinstance(node, BloomBuild):
        col = kids[0].columns[node.key]
        bf = _bloom.BloomFilter(
            torch.zeros((node.num_bits,), dtype=torch.uint8,
                        device=col.device), node.num_hashes)
        bf = _bloom.bloom_put_spark(bf, col.data, col.valid_mask())
        return Table([Column(_t.UINT8, bf.bits)])
    if isinstance(node, BloomProbe):
        tbl, bits = kids[0], kids[1].columns[0].data
        if node.packed:
            bf = _bloom.BloomFilter.from_packed(bits, node.num_bits,
                                                node.num_hashes)
        else:
            bf = _bloom.BloomFilter(bits, node.num_hashes)
        col = tbl.columns[node.key]
        kv = col.valid_mask()
        keep = kv & _bloom.bloom_might_contain_spark(bf, col.data)
        side.extend([
            (f"{node.label}.rows_in", kv.sum(dtype=torch.int32)),
            (f"{node.label}.rows_pass", keep.sum(dtype=torch.int32)),
        ])
        # null only the key's validity where the filter proves the key
        # absent from the build
        cols = list(tbl.columns)
        cols[node.key] = Column(col.dtype, col.data, keep, chars=col.chars,
                                children=col.children)
        return Table(cols)
    if isinstance(node, Sort):
        return sort_table(
            kids[0], list(node.keys),
            None if node.ascending is None else list(node.ascending),
            None if node.nulls_first is None else list(node.nulls_first))
    if isinstance(node, Limit):
        return trim_table(kids[0], resolved[id(node)])
    # an Exchange never reaches the walk (execute splits the plan there)
    raise TypeError(f"not a plan node: {type(node).__name__}")


def _eval_plan(nodes: list, tables: dict, resolved: dict):
    """Evaluate the DAG, ``nodes`` in children-first order, over the
    bound tables: the reference's node walk with every region row_valid
    None. Each node's output is dropped as soon as its last consumer has
    run, so a plan holds no more device memory than its nodes called by
    hand. Returns (root table, [(meta key, value), ...])."""
    uses: dict = {}
    for node in nodes:
        for c in _children(node):
            uses[id(c)] = uses.get(id(c), 0) + 1
    env: dict = {}
    side: list = []
    for node in nodes:
        kids = [env[id(c)] for c in _children(node)]
        out = _eval_node(node, kids, tables, resolved, side)
        del kids
        for c in _children(node):
            uses[id(c)] -= 1
            if not uses[id(c)]:
                del env[id(c)]
        env[id(node)] = out
    return env[id(nodes[-1])], side


# ---------------------------------------------------------------------------
# the runtime-filter planner pass
# ---------------------------------------------------------------------------


def _subtree_rows_estimate(node, bindings: dict) -> int:
    """A static upper bound on the keys a subtree can feed a bloom
    build: its bound scans' rows summed, and any interior join's
    resolved ``out_rows`` taken as a floor. Used only for gating and
    sizing: an overestimate buys a larger filter, never a wrong
    result."""
    nodes = _topo(node)
    rows = sum(int(bindings[n.name].num_rows) for n in nodes
               if isinstance(n, Scan) and n.name in bindings)
    for n in nodes:
        if isinstance(n, Join):
            spec = n.out_rows
            if isinstance(spec, int):
                rows = max(rows, spec)
            elif (isinstance(spec, tuple) and len(spec) == 3
                    and spec[0] == "rows_of" and spec[1] in bindings):
                rows = max(rows,
                           int(bindings[spec[1]].num_rows) * int(spec[2]))
    return rows


def inject_runtime_filters(plan: Plan, bindings: dict) -> Plan:
    """The runtime-filter planner pass: for each single-key inner
    ``Join`` (the smaller side builds) and each ``DensePkJoin`` (the
    build side is the layout's), ask the learned gate
    (``rtfilter.decide``, every decision recorded with its reason)
    whether a filter pays, and where it does put a ``BloomBuild`` over
    the build child and a ``BloomProbe`` over the probe child. The
    result is the same bits with the pass on or off (see
    ``BloomProbe``); the plan's fingerprint changes, so a filtered plan
    never shares a cached result's key with an unfiltered one."""
    from spark_rapids_jni_tpu_torch.runtime import rtfilter

    root = plan.root
    done: set = set()
    while True:
        target = None
        for node in _topo(root):
            if isinstance(node, Join):
                if (node.how != "inner" or len(node.left_on) != 1
                        or len(node.right_on) != 1 or node.label in done):
                    continue
                if isinstance(node.left, BloomProbe) \
                        or isinstance(node.right, BloomProbe):
                    done.add(node.label)
                    continue
                left_rows = _subtree_rows_estimate(node.left, bindings)
                right_rows = _subtree_rows_estimate(node.right, bindings)
                if right_rows <= left_rows:
                    sides = ("left", node.left, node.left_on[0],
                             node.right, node.right_on[0], right_rows)
                else:
                    sides = ("right", node.right, node.right_on[0],
                             node.left, node.left_on[0], left_rows)
                target = (node,) + sides
                break
            if isinstance(node, DensePkJoin):
                if node.label in done:
                    continue
                if isinstance(node.probe, BloomProbe):
                    done.add(node.label)
                    continue
                target = (node, "probe", node.probe, node.probe_key,
                          node.build, node.build_key,
                          _subtree_rows_estimate(node.build, bindings))
                break
        if target is None:
            break
        node, side, probe_child, probe_key, build_child, build_key, \
            build_rows = target
        done.add(node.label)
        decision = rtfilter.decide(plan.name, node.label, build_rows)
        if not decision.apply:
            continue
        rtf_label = f"rtf_{node.label}"
        bb = BloomBuild(build_child, build_key, decision.num_bits,
                        decision.num_hashes, label=rtf_label)
        bp = BloomProbe(probe_child, bb, probe_key, decision.num_bits,
                        decision.num_hashes, label=rtf_label)
        if isinstance(node, DensePkJoin):
            new_node = node._replace(probe=bp)
        elif side == "left":
            new_node = node._replace(left=bp)
        else:
            new_node = node._replace(right=bp)
        root = replace_node(root, node, new_node)
    if root is plan.root:
        return plan
    return plan._replace(root=root)


def _harvest_rtfilter(plan: Plan, nodes, meta: dict) -> None:
    """Feed each probe's pass fraction to the learned gate: one host
    read per ``BloomProbe`` (its two counts in one copy)."""
    probes = [n for n in nodes if isinstance(n, BloomProbe)]
    if not probes:
        return
    from spark_rapids_jni_tpu_torch.runtime import rtfilter

    for n in probes:
        rows_in, rows_pass = torch.stack(
            [meta[f"{n.label}.rows_in"], meta[f"{n.label}.rows_pass"]]
        ).tolist()
        telemetry.count("fusion.host_reads")
        rtfilter.observe(plan.name, n.label, rows_in, rows_pass)


def split_at_exchange(plan: Plan):
    """Break a plan at its deepest interior ``Exchange``. Returns None
    when there is none (a root Exchange is a pack plan of its own);
    otherwise ``(pack_plan, merge_plan, binding, exchange_node)``: the
    pack plan roots the Exchange subtree and the merge plan is the
    remainder with the Exchange swapped for ``Scan(binding)``."""
    nodes = _topo(plan.root)
    xs = [n for n in nodes
          if isinstance(n, Exchange) and n is not plan.root]
    if not xs:
        return None
    x = xs[0]  # _topo is children-first: the deepest boundary splits first
    binding = f"__exchange__{x.label}"
    pack = Plan(f"{plan.name}.pack_{x.label}", x)
    merge = Plan(f"{plan.name}.merge_{x.label}",
                 replace_node(plan.root, x, Scan(binding)))
    return pack, merge, binding, x


def _trim_region_result(res: FusedResult, root) -> Table:
    """The true rows of one destination's merge-region result: an
    unbounded groupby root pads to its input's rows, and only its
    ``<label>.num_groups`` are real (one host read)."""
    from spark_rapids_jni_tpu_torch.ops.table_ops import _slice_rows

    if isinstance(root, GroupBy) and root.max_groups is None:
        return _slice_rows(res.table, 0,
                           int(res.meta[f"{root.label}.num_groups"]))
    return res.table


def _execute_midplan_exchange(plan: Plan, bindings: dict, *,
                              cancel_token) -> FusedResult:
    """A plan with an interior Exchange as region -> exchange -> region:
    the pack half (an Exchange-rooted plan), the wire table regrouped by
    destination, the remainder once per non-empty destination with the
    exchange output bound as its scan, the results concatenated in part
    order. Destination key spaces are disjoint, so the concatenation is
    the plan's result, bit-identical to the hand-split (pack, merge)
    pair and to the ``exchange_local`` oracle."""
    from spark_rapids_jni_tpu_torch.ops.table_ops import (
        _slice_rows,
        concatenate,
    )
    from spark_rapids_jni_tpu_torch.runtime import exchange as _exchange

    pack_plan, merge_plan, binding, x = split_at_exchange(plan)
    pb, pe = _scan_names(_topo(x))
    pack_bindings = {n: bindings[n] for n in pb + pe if n in bindings}
    x = _exchange.resolve_auto_parts(pack_plan.name, x, pack_bindings)
    pack_plan = Plan(pack_plan.name, x)
    mb, me = _scan_names(_topo(merge_plan.root))
    merge_scans = (set(mb) | set(me)) - {binding}
    telemetry.count("fusion.midplan_exchanges")
    label, parts = x.label, int(x.parts)
    with spans.child(f"midplan.{plan.name}", label=label, parts=parts):
        fused = execute(pack_plan, pack_bindings, cancel_token=cancel_token)
        per_dest = _exchange.split_wire(
            fused.table, fused.meta[f"{label}.row_counts"], parts)
        merge_base = {n: bindings[n] for n in merge_scans if n in bindings}
        outs: list = []
        for flights in per_dest:
            if not flights:
                continue
            dest_in = (flights[0] if len(flights) == 1
                       else concatenate(flights))
            res = execute(merge_plan, {**merge_base, binding: dest_in},
                          cancel_token=cancel_token)
            outs.append(_trim_region_result(res, merge_plan.root))
        if outs:
            tbl = outs[0] if len(outs) == 1 else concatenate(outs)
        else:
            res = execute(merge_plan,
                          {**merge_base,
                           binding: _slice_rows(fused.table, 0, 0)},
                          cancel_token=cancel_token)
            tbl = _slice_rows(res.table, 0, 0)
    meta = {
        f"{label}.parts": parts,
        f"{label}.rows": int(fused.meta[f"{label}.rows"]),
        f"{label}.dests": len(outs),
    }
    root = merge_plan.root
    if isinstance(root, GroupBy) and root.max_groups is None:
        # the concatenation is already trimmed: every row is real
        meta[f"{root.label}.num_groups"] = int(tbl.num_rows)
    return FusedResult(tbl, meta)


def execute(plan: Plan, bindings: dict, *,
            cancel_token=None) -> FusedResult:
    """Run one plan over ``bindings`` (Scan name -> Table).

    The node walk runs each node's operator on the bound tables as they
    are, after the ``fusion.region`` seam, under the retry policy. A
    root ``Exchange`` runs through ``exchange.execute_exchange_root``
    and an interior one as region -> exchange -> region.
    ``cancel_token`` (any object with ``check(where)``) is checked once
    before any compute."""
    if cancel_token is not None:
        cancel_token.check(f"fusion.{plan.name}")
    if isinstance(plan.root, Exchange):
        # a host boundary: the pack and the wire form run outside the
        # walk, on the child region's result
        from spark_rapids_jni_tpu_torch.runtime import exchange as _exchange

        return _exchange.execute_exchange_root(plan, bindings,
                                               cancel_token=cancel_token)
    if split_at_exchange(plan) is not None:
        return _execute_midplan_exchange(plan, bindings,
                                         cancel_token=cancel_token)
    if get_option("rtfilter.enabled"):
        plan = inject_runtime_filters(plan, bindings)
    nodes = _topo(plan.root)
    true_rows = _bound_true_rows(plan, nodes, bindings)
    resolved = _resolve_statics(nodes, true_rows)
    _limit_bound(nodes, resolved, _spaces(nodes), true_rows)
    _fingerprint(nodes, resolved)  # module-level callables only
    telemetry.count("fusion.regions")
    telemetry.count("fusion.nodes_fused", len(nodes))

    def _walk():
        # the seam fires before any node runs, so a replay starts clean
        faults.fire("fusion.region", 0, plan=plan.name)
        with trace_range(f"region.{plan.name}"):
            return _eval_plan(nodes, bindings, resolved)

    value, side = resilience.retrying(
        f"fusion.{plan.name}", _walk, seam="fusion.region")
    meta = dict(side)
    meta.update({
        f"{n.label}.lowered": _planned_lowering(n)
        for n in nodes
        if isinstance(n, GroupBy) and n.domains is not None
    })
    _harvest_rtfilter(plan, nodes, meta)
    return FusedResult(value, meta)


def plan_fingerprint(plan: Plan, bindings: dict) -> tuple:
    """Canonical structural digest of a whole plan against its bound row
    counts (the plan half of a result-cache key). Excludes ``plan.name``;
    row-count-derived statics resolve, and Limit counts clamp, as
    ``execute`` resolves them."""
    nodes = _topo(plan.root)
    true_rows = _bound_true_rows(plan, nodes, bindings)
    resolved = _resolve_statics(nodes, true_rows)
    _limit_bound(nodes, resolved, _spaces(nodes), true_rows)
    return _fingerprint(nodes, resolved)


def scan_prefix_chains(root) -> list:
    """Maximal single-consumer chains of Filter / rowwise-Project nodes
    sitting directly on a bucketed Scan: the shareable prefixes a
    subplan cache keys on. Returns ``(scan, top, length)`` tuples;
    ``top`` is never ``root`` itself."""
    nodes = _topo(root)
    consumers: dict = {}
    for node in nodes:
        for c in _children(node):
            consumers.setdefault(id(c), []).append(node)
    chains = []
    for node in nodes:
        if not (isinstance(node, Scan) and node.bucket):
            continue
        top, length = node, 0
        while True:
            nexts = consumers.get(id(top), [])
            if len(nexts) != 1 or nexts[0] is root:
                break
            nxt = nexts[0]
            if not (isinstance(nxt, Filter)
                    or (isinstance(nxt, Project) and nxt.rowwise)):
                break
            top, length = nxt, length + 1
        if length > 0:
            chains.append((node, top, length))
    return chains


def replace_node(root, target, replacement):
    """Rebuild the plan DAG with ``target`` (matched by identity)
    swapped for ``replacement``; shared nodes stay shared and untouched
    subtrees are reused as they are."""
    memo: dict = {id(target): replacement}

    def rebuild(node):
        if id(node) in memo:
            return memo[id(node)]
        kids = _children(node)
        new_kids = tuple(rebuild(c) for c in kids)
        if all(nk is k for nk, k in zip(new_kids, kids)):
            out = node
        elif isinstance(node, (Filter, Project, GroupBy, Sort, Limit,
                               BloomBuild, Exchange)):
            out = node._replace(child=new_kids[0])
        elif isinstance(node, Join):
            out = node._replace(left=new_kids[0], right=new_kids[1])
        elif isinstance(node, DensePkJoin):
            out = node._replace(probe=new_kids[0], build=new_kids[1])
        else:  # BloomProbe
            out = node._replace(child=new_kids[0], build=new_kids[1])
        memo[id(node)] = out
        return out

    return rebuild(root)


def estimate_hbm_bytes(plan: Plan, bindings: dict) -> int:
    """Plan-aware device-memory estimate for admission control: the
    inputs' device bytes plus the output of every capacity-bearing node
    (joins at their resolved ``out_rows``, groupbys at their budget,
    exchanges at parts x capacity) at the inputs' mean row width, plus
    each bloom filter's bytes."""
    from spark_rapids_jni_tpu_torch.runtime.memory import table_nbytes

    nodes = _topo(plan.root)
    true_rows = _bound_true_rows(plan, nodes, bindings)
    resolved = _resolve_statics(nodes, true_rows)
    input_bytes = sum(table_nbytes(bindings[name]) for name in true_rows)
    row_width = max(1, input_bytes // max(1, sum(true_rows.values())))
    out_rows = 0
    extra_bytes = 0
    for node in nodes:
        if isinstance(node, (Join, DensePkJoin)):
            out_rows += int(resolved[id(node)] or 0)
        elif isinstance(node, GroupBy):
            cap = resolved.get(id(node))
            out_rows += int(cap if cap is not None else node.budget)
        elif isinstance(node, BloomBuild):
            extra_bytes += int(node.num_bits)
        elif isinstance(node, Exchange):
            cap = resolved.get(id(node))
            if cap is not None:
                out_rows += int(node.parts) * int(cap)
    return int(input_bytes + out_rows * row_width + extra_bytes)


def stats() -> dict:
    """Plans executed and nodes evaluated since the last
    ``telemetry.reset()``."""
    return {"regions": telemetry.counter("fusion.regions"),
            "nodes_fused": telemetry.counter("fusion.nodes_fused")}
