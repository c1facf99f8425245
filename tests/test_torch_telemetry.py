"""The port's telemetry package (``spark_rapids_jni_tpu_torch/telemetry``)
against the JAX package's.

- The registry's exposition and snapshot after the same instrument
  calls, and ``summary``, ``spans.validate``, ``chrome_trace``,
  ``phase_breakdown``, the report text and the ``top`` view of the same
  record list (made from a seed with numpy), equal the reference's.
- Span trees the port records validate in both packages and trace to the
  same Chrome document.
- The port's own contract: every record is kept in process whatever the
  options (the reference's only with ``telemetry.enabled``), while the
  JSONL sink, the spans and the flight recorder follow the option;
  mandatory fields raise; ``count``/``counter``/``gauge*`` are the
  registry's instruments and ``reset`` clears it; ``trace_range``'s
  ``record=`` form; the CLI.

Tolerance: exact everywhere (the documents are compared as equal
Python values)."""

from __future__ import annotations

import importlib
import json
import threading

import numpy as np
import pytest

from spark_rapids_jni_tpu.telemetry import registry as jregistry
from spark_rapids_jni_tpu.telemetry import report as jreport
from spark_rapids_jni_tpu.telemetry import spans as jspans
from spark_rapids_jni_tpu.telemetry import top as jtop
from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.telemetry import __main__ as cli
from spark_rapids_jni_tpu_torch.telemetry import registry, report, spans, top
from spark_rapids_jni_tpu_torch.utils import config
from spark_rapids_jni_tpu_torch.utils.tracing import trace_range

jevents = importlib.import_module("spark_rapids_jni_tpu.telemetry.events")


@pytest.fixture(autouse=True)
def _reset():
    telemetry.reset()
    yield
    telemetry.reset()
    for name in ("telemetry.enabled", "telemetry.path",
                 "telemetry.flight_recorder_path",
                 "telemetry.flight_recorder_depth"):
        config.reset_option(name)


@pytest.fixture
def enabled(tmp_path):
    path = tmp_path / "run.jsonl"
    config.set_option("telemetry.enabled", True)
    config.set_option("telemetry.path", str(path))
    return path


def _records(seed: int = 0) -> list:
    """A scripted record stream of every kind: three query trees (one
    with a failed and one with a cancelled node, one on two threads) and
    the classified events around them."""
    rng = np.random.default_rng(seed)
    recs = []
    sid = 0
    for q, sess in enumerate(("dash", "etl", "adhoc")):
        t0 = 100.0 + 10 * q
        sid += 1
        root = sid
        dur = float(rng.uniform(1, 3))
        recs.append({"kind": "span", "op": f"query.q{q}", "span": root,
                     "parent": None, "root": root, "t0": t0,
                     "t1": t0 + dur, "status": ["ok", "degraded",
                                                "failed"][q],
                     "tid": 1, "session": sess, "plan": f"q{q}"})
        prev = root
        for name in ("admission.wait", "rung.fused", f"region.q{q}",
                     "pipeline.decode", "pipeline.compute", "spill"):
            sid += 1
            a = t0 + float(rng.uniform(0, dur / 2))
            recs.append({"kind": "span", "op": name, "span": sid,
                         "parent": prev, "root": root, "t0": a,
                         "t1": a + float(rng.uniform(0, dur / 4)),
                         "status": "cancelled" if name == "spill" and q == 1
                         else "ok", "tid": 1 + (name == "pipeline.decode"),
                         "session": sess})
            if name != "admission.wait":
                prev = sid
        recs.append({"kind": "server", "op": f"q{q}", "event": "admitted",
                     "session": sess, "wait_ms": float(rng.uniform(0, 50))})
        recs.append({"kind": "server", "op": f"q{q}", "event": "served",
                     "session": sess})
    recs += [
        {"kind": "dispatch", "op": "region.q0", "engine": "device",
         "wall_ms": 1.5},
        {"kind": "dispatch", "op": "region.q0", "engine": "device",
         "wall_ms": 3.25},
        {"kind": "fallback", "op": "regexp", "reason": "NUL byte",
         "engine": "host", "session": "etl"},
        {"kind": "spill", "op": "spill_store", "reason": "LRU",
         "bytes_moved": 4096},
        {"kind": "resilience", "op": "run", "event": "retry",
         "seam": "outofcore.chunk", "attempt": 1, "rung": "replay_chunk"},
        {"kind": "degrade", "op": "degrade.q1", "event": "step",
         "tier": "outofcore", "trigger": "ResourceExhausted", "rung": 2},
        {"kind": "degrade", "op": "degrade.q1", "event": "completed",
         "tier": "outofcore", "trigger": "ResourceExhausted", "rung": 2},
        {"kind": "integrity", "op": "result_cache", "event": "mismatch",
         "seam": "integrity.cache"},
        {"kind": "cache", "op": "result_cache", "event": "hit",
         "key": "abc@def"},
        {"kind": "cache", "op": "result_cache", "event": "put",
         "key": "abc@def"},
        {"kind": "rtfilter", "op": "tpch_q3/join1", "event": "apply",
         "reason": "no_history_optimistic"},
        {"kind": "compile_cache", "op": "regex_dfa", "hit": True},
        {"kind": "compile_cache", "op": "regex_dfa", "hit": False},
        {"kind": "fleet", "op": "cluster.route", "event": "dispatch",
         "replica": "r0", "host": "h0"},
    ]
    return recs


def _drive(reg) -> None:
    """The same instrument calls on either package's registry."""
    for name, n in (("server.served", 3), ("cache.hit", 1),
                    ("rtfilter.rows_in", 1_000_000), ("9lives", 2)):
        reg.counter(name).inc(n)
    reg.gauge("pipeline.chunks_in_flight").add(2)
    reg.gauge("pipeline.queue_depth").set(5)
    for v in np.random.default_rng(3).uniform(0, 12_000, 40):
        reg.histogram("server.latency_ms").observe(float(v))
    reg.histogram("rtfilter.build_us", bounds=(1.0, 10.0)).observe(50.0)


def test_registry_exposition_matches_reference():
    port, ref = registry.Registry(), jregistry.Registry()
    _drive(port)
    _drive(ref)
    assert port.exposition() == ref.exposition()
    assert port.snapshot() == ref.snapshot()
    assert port.counter_value("cache.hit") == 1
    assert port.counter_value("never") == 0 and "never" not in \
        port.exposition()
    h = port.histogram("server.latency_ms")
    for q in (50, 95, 100):
        assert h.percentile(q) == ref.histogram(
            "server.latency_ms").percentile(q)


def test_summary_matches_reference():
    recs = _records()
    assert telemetry.summary(recs) == jevents.summary(recs)


def test_validate_matches_reference():
    good = _records(1)
    assert spans.validate(good) == jspans.validate(good) == []
    bad = [dict(r) for r in good]
    bad[2]["t1"] = bad[2]["t0"] - 1.0            # end before start
    bad[3]["status"] = "weird"                    # bad status
    bad[4]["parent"] = 10_000                     # orphan parent
    bad.append(dict(bad[5]))                      # duplicate id
    bad.append({"kind": "span", "op": "x", "span": 999, "parent": None,
                "root": 998, "t0": 0.0, "t1": 1.0, "status": "ok"})
    got = spans.validate(bad)
    assert got == jspans.validate(bad)
    assert len(got) == 5


def test_chrome_trace_and_phase_breakdown_match_reference():
    recs = _records(2)
    assert spans.chrome_trace(recs) == jspans.chrome_trace(recs)
    assert spans.phase_breakdown(recs) == jspans.phase_breakdown(recs)


def test_report_and_top_match_reference(tmp_path):
    path = tmp_path / "run.jsonl"
    with open(path, "w") as fh:
        for r in _records(3):
            fh.write(json.dumps(r) + "\n")
        fh.write('{"torn": \n')
    for kw in ({}, {"session": "etl"}, {"kind": "server"}):
        assert report.report(str(path), **kw) == \
            jreport.report(str(path), **kw)
    snap = {"limiter": {"used": 3 << 20, "budget": 1 << 30,
                        "peak": 5 << 20, "pressure": True, "waiters": 2,
                        "admission_waiters": 1},
            "queues": {"dash": 1, "etl": 0}, "queued": 1,
            "inflight": [{"session": "dash", "plan": "tpch_q6",
                          "status": "admitted", "tier": "fused", "rung": 0,
                          "held_bytes": 2048, "age_s": 0.5,
                          "deadline_remaining_s": None,
                          "current_span": "region.tpch_q6"}]}
    for s in (snap, [snap, snap], []):
        assert top.render_top(s) == jtop.render_top(s)


def test_port_span_tree_validates_and_traces_as_reference(enabled):
    def decode(parent):
        with spans.child("pipeline.decode", parent=parent):
            pass

    with telemetry.session_scope("s1"):
        with spans.span("query.q", plan="q") as root:
            with spans.child("admission.wait"):
                pass
            with trace_range("region.q"):
                th = threading.Thread(target=decode, args=(root,))
                th.start()
                th.join(10)
            with pytest.raises(ValueError):
                with spans.child("pipeline.compute"):
                    raise ValueError("boom")
    recs = telemetry.events("span")
    assert len(recs) == 5 and spans.validate(recs) == []
    assert jspans.validate(recs) == []
    assert spans.chrome_trace(recs) == jspans.chrome_trace(recs)
    assert {r["op"]: r["status"] for r in recs}["pipeline.compute"] \
        == "failed"
    # the session scope is per thread: the decode thread's span has none
    assert {r["op"]: r.get("session") for r in recs} == {
        "admission.wait": "s1", "pipeline.decode": None,
        "pipeline.compute": "s1", "region.q": "s1", "query.q": "s1"}
    assert telemetry.flight_records()[-1]["root"] == root.id
    lines = enabled.read_text().splitlines()
    assert [json.loads(x)["span"] for x in lines] == [r["span"] for r in recs]


def test_records_kept_in_process_and_sink_follows_the_option(tmp_path):
    path = tmp_path / "off.jsonl"
    config.set_option("telemetry.path", str(path))
    telemetry.record_server("q", "served", session="a")
    telemetry.record_cache("result_cache", "hit", key="k@f")
    with spans.span("query.q") as sp:
        pass
    assert not sp and not path.exists()
    assert [r["kind"] for r in telemetry.events()] == ["server", "cache"]
    config.set_option("telemetry.enabled", True)
    telemetry.record_rtfilter("p/j", "skip", reason="disabled")
    assert [json.loads(x)["kind"] for x in path.read_text().splitlines()] \
        == ["rtfilter"]
    assert [r["kind"] for r in telemetry.drain()] == [
        "server", "cache", "rtfilter"]
    assert telemetry.events() == []


@pytest.mark.parametrize("call", [
    lambda: telemetry.record_fallback("op", " "),
    lambda: telemetry.record_server("op", "served", session=""),
    lambda: telemetry.record_cache("op", "hit", key=""),
    lambda: telemetry.record_rtfilter("op", "apply", reason=""),
    lambda: telemetry.record_spill("op", ""),
    lambda: telemetry.record_degrade("op", "step", tier="", trigger="x",
                                     rung=1),
    lambda: telemetry.record_integrity("op", "mismatch", seam="x", op="y"),
    lambda: telemetry.session_scope(""),
], ids=["fallback", "server", "cache", "rtfilter", "spill", "degrade",
        "reserved", "session"])
def test_mandatory_fields_raise(call):
    with pytest.raises((ValueError, TypeError)):
        call()


def test_counters_and_gauges_are_the_registry_and_reset_clears_all():
    telemetry.count("fusion.regions")
    telemetry.count("fusion.regions", 4)
    telemetry.gauge_add("pipeline.chunks_in_flight", 2)
    telemetry.gauge_add("pipeline.chunks_in_flight", -2)
    telemetry.gauge_set("pipeline.queue_depth", 3)
    telemetry.record_fallback("regexp", "NUL byte", rows=7)
    assert telemetry.counter("fusion.regions") == 5
    assert telemetry.REGISTRY.counters("fusion.") == {"fusion.regions": 5}
    assert telemetry.gauge("pipeline.chunks_in_flight") == 0
    assert telemetry.gauge("pipeline.queue_depth") == 3
    assert telemetry.fallbacks() == {("regexp", "NUL byte"):
                                     {"calls": 1, "rows": 7}}
    assert telemetry.counter("fallback.regexp") == 1
    with pytest.raises(ValueError):
        telemetry.count("fusion.regions", -1)
    telemetry.reset()
    assert telemetry.REGISTRY.snapshot() == {
        "counters": {}, "gauges": {}, "histograms": {}}
    assert telemetry.events() == [] and telemetry.fallbacks() == {}
    assert telemetry.flight_records() == []


def test_trace_range_record_form(enabled):
    with trace_range("op.ok", record=True):
        pass
    with pytest.raises(KeyError):
        with trace_range("op.bad", record=True):
            raise KeyError("x")
    recs = telemetry.events("dispatch")
    assert [(r["op"], r.get("status"), r.get("error")) for r in recs] == [
        ("op.ok", None, None), ("op.bad", "error", "KeyError")]
    assert all(r["wall_ms"] >= 0 for r in recs)
    config.set_option("telemetry.enabled", False)
    with trace_range("op.off", record=True):
        pass
    assert len(telemetry.events("dispatch")) == 2


def test_flight_record_dump(enabled, tmp_path):
    out = tmp_path / "flight"
    config.set_option("telemetry.flight_recorder_path", str(out))
    config.set_option("telemetry.flight_recorder_depth", 2)
    with spans.span("query.q") as root:
        path = spans.dump_flight_record("rejected", root=root,
                                        state={"queued": 3})
    doc = json.loads(open(path).read())
    assert doc["trigger"] == "rejected" and doc["state"] == {"queued": 3}
    assert doc["tree"]["name"] == "query.q"
    for _ in range(3):
        with spans.span("query.r"):
            pass
    assert len(telemetry.flight_records()) == 2


def test_cli_commands(tmp_path, capsys):
    path = tmp_path / "run.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in _records(4)))
    assert cli.main(["report", "--kind", "server", str(path)]) == 0
    assert "server events:" in capsys.readouterr().out
    out = tmp_path / "trace.json"
    assert cli.main(["trace", str(path), str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc == spans.chrome_trace(report.load_jsonl(str(path)))
    snap = tmp_path / "snap.json"
    snap.write_text(json.dumps({"limiter": {}, "queues": {}}))
    assert cli.main(["top", str(snap)]) == 0
    assert "(no queries in flight)" in capsys.readouterr().out
    assert cli.main(["top"]) == 0
    assert cli.main(["report", "--kind", "nope", str(path)]) == 2
    assert cli.main([]) == 2


def test_serving_modules_leave_jax_unloaded():
    # the telemetry package, its CLI and the serving stack import
    # neither JAX nor the JAX package (tests/test_torch_hygiene.py walks
    # their sources; this imports them)
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys, spark_rapids_jni_tpu_torch.telemetry.__main__, "
            "spark_rapids_jni_tpu_torch.runtime.server, "
            "spark_rapids_jni_tpu_torch.runtime.resultcache, "
            "spark_rapids_jni_tpu_torch.runtime.rtfilter, "
            "spark_rapids_jni_tpu_torch.utils.atomic_io, "
            "spark_rapids_jni_tpu_torch.utils.log; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'spark_rapids_jni_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code],
                          cwd=Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
