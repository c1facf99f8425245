"""The port's serving fleet (``runtime/fleet.py``) with its workers on
the CPU (``device="cpu"``), held against the JAX package.

The chaos families of the reference's fleet tests:

1. **Bit-identity** -- a query served by a worker equals the port's
   in-process ``fusion.execute`` bit for bit and the reference's
   ``execute`` of the same plan on the same inputs; a repeat is served
   from the supervisor's memo.
2. **SIGKILL mid-query** -- the query fails over to the survivor
   bit-identical; the death is a classified ``ReplicaDeadError``
   (``signal:SIGKILL``); nothing leaks.
3. **Heartbeat loss** -- a frozen control plane is declared dead
   (``unresponsive``) and restarted.
4. **Crash-loop quarantine** -- a replica that dies at boot opens its
   breaker after ``fleet.quarantine_after`` boots; a worker told to run
   on a CUDA device where there is none fails its boot the same way.
5. **Bounded failover** -- the budget spent, no healthy replica, a late
   duplicate fingerprint-checked and dropped.
6. **Drain and recycle** -- a planned exit that flushes the learned
   estimates; the next query of the signature is served from the memo.

Plus ``classify_worker_exit`` against the reference's, the ``top``
fleet view, and (slow, as in the reference) the injected dispatch
fault, replica-stamped telemetry and the seeded chaos sweep. Every wait
has its own limit and every fleet is closed by its context manager.
Inputs are made from seeds with numpy. Tolerance: exact everywhere."""

from __future__ import annotations

import json
import os
import signal
import time

import numpy as np
import pytest

from spark_rapids_jni_tpu.models import tpch as jtpch
from spark_rapids_jni_tpu.runtime import resilience as jresilience
from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch.models import tpch
from spark_rapids_jni_tpu_torch.runtime import (
    faults,
    fleet,
    fusion,
    resilience,
    resultcache,
)
from spark_rapids_jni_tpu_torch.telemetry import top as tele_top
from spark_rapids_jni_tpu_torch.utils.config import reset_option, set_option
from torch_parity import (
    assert_same_valid_table,
    quick_reference_compiles,
    ref_execute,
    with_null_tails,
)

SERVE_DELAY = fleet._ENV_SERVE_DELAY
BOOT_CRASH = fleet._ENV_BOOT_CRASH
WAIT_S = 120


@pytest.fixture(autouse=True)
def _isolated_fleet():
    telemetry.reset()
    set_option("fleet.heartbeat_interval_s", 0.1)
    set_option("fleet.restart_backoff_s", 0.1)
    yield
    for k in ("fleet.replicas", "fleet.heartbeat_interval_s",
              "fleet.heartbeat_timeout_s", "fleet.failover_budget",
              "fleet.restart_backoff_s", "fleet.restart_backoff_multiplier",
              "fleet.quarantine_after", "fleet.result_memo_entries",
              "fleet.dispatch_timeout_s", "server.estimate_path",
              "telemetry.enabled", "telemetry.path"):
        reset_option(k)


def _q1(rows=600, seed=11):
    li = tpch.lineitem_table(rows, seed=seed, device="cpu")
    return tpch._q1_plan(), {"lineitem": li}


def _fp(table):
    return resultcache.table_fingerprint(table)


def _wait(predicate, timeout=30.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


def _fleet_events(event):
    return [r for r in telemetry.events("fleet") if r.get("event") == event]


@pytest.fixture(scope="module")
def shared():
    """One 2-replica fleet for the tests that kill nothing (each test
    uses bindings of its own, so the memo holds nothing it reads)."""
    set_option("fleet.heartbeat_interval_s", 0.1)
    with fleet.QueryFleet(2, device="cpu") as f:
        assert f.wait_live(timeout=WAIT_S) == 2
        yield f


@pytest.mark.parametrize("rc", [-9, 1, None, 0])
def test_classify_worker_exit_equals_the_reference(rc):
    got = resilience.classify_worker_exit(rc, replica="r0")
    want = jresilience.classify_worker_exit(rc, replica="r0")
    assert isinstance(got, resilience.ReplicaDeadError)
    assert str(got) == str(want)
    assert got.context == want.context
    assert resilience.is_transient(got, seam="fleet.dispatch")
    assert not resilience.is_transient(got, seam="fleet.heartbeat")
    for seam in ("fleet.dispatch", "fleet.heartbeat", "fleet.worker_exit"):
        assert resilience.classify(EOFError(), seam=seam) \
            is resilience.ReplicaDeadError
    assert resilience.classify(EOFError()) is resilience.FatalExecutionError


# ---------------------------------------------------------------------------
# 1. bit-identity
# ---------------------------------------------------------------------------


def test_fleet_serves_bit_identical_to_execute_and_the_reference(shared):
    n = 600
    li, jli = with_null_tails(jtpch.lineitem_table(n, seed=11),
                              (0, 3, 4, 6), seed=11)
    plan, bindings = tpch._q1_plan(), {"lineitem": li}
    ref = fusion.execute(plan, bindings)
    with quick_reference_compiles():
        jref = ref_execute(jtpch._q1_plan(), {"lineitem": jli}, n)
    f = shared
    first = f.submit("s0", plan, bindings)
    res = first.result(timeout=WAIT_S)
    assert first.status == "served" and first.replica in ("r0", "r1")
    assert res.table.equals(ref.table)
    assert_same_valid_table(res.table, jref.table)
    again = f.submit("s1", plan, bindings)
    res2 = again.result(timeout=WAIT_S)
    assert again.replica == "supervisor"
    assert _fp(res2.table) == _fp(ref.table)
    assert telemetry.counter("fleet.memo_hits") == 1
    assert telemetry.counter("fleet.served") == 1
    # other bindings really run
    _, other = _q1(700, 12)
    got = f.submit("s0", plan, other).result(timeout=WAIT_S)
    assert _fp(got.table) == _fp(fusion.execute(plan, other).table)
    assert telemetry.counter("fleet.served") == 2
    f.fresh_loads()
    assert f.leaked_bytes() == 0


# ---------------------------------------------------------------------------
# 2. kill mid-query
# ---------------------------------------------------------------------------


def test_sigkill_mid_query_fails_over_bit_identical():
    plan, bindings = _q1()
    ref_fp = _fp(fusion.execute(plan, bindings).table)
    with fleet.QueryFleet(2, device="cpu", per_replica_env={
            "r0": {SERVE_DELAY: "1500"}}) as f:
        assert f.wait_live(timeout=WAIT_S) == 2
        ticket = f.submit("chaos", plan, bindings)
        assert _wait(lambda: ticket.replica == "r0", 15), ticket.replica
        time.sleep(0.2)  # inside r0's hold: mid-query
        os.kill(f._find("r0").proc.pid, signal.SIGKILL)
        res = ticket.result(timeout=WAIT_S)
        assert ticket.status == "served"
        assert ticket.dispatches == 2 and ticket.replica == "r1"
        assert _fp(res.table) == ref_fp
        assert telemetry.counter("fleet.replica_deaths.r0") == 1
        assert telemetry.counter("fleet.failovers") == 1
        deaths = _fleet_events("replica_death")
        assert deaths and deaths[0]["replica"] == "r0"
        assert deaths[0]["error_kind"] == "ReplicaDeadError"
        assert "SIGKILL" in deaths[0]["cause"]
        assert _wait(lambda: f._find("r0").state == "live", 60)
        f.fresh_loads()
        assert f.leaked_bytes() == 0


@pytest.mark.slow
def test_injected_dispatch_fault_fails_over():
    """A failure injected at ``fleet.dispatch`` (a failed send) is
    transient at that seam only: the query re-places on the survivor."""
    plan, bindings = _q1()
    ref_fp = _fp(fusion.execute(plan, bindings).table)
    script = faults.FaultScript([faults.FaultSpec(
        "fleet.dispatch",
        resilience.ReplicaDeadError("injected send death"), seq=1)])
    with fleet.QueryFleet(2, device="cpu") as f:
        assert f.wait_live(timeout=WAIT_S) == 2
        with faults.inject(script):
            ticket = f.submit("s0", plan, bindings)
            res = ticket.result(timeout=WAIT_S)
        assert script.fired
        assert ticket.status == "served" and ticket.dispatches == 2
        assert _fp(res.table) == ref_fp
        assert telemetry.counter("fleet.replica_deaths") == 1


# ---------------------------------------------------------------------------
# 3. heartbeat loss
# ---------------------------------------------------------------------------


def test_dropped_heartbeats_classify_unresponsive_and_restart():
    set_option("fleet.heartbeat_timeout_s", 0.6)
    with fleet.QueryFleet(2, device="cpu") as f:
        assert f.wait_live(timeout=WAIT_S) == 2
        r0 = f._find("r0")
        gen = r0.generation
        r0.chan.send({"t": "freeze"})  # wedged, not dead
        assert _wait(lambda: r0.state != "live" or r0.generation != gen, 30)
        assert telemetry.counter("fleet.heartbeats_missed") >= 1
        deaths = _fleet_events("replica_death")
        assert deaths and deaths[0]["replica"] == "r0"
        assert "unresponsive" in deaths[0]["cause"]
        assert _wait(lambda: r0.state == "live", 60)
        assert r0.generation == gen + 1
    assert f not in fleet.live_fleets()  # a closed fleet leaves the view


# ---------------------------------------------------------------------------
# 4. crash-loop quarantine, a worker with no card
# ---------------------------------------------------------------------------


def test_boot_crash_loop_quarantines_within_bound():
    set_option("fleet.quarantine_after", 2)
    plan, bindings = _q1()
    with fleet.QueryFleet(2, device="cpu", per_replica_env={
            "r1": {BOOT_CRASH: "1"}}) as f:
        r1 = f._find("r1")
        assert _wait(lambda: r1.state == "quarantined", 60), r1.state
        assert r1.consecutive_crashes == 2
        assert telemetry.counter("fleet.quarantines") == 1
        boots = telemetry.counter("fleet.boots")
        time.sleep(0.8)
        assert telemetry.counter("fleet.boots") == boots  # quiet
        assert f.wait_live(1, timeout=WAIT_S) >= 1
        got = f.submit("s0", plan, bindings).result(timeout=WAIT_S)
        assert _fp(got.table) == _fp(fusion.execute(plan, bindings).table)


def test_worker_told_cuda_without_a_card_fails_its_boot_classified():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the boot would succeed")
    set_option("fleet.quarantine_after", 1)
    with fleet.QueryFleet(1, device="cuda") as f:
        r0 = f._find("r0")
        assert _wait(lambda: r0.state == "quarantined", 60), r0.state
        deaths = _fleet_events("replica_death")
        assert deaths and deaths[0]["error_kind"] == "ReplicaDeadError"
        assert f"exit:{fleet._EXIT_NO_DEVICE}" in deaths[0]["cause"]
        assert telemetry.counter("fleet.served") == 0


# ---------------------------------------------------------------------------
# 5. bounded failover, no replica, late duplicates
# ---------------------------------------------------------------------------


def test_failover_budget_exhausted_resolves_classified(tmp_path):
    set_option("fleet.failover_budget", 0)
    set_option("fleet.quarantine_after", 1)
    plan, bindings = _q1()
    hold = tmp_path / "r0.hold"  # the worker holds while it exists
    hold.touch()
    with fleet.QueryFleet(1, device="cpu", per_replica_env={
            "r0": {fleet._ENV_SERVE_HOLD_FILE: str(hold)}}) as f:
        assert f.wait_live(timeout=WAIT_S) == 1
        ticket = f.submit("doomed", plan, bindings)
        assert _wait(lambda: ticket.replica == "r0", 15)
        time.sleep(0.2)
        assert not ticket.done()  # held in r0
        os.kill(f._find("r0").proc.pid, signal.SIGKILL)
        with pytest.raises(resilience.ReplicaDeadError,
                           match="failover budget"):
            ticket.result(timeout=WAIT_S)
        assert ticket.status == "failed"


def test_no_healthy_replica_times_out_classified():
    set_option("fleet.quarantine_after", 1)
    set_option("fleet.dispatch_timeout_s", 0.5)
    plan, bindings = _q1()
    with fleet.QueryFleet(1, device="cpu", per_replica_env={
            "r0": {BOOT_CRASH: "1"}}) as f:
        assert _wait(lambda: f._find("r0").state == "quarantined", 60)
        ticket = f.submit("nowhere", plan, bindings)
        with pytest.raises(resilience.ReplicaDeadError,
                           match="no healthy replica"):
            ticket.result(timeout=60)


def test_late_duplicate_result_is_fingerprint_checked_and_dropped(shared):
    plan, bindings = _q1(610, 21)
    f = shared
    ticket = f.submit("s0", plan, bindings)
    res = ticket.result(timeout=WAIT_S)
    r = f._find(ticket.replica)
    dup = {"t": "result", "qid": ticket.qid, "status": "served",
           "table": fleet._encode_table(res.table), "meta": {},
           "wall_ms": 1.0}
    f._on_result(r, r.generation, dup)
    assert telemetry.counter("fleet.duplicate_drops") == 1
    assert telemetry.counter("fleet.identity_mismatch") == 0
    _, other = _q1(600, 99)
    dup2 = dict(dup, table=fleet._encode_table(
        fusion.execute(plan, other).table))
    f._on_result(r, r.generation, dup2)
    assert telemetry.counter("fleet.duplicate_drops") == 2
    assert telemetry.counter("fleet.identity_mismatch") == 1


# ---------------------------------------------------------------------------
# 6. drain and recycle
# ---------------------------------------------------------------------------


def test_recycle_drains_flushes_estimates_and_restarts(tmp_path):
    est = tmp_path / "learned_estimates.json"
    set_option("server.estimate_path", str(est))
    plan, bindings = _q1()
    ref_fp = _fp(fusion.execute(plan, bindings).table)
    with fleet.QueryFleet(1, device="cpu") as f:
        assert f.wait_live(timeout=WAIT_S) == 1
        f.submit("s0", plan, bindings).result(timeout=WAIT_S)
        assert f.recycle("r0", timeout=60)
        r0 = f._find("r0")
        assert r0.generation == 2 and r0.consecutive_crashes == 0
        assert telemetry.counter("fleet.replica_deaths") == 0
        assert telemetry.counter("fleet.drains") == 1
        assert telemetry.counter("fleet.restarts") == 1
        learned = json.loads(est.read_text())
        sig = f"{plan.name}@1024"
        assert sig in learned and learned[sig] > 0, learned
        warm = f.submit("s0", plan, bindings)
        assert _fp(warm.result(timeout=WAIT_S).table) == ref_fp
        assert warm.replica == "supervisor"


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------


def test_inspect_and_top_fleet_view(shared):
    f = shared
    loads = f.fresh_loads()
    assert set(loads) == {"r0", "r1"}
    assert all(ld["launches"] == {} for ld in loads.values())
    snap = f.inspect()
    assert snap["fleet"] is True and snap["device"] == "cpu"
    assert {r["replica"]: (r["state"], r["device"])
            for r in snap["replicas"]} == {"r0": ("live", "cpu"),
                                           "r1": ("live", "cpu")}
    snaps = tele_top.collect_fleet()
    assert snap["replicas"][0]["replica"] in tele_top.render_fleet(snaps)
    text = tele_top.render_fleet(snap)
    assert "r0" in text and "r1" in text and "live" in text


@pytest.mark.slow
def test_worker_telemetry_stamped_with_replica(tmp_path):
    path = tmp_path / "run.jsonl"
    set_option("telemetry.enabled", True)
    set_option("telemetry.path", str(path))
    plan, _ = _q1()
    with fleet.QueryFleet(2, device="cpu") as f:
        assert f.wait_live(timeout=WAIT_S) == 2
        for i in range(2):
            f.submit(f"s{i}", plan, _q1(600 + i, i)[1]).result(
                timeout=WAIT_S)
    recs = [json.loads(line) for line in
            path.read_text().strip().splitlines()]
    replicas = {r.get("replica") for r in recs if r.get("replica")}
    assert replicas & {"r0", "r1"}, replicas
    assert {r["kind"] for r in recs if r.get("replica") in ("r0", "r1")}


@pytest.mark.slow
def test_seeded_chaos_sweep_every_query_accounted():
    """Seeded rounds of SIGKILL mid-query, dropped heartbeats and quiet
    rounds against a stream of queries: every ticket serves
    bit-identical bytes or fails with a classified ReplicaDeadError;
    nothing hangs, leaks, or is served twice."""
    rng = np.random.default_rng(1234)
    set_option("fleet.heartbeat_timeout_s", 0.6)
    set_option("fleet.result_memo_entries", 0)
    plan, _ = _q1()
    cases = []
    for i in range(4):
        b = _q1(560 + 20 * i, 40 + i)[1]
        cases.append((b, _fp(fusion.execute(plan, b).table)))
    with fleet.QueryFleet(2, device="cpu", per_replica_env={
            "r0": {SERVE_DELAY: "600"}}) as f:
        assert f.wait_live(timeout=WAIT_S) == 2
        served = failed = 0
        for _ in range(3):
            tickets = [(f.submit(f"s{i}", plan, b), want)
                       for i, (b, want) in enumerate(cases)]
            chaos = rng.integers(0, 3)
            time.sleep(float(rng.uniform(0.05, 0.3)))
            victim = f._find("r0")
            if chaos == 0 and victim.state == "live":
                os.kill(victim.proc.pid, signal.SIGKILL)
            elif chaos == 1 and victim.state == "live":
                try:
                    victim.chan.send({"t": "freeze"})
                except OSError:
                    pass
            for t, want in tickets:
                try:
                    assert _fp(t.result(timeout=180).table) == want
                    served += 1
                except resilience.ReplicaDeadError:
                    failed += 1
            _wait(lambda: any(r.state == "live" for r in f._replicas), 60)
        assert served + failed == 3 * len(cases) and served > 0
        assert telemetry.counter("fleet.identity_mismatch") == 0
        _wait(lambda: f.leaked_bytes() == 0, 10)
        assert f.leaked_bytes() == 0
