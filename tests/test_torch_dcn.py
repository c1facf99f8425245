"""The port's host byte transport (``parallel/dcn.py``) against the JAX
package's.

- The wire bytes of ``serialize_table`` equal the reference's for the
  same table (numeric, STRING, DECIMAL128 and LIST columns), with the
  codec on and off and zstd levels 0 and 3; each package's
  ``deserialize_table`` reads the other's bytes.
- A truncated or bit-flipped frame fails loud, never decodes into other
  values; a sealed frame corrupted in flight is NAKed and refetched.
- ``partition_for_slices`` equals the reference's slice by slice; the
  two-slice exchange keeps every row on its key's slice, in one process
  over a socket pair and in two OS processes.
- The grant helpers sign and fingerprint as the reference does, and a
  refused dial surfaces the classified ``TransportError``.

Inputs are made from seeds with numpy. Tolerance: exact everywhere."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

from spark_rapids_jni_tpu.parallel import dcn as jdcn
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu_torch import telemetry
from spark_rapids_jni_tpu_torch import types as t
from spark_rapids_jni_tpu_torch.columnar import Table
from spark_rapids_jni_tpu_torch.ops.hash import partition_hash
from spark_rapids_jni_tpu_torch.parallel import dcn
from spark_rapids_jni_tpu_torch.runtime import faults, resilience
from spark_rapids_jni_tpu_torch.utils import config
from torch_parity import (
    assert_same_table,
    assert_same_table_rows,
    spec_to_jax,
    spec_to_port,
)

WAIT_S = 60
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _specs(n, seed):
    """Host column specs: int64, int32 with nulls, float64, uint64, an
    Arrow STRING with nulls, a DECIMAL128 and a LIST of int64."""
    rng = np.random.default_rng(seed)
    words = [b"", b"a", b"row", b"longer-row", b"\xc3\xa9t\xc3\xa9"]
    strs = [words[i] for i in rng.integers(0, len(words), n)]
    offsets = np.zeros(n + 1, np.int32)
    np.cumsum([len(s) for s in strs], out=offsets[1:])
    chars = np.frombuffer(b"".join(strs), np.uint8).copy()
    limbs = np.stack([rng.integers(-2**62, 2**62, n),
                      rng.integers(-4, 4, n)], axis=1).astype(np.int64)
    lens = rng.integers(0, 4, n)
    loff = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=loff[1:])
    child = (int(t.TypeId.INT64), 0,
             rng.integers(-99, 99, int(loff[-1])).astype(np.int64), None)
    return [
        (int(t.TypeId.INT64), 0, rng.integers(-9, 9, n).astype(np.int64),
         None),
        (int(t.TypeId.INT32), 0, rng.integers(0, 5, n).astype(np.int32),
         rng.random(n) > 0.2),
        (int(t.TypeId.FLOAT64), 0, rng.normal(size=n), None),
        (int(t.TypeId.UINT64), 0,
         rng.integers(0, 2**63, n).astype(np.uint64), rng.random(n) > 0.5),
        (int(t.TypeId.STRING), 0, (offsets, chars), rng.random(n) > 0.1),
        (int(t.TypeId.DECIMAL128), -2, limbs, rng.random(n) > 0.3),
        ("list", loff, rng.random(n) > 0.2, child),
    ]


def _tables(n=200, seed=0):
    specs = _specs(n, seed)
    from spark_rapids_jni_tpu.columnar import Table as JTable

    return (Table([spec_to_port(s) for s in specs]),
            JTable([spec_to_jax(s) for s in specs]))


@pytest.fixture(autouse=True)
def _options():
    telemetry.reset()
    yield
    for name in ("compress.enabled", "compress.wire", "compress.zstd_level",
                 "resilience.max_attempts"):
        config.reset_option(name)
        if name != "resilience.max_attempts":
            jconfig.reset_option(name)


def _both(name, value):
    config.set_option(name, value)
    jconfig.set_option(name, value)


@pytest.mark.parametrize("codec", [True, False])
@pytest.mark.parametrize("level", [0, 3])
def test_wire_bytes_equal_the_reference(codec, level):
    _both("compress.wire", codec)
    _both("compress.zstd_level", level)
    tab, jtab = _tables(seed=level + codec)
    blob = dcn.serialize_table(tab, compress_level=level)
    jblob = jdcn.serialize_table(jtab, compress_level=level)
    assert blob == jblob
    # each package reads the other's frame back to the same table
    assert_same_table_rows(dcn.deserialize_table(jblob, device="cpu"), jtab)
    back = jdcn.deserialize_table(blob)
    for c, jc in zip(tab.columns[:6], back.columns[:6]):
        assert_same_table(Table([c]), type(jtab)([jc]))
    assert back.columns[6].to_pylist() == jtab.columns[6].to_pylist()


@pytest.mark.parametrize("level", [0, 3])
def test_wire_bytes_equal_the_reference_at_the_integer_edges(level):
    """Narrow-range columns at the integer edges (uint64 near 2**64,
    int64 near -2**63) take the dictionary scheme; the frames still
    equal the reference's and read back to the same values."""
    _both("compress.wire", True)
    _both("compress.zstd_level", level)
    rng = np.random.default_rng(level)
    n = 4096
    specs = [
        (int(t.TypeId.UINT64), 0, np.uint64(2**64 - 64)
         + rng.integers(0, 64, n).astype(np.uint64), rng.random(n) > 0.1),
        (int(t.TypeId.INT64), 0, np.int64(-2**63) + rng.integers(0, 64, n),
         None),
    ]
    from spark_rapids_jni_tpu.columnar import Table as JTable

    tab = Table([spec_to_port(s) for s in specs])
    jtab = JTable([spec_to_jax(s) for s in specs])
    blob = dcn.serialize_table(tab, compress_level=level)
    assert blob == jdcn.serialize_table(jtab, compress_level=level)
    back = dcn.deserialize_table(blob, device="cpu")
    for c, b in zip(tab.columns, back.columns):
        assert c.equals(b)
    assert_same_table(back, JTable(list(jdcn.deserialize_table(blob).columns)))


def test_deserialize_restores_the_table_on_its_device():
    tab, _ = _tables(64, seed=3)
    back = dcn.deserialize_table(dcn.serialize_table(tab), device="cpu")
    assert all(c.data.device.type == "cpu" for c in back.columns)
    assert_same_table_rows(back, tab)
    for c, b in zip(tab.columns[:6], back.columns[:6]):
        assert c.equals(b)


def test_truncated_frame_fails_loud():
    tab, _ = _tables(8, seed=1)
    blob = dcn.serialize_table(tab)
    with pytest.raises(ValueError, match="truncated|not a DCN"):
        dcn.deserialize_table(blob[: len(blob) // 2], device="cpu")
    with pytest.raises(ValueError, match="not a DCN"):
        dcn.deserialize_table(b"XXXX" + blob[4:], device="cpu")


def test_bitflip_fuzz_fails_loud_like_the_reference():
    """Flipped bits across a frame: the port raises, or decodes values
    identical to the input (a validity-byte flip may change one column),
    wherever the reference does the same."""
    tab, _ = _tables(64, seed=9)
    blob = bytearray(dcn.serialize_table(tab))
    want = [c.to_pylist() for c in tab.columns]
    rng = np.random.default_rng(9)
    for _ in range(60):
        pos = int(rng.integers(0, len(blob)))
        old = blob[pos]
        blob[pos] ^= 1 << int(rng.integers(0, 8))
        try:
            got = [c.to_pylist() for c in dcn.deserialize_table(
                bytes(blob), device="cpu").columns]
        except Exception:
            pass  # the loud failure
        else:
            if got != want:
                assert sum(1 for a, b in zip(got, want) if a != b) <= 1, pos
        blob[pos] = old


def test_partition_for_slices_equals_the_reference():
    tab, jtab = _tables(300, seed=2)
    # the row gather takes every column but LIST, in both packages
    tab, jtab = Table(tab.columns[:6]), type(jtab)(jtab.columns[:6])
    keys = [0, 1]
    got = dcn.partition_for_slices(tab, keys, 3)
    want = jdcn.partition_for_slices(jtab, keys, 3)
    assert sum(p.num_rows for p in got) == tab.num_rows
    for s, (g, w) in enumerate(zip(got, want)):
        # the same rows in input order (both gathers pad strings)
        assert_same_table_rows(g, w, f"slice {s}")
        if g.num_rows:
            dest = partition_hash(g, keys, 3)
            assert (dest == s).all()


def _slice_tables(n, seed):
    rng = np.random.default_rng(seed)
    from spark_rapids_jni_tpu_torch.columnar import Column

    return Table([
        Column.from_numpy(rng.integers(-9, 9, n).astype(np.int64),
                          device="cpu"),
        Column.from_numpy(rng.integers(0, 5, n).astype(np.int32),
                          validity=rng.random(n) > 0.2, device="cpu"),
    ])


def test_exchange_over_a_local_socket_pair():
    srv = dcn.SliceServer()
    tables = [_slice_tables(150, s) for s in range(2)]
    results, errors = {}, {}

    def run_slice(sid):
        try:
            link = (srv.accept_link(timeout=WAIT_S, device="cpu")
                    if sid == 0 else
                    dcn.SliceLink.connect(srv.port, retries=50,
                                          delay_s=0.05, device="cpu"))
            try:
                results[sid] = dcn.exchange_across_slices(
                    tables[sid], [0], link, sid)
            finally:
                link.close()
        except BaseException as exc:  # surfaced below
            errors[sid] = exc

    th = [threading.Thread(target=run_slice, args=(s,)) for s in range(2)]
    try:
        for x in th:
            x.start()
        for x in th:
            x.join(timeout=WAIT_S)
    finally:
        srv.close()
    assert not errors and set(results) == {0, 1}
    assert sum(r.num_rows for r in results.values()) == 300
    for sid, r in results.items():
        assert (partition_hash(r, [0], 2) == sid).all()


@pytest.mark.parametrize("mode", ["flip", "truncate"])
def test_sealed_frame_corruption_is_refetched(mode):
    tab = _slice_tables(100, 4)
    a, b = socket.socketpair()
    a.settimeout(WAIT_S)
    b.settimeout(WAIT_S)
    out = {}
    script = faults.FaultScript(corruptions=[
        faults.CorruptionSpec("integrity.wire", mode=mode, seed=7)])
    rx = threading.Thread(target=lambda: out.update(
        t=dcn.SliceLink(b, device="cpu").recv_table()))
    try:
        with faults.inject(script):
            rx.start()
            dcn.SliceLink(a).send_table(tab)
            rx.join(WAIT_S)
    finally:
        a.close()
        b.close()
    assert script.fired == [("integrity.wire", 1)]
    assert telemetry.counter("integrity.refetch") == 1
    assert out["t"].equals(tab)


def test_refetch_exhaustion_dies_classified():
    config.set_option("resilience.max_attempts", 2)
    a, b = socket.socketpair()
    a.settimeout(WAIT_S)
    b.settimeout(WAIT_S)
    err = {}
    script = faults.FaultScript(corruptions=[
        faults.CorruptionSpec("integrity.wire", mode="flip", times=10,
                              seed=5)])

    def _rx():
        try:
            dcn.recv_framed(b, 3)
        except BaseException as exc:
            err["rx"] = exc

    rx = threading.Thread(target=_rx)
    try:
        with faults.inject(script):
            rx.start()
            with pytest.raises(resilience.FatalExecutionError,
                               match="rejected frame"):
                dcn.send_framed(a, b"payload" * 50, 3)
            rx.join(WAIT_S)
    finally:
        a.close()
        b.close()
    assert isinstance(err.get("rx"), resilience.FatalExecutionError)
    assert telemetry.counter("integrity.refetch") == 2


def test_grants_and_fingerprints_equal_the_reference():
    key, jkey = dcn.grant_key("boot"), jdcn.grant_key("boot")
    assert key == jkey
    g = dcn.sign_grant(key, xid="x", src="p0", dest="h1", part=1)
    assert g == jdcn.sign_grant(jkey, xid="x", src="p0", dest="h1", part=1)
    assert dcn.verify_grant(key, g, xid="x", src="p0", dest="h1", part=1)
    assert not dcn.verify_grant(key, g, xid="x", src="p0", dest="h1",
                                part=2)
    assert dcn.flight_fingerprint(b"abc") == jdcn.flight_fingerprint(b"abc")


def test_refused_dial_is_a_classified_transport_error():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    with pytest.raises(resilience.ResilienceError) as err:
        dcn.dial(port, retries=2, delay_s=0.01)
    chain = err.value
    while chain is not None and not isinstance(
            chain, resilience.TransportError):
        chain = chain.__cause__
    assert isinstance(chain, resilience.TransportError)
    assert resilience.classify(ConnectionRefusedError(),
                               seam="dcn.transport") \
        is resilience.TransportError


def test_two_slices_in_two_processes_keep_every_row():
    """Two OS processes, one slice each: q1's lineitem keys repartition
    across the link, and each slice's rows are the ones its keys hash to
    (the sums over both slices are the whole table's)."""
    srv_port_sock = socket.socket()
    srv_port_sock.bind(("127.0.0.1", 0))
    port = srv_port_sock.getsockname()[1]
    srv_port_sock.close()
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_dcn_worker.py"),
         str(sid), str(port)], env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for sid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for sid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"slice {sid}:\n{out[-2000:]}"
    sums = [int(o.strip().splitlines()[-1].split()[-1]) for o in outs]
    from spark_rapids_jni_tpu_torch.models import tpch

    whole = sum(int(tpch.lineitem_table(3000, seed=s, device="cpu")
                    .column(0).data.sum()) for s in range(2))
    assert sum(sums) == whole
