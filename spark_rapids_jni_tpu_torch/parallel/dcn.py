"""The host byte transport between processes (counterpart of the
reference's ``parallel/dcn.py``): a versioned, self-describing wire
format for tables, the socket framing with its stop-and-wait ACK/NAK
refetch, the two-slice repartition, and the signed direct peer flights
the cluster's exchange rides.

Inside one process the executors exchange rows through the mesh's
collectives (``parallel/mesh.py``, NCCL on the card). Between processes
(fleet replicas, cluster hosts, slices) rows travel as host bytes: a
table is copied to the host (one synchronize, then one copy a buffer),
framed, sent over a byte stream, and rebuilt on the receiver's own
device. No frame holds a device tensor, so no frame is tied to a CUDA
context.

Wire format (version 1, all little-endian), byte-identical to the
reference's for the same table and options:
  "TPDC" | u32 version | u32 ncols | u64 nrows | ncols x column
  column: i32 type_id | i32 scale | u8 flags (1=validity, 2=chars,
          4=children) | [u32 nchildren] | buffers (data, [validity],
          [chars]) | [children...]
  buffer: u8 dtype_str_len | dtype_str | u8 ndim | ndim x u64 shape |
          u8 compressed | u64 payload_len | payload

``compressed`` is 0 (raw bytes), 1 (whole-buffer zstd) or 2 (a
``runtime/compress.py`` codec frame, the default with ``compress.enabled``
and ``compress.wire`` on; its decode re-checks dtype and shape against
this header). With the codec off the stream is the 0/1 framing.

With ``integrity.enabled`` every framed payload carries the
``runtime/integrity.py`` length+checksum trailer and the link runs a
stop-and-wait ACK/NAK handshake (:func:`send_framed` /
:func:`recv_framed`): a corrupt frame is refetched from the sender's
pristine copy, never decoded. Order per frame: compress, then seal, on
send; verify, decompress, then the post-decode check, on receive.

Direct peer flights: every cluster worker runs a
:class:`PeerFlightServer`, which other hosts dial with exchange flights
under a grant HMAC-signed by the supervisor (key derived from the
cluster's per-boot secret); a dial without a valid grant is refused
before any flight byte is read.
"""

from __future__ import annotations

import struct
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.runtime import compress
from spark_rapids_jni_tpu_torch.types import DType, TypeId
from spark_rapids_jni_tpu_torch.utils.config import get_option
from spark_rapids_jni_tpu_torch.utils.platform import resolve_device
from spark_rapids_jni_tpu_torch.utils.tracing import func_range

__all__ = [
    "PeerFlightServer",
    "SliceLink",
    "SliceServer",
    "deserialize_table",
    "dial",
    "exchange_across_slices",
    "flight_fingerprint",
    "grant_key",
    "partition_for_slices",
    "recv_framed",
    "send_framed",
    "send_peer_flight",
    "serialize_table",
    "sign_grant",
    "verify_grant",
]

_MAGIC = b"TPDC"
_VERSION = 1

# the shared optional-zstandard guard
_zstd = compress.zstd_codec


def _write_buffer(out: list, a: np.ndarray, cctx, codec: bool) -> None:
    a = np.ascontiguousarray(a)
    dts = a.dtype.str.encode()
    out.append(struct.pack("<B", len(dts)))
    out.append(dts)
    out.append(struct.pack("<B", a.ndim))
    out.append(struct.pack(f"<{a.ndim}Q", *a.shape))
    if codec:
        flag, payload = 2, compress.encode_array(a, seam="integrity.wire")
    elif cctx is not None:
        flag, payload = 1, cctx.compress(a)
    else:
        flag, payload = 0, a.tobytes()
    out.append(struct.pack("<BQ", flag, len(payload)))
    out.append(payload)


class _Reader:
    def __init__(self, blob: bytes):
        self.b = blob
        self.i = 0

    def take(self, n: int) -> bytes:
        if self.i + n > len(self.b):
            raise ValueError("truncated DCN frame")
        v = self.b[self.i: self.i + n]
        self.i += n
        return v

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))


def _read_buffer(r: _Reader, dctx) -> np.ndarray:
    (dlen,) = r.unpack("<B")
    dts = r.take(dlen).decode()
    (ndim,) = r.unpack("<B")
    shape = r.unpack(f"<{ndim}Q") if ndim else ()
    compressed, plen = r.unpack("<BQ")
    payload = r.take(plen)
    if compressed == 2:
        # the seal was verified upstream: a decode failure here is the
        # corrupt-after-decompress net, and the header is the
        # post-decode dtype and shape oracle
        arr = compress.decode_array(payload, seam="integrity.wire",
                                    op="dcn.read_buffer")
        if arr.dtype.str != dts or tuple(arr.shape) != tuple(shape):
            raise compress._corrupt(
                "decoded wire buffer disagrees with frame header",
                seam="integrity.wire", op="dcn.read_buffer",
                declared=f"{dts}{tuple(shape)}",
                actual=f"{arr.dtype.str}{tuple(arr.shape)}")
        return arr
    if compressed:
        if dctx is None:
            raise ModuleNotFoundError(
                "zstandard is required to decode a compressed DCN frame")
        payload = dctx.decompress(payload)
    return np.frombuffer(payload, dtype=np.dtype(dts)).reshape(shape)


def _host_array(x: torch.Tensor) -> np.ndarray:
    return x.detach().to("cpu").numpy()


def _write_column(out: list, c: Column, cctx, codec: bool = False) -> None:
    flags = ((1 if c.validity is not None else 0)
             | (2 if c.chars is not None else 0)
             | (4 if c.children else 0))
    out.append(struct.pack("<iiB", int(c.dtype.type_id),
                           c.dtype.scale or 0, flags))
    if c.children:
        out.append(struct.pack("<I", len(c.children)))
    _write_buffer(out, _host_array(c.data), cctx, codec)
    if c.validity is not None:
        _write_buffer(out, _host_array(c.validity), cctx, codec)
    if c.chars is not None:
        _write_buffer(out, _host_array(c.chars), cctx, codec)
    for ch in (c.children or ()):
        _write_column(out, ch, cctx, codec)


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    if not arr.flags.writeable:
        if device.type == "cpu":
            arr = arr.copy()
        else:
            # the copy to the card is the copy; the read-only view of
            # the frame is only its source
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                return torch.from_numpy(arr).to(device)
    return torch.from_numpy(arr).to(device)


def _read_column(r: _Reader, dctx, device: torch.device) -> Column:
    """One column of a frame, its buffers restored on ``device``."""
    type_id, scale, flags = r.unpack("<iiB")
    nchildren = r.unpack("<I")[0] if flags & 4 else 0
    data = _to_device(_read_buffer(r, dctx), device)
    validity = (_to_device(_read_buffer(r, dctx), device)
                if flags & 1 else None)
    chars = _to_device(_read_buffer(r, dctx), device) if flags & 2 else None
    children = [_read_column(r, dctx, device)
                for _ in range(nchildren)] or None
    tid = TypeId(type_id)
    dt = DType(tid, scale) if DType(tid).is_decimal else DType(tid)
    return Column(dt, data, validity, chars=chars, children=children)


@func_range("dcn_serialize_table")
def serialize_table(table: Table, compress_level: int = 3) -> bytes:
    """Table -> one self-describing wire frame, from host copies of its
    buffers (one synchronize of each card the table lives on, then a
    copy a buffer).

    With ``compress.enabled`` + ``compress.wire`` every buffer rides the
    columnar codec (flag 2; ``compress.zstd_level`` is the codec's zstd
    level). Codec off: whole-buffer zstd at ``compress_level`` > 0
    (which requires zstandard), raw flag-0 buffers at level 0."""
    from spark_rapids_jni_tpu_torch.runtime.memory import table_tensors

    devices = {x.device for x in table_tensors(table)
               if x.device.type == "cuda"}
    for d in devices:
        torch.cuda.synchronize(d)
    codec = compress.seam_enabled("integrity.wire")
    cctx = None
    if not codec and compress_level:
        cctx, _ = _zstd(compress_level)
    out: list = [
        _MAGIC,
        struct.pack("<IIQ", _VERSION, table.num_columns, table.num_rows),
    ]
    for c in table.columns:
        _write_column(out, c, cctx, codec)
    return b"".join(out)


@func_range("dcn_deserialize_table")
def deserialize_table(blob: bytes, device=None) -> Table:
    """A wire frame back to a Table on ``device`` (None: the card, and
    an error without one; pass ``device="cpu"`` for the CPU)."""
    dev = resolve_device(device)
    r = _Reader(blob)
    if r.take(4) != _MAGIC:
        raise ValueError("not a DCN table frame")
    version, ncols, _nrows = r.unpack("<IIQ")
    if version != _VERSION:
        raise ValueError(f"DCN frame version {version} != {_VERSION}")
    try:
        _, dctx = _zstd(1)
    except ModuleNotFoundError:
        dctx = None  # uncompressed frames decode without the codec
    return Table([_read_column(r, dctx, dev) for _ in range(ncols)])


@func_range("partition_for_slices")
def partition_for_slices(table: Table, keys: Sequence[int],
                         n_slices: int) -> list[Table]:
    """Split rows by owner slice, ``partition_hash(keys) % n_slices``
    (the outer level of the two-level partitioning). Each slice keeps
    its rows in input order: one stable sort of the destinations, one
    gather, one host read of the per-slice counts, then slices."""
    from spark_rapids_jni_tpu_torch.ops.hash import partition_hash
    from spark_rapids_jni_tpu_torch.ops.sort import gather
    from spark_rapids_jni_tpu_torch.ops.table_ops import _slice_rows

    n_slices = int(n_slices)
    dest = partition_hash(table, list(keys), n_slices).to(torch.int64)
    order = torch.argsort(dest, stable=True)
    counts = torch.bincount(dest, minlength=n_slices).tolist()
    moved = gather(table, order)
    out, lo = [], 0
    for c in counts:
        out.append(_slice_rows(moved, lo, lo + int(c)))
        lo += int(c)
    return out


def _bind_listener(port: int, host: Optional[str], backlog: int):
    """A bound, listening TCP socket on ``host`` (``dcn.bind_host`` when
    None)."""
    import socket as pysock

    srv = pysock.socket()
    srv.setsockopt(pysock.SOL_SOCKET, pysock.SO_REUSEADDR, 1)
    srv.bind((host or str(get_option("dcn.bind_host")), port))
    srv.listen(backlog)
    return srv


def dial(port: int, host: Optional[str] = None, *,
         retries: int = 100, delay_s: float = 0.1):
    """Dial a DCN peer with bounded, classified connect retry: each
    refused attempt is a :class:`~.resilience.TransportError` at the
    ``dcn.transport`` seam, retried under ``resilience.retrying`` with
    ``retries`` attempts ``delay_s`` apart; exhaustion raises the
    classified chain, never a raw ``OSError``. Returns the socket."""
    import socket as pysock
    import time

    from spark_rapids_jni_tpu_torch.runtime import resilience

    peer = host or str(get_option("dcn.bind_host"))

    def _attempt():
        s = pysock.socket()
        try:
            s.connect((peer, port))
            return s
        except OSError as exc:
            s.close()
            raise resilience.TransportError(
                f"dcn.dial: connect to {peer}:{port} failed: {exc}",
                seam="dcn.transport", host=peer, port=port) from exc

    if resilience.enabled():
        pol = resilience.policy()
        pol.max_attempts = max(1, int(retries))
        pol.backoff_ms = max(0, int(delay_s * 1000))
        pol.backoff_multiplier = 1.0
        return resilience.retrying("dcn.dial", _attempt,
                                   seam="dcn.transport", pol=pol,
                                   host=peer, port=port)
    for attempt in range(max(1, int(retries))):
        try:
            return _attempt()
        except resilience.TransportError:
            if attempt == max(1, int(retries)) - 1:
                raise
            time.sleep(delay_s)


class SliceServer:
    """The multi-peer accept side: one listener that many peers dial
    (the cluster supervisor's gateway, a worker's peer flight gateway).
    ``port=0`` binds an ephemeral port (read back from ``.port``);
    ``host`` defaults to ``dcn.bind_host``."""

    def __init__(self, port: int = 0, host: Optional[str] = None,
                 backlog: int = 16):
        self.host = host or str(get_option("dcn.bind_host"))
        self._sock = _bind_listener(port, self.host, backlog)
        self.port = int(self._sock.getsockname()[1])
        self._closed = False

    def accept(self, timeout: Optional[float] = None):
        """The next dial-in as ``(sock, addr)``; ``TimeoutError`` on
        timeout, ``OSError`` once closed."""
        self._sock.settimeout(timeout)
        try:
            return self._sock.accept()
        except TimeoutError:
            raise
        except OSError:
            if self._closed:
                raise OSError("SliceServer is closed")
            raise

    def accept_link(self, timeout: Optional[float] = None, *,
                    device=None) -> "SliceLink":
        """One peer's dial-in as a :class:`SliceLink` whose received
        tables land on ``device`` (None: the card)."""
        conn, _ = self.accept(timeout)
        conn.settimeout(None)
        return SliceLink(conn, device=device)

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "SliceServer":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


_ACK = b"\x06"
_NAK = b"\x15"


def _recv_exact(sock, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], min(n - got, 1 << 24))
        if not k:
            raise ConnectionError("peer slice closed the DCN link")
        got += k
    return bytes(buf)


def send_framed(sock, blob: bytes, seq: int, *,
                op: str = "dcn.send_table",
                corrupt_seam: str = "integrity.wire", **ctx) -> int:
    """Ship one length-prefixed payload under the seal-ordering
    discipline every per-destination send shares.

    Integrity off: a bare 8-byte length prefix, no trailer, no ack.
    Integrity on: seal, the injected-corruption window
    (``corrupt_seam``), send, await the ACK; each NAK re-seals the
    pristine blob and resends, at most ``resilience.max_attempts``
    times, then dies classified with a flight record. Returns the bytes
    of the last frame sent."""
    from spark_rapids_jni_tpu_torch.runtime import faults, integrity, resilience

    if not integrity.enabled():
        sock.sendall(struct.pack("<Q", len(blob)))
        sock.sendall(blob)
        return len(blob)
    attempts = max(1, resilience.policy().max_attempts)
    for attempt in range(1, attempts + 1):
        framed = integrity.seal(blob)
        framed = faults.fire_corrupt(corrupt_seam, seq, framed,
                                     attempt=attempt, **ctx)
        sock.sendall(struct.pack("<Q", len(framed)))
        sock.sendall(framed)
        if _recv_exact(sock, 1) == _ACK:
            return len(framed)
    from spark_rapids_jni_tpu_torch.telemetry import spans

    flight = spans.dump_flight_record(
        "wire_corruption", state={"attempts": attempts, "frame": seq})
    raise resilience.FatalExecutionError(
        f"{op}: peer rejected frame {seq} as corrupt after "
        f"{attempts} resends",
        seam="dcn.transport", attempts=attempts,
        **({"flight_record": flight} if flight else {}))


def recv_framed(sock, seq: int, *, op: str = "dcn.recv_table") -> bytes:
    """Receive one framed payload, the receive half of
    :func:`send_framed`: with integrity on, the trailer is verified and
    a mismatch NAKed for a refetch (both sides share the attempt
    budget, so both die classified rather than deadlock). Returns the
    verified payload; the caller decodes after, never before."""
    from spark_rapids_jni_tpu_torch import telemetry
    from spark_rapids_jni_tpu_torch.runtime import integrity, resilience

    verified = integrity.enabled()
    attempts = max(1, resilience.policy().max_attempts)
    attempt = 1
    while True:
        (length,) = struct.unpack("<Q", _recv_exact(sock, 8))
        framed = _recv_exact(sock, length)
        if not verified:
            return framed
        try:
            blob = integrity.verify(framed, seam="integrity.wire", op=op,
                                    frame=seq, attempt=attempt)
        except resilience.CorruptDataError as exc:
            telemetry.REGISTRY.counter("integrity.refetch").inc()
            telemetry.record_integrity(
                op, "refetch", seam="integrity.wire", nbytes=length,
                attempt=attempt, frame=seq)
            sock.sendall(_NAK)
            if attempt >= attempts:
                from spark_rapids_jni_tpu_torch.telemetry import spans

                flight = spans.dump_flight_record(
                    "wire_corruption",
                    state={"attempts": attempts, "frame": seq})
                raise resilience.FatalExecutionError(
                    f"{op}: frame {seq} corrupt after {attempts} "
                    f"refetches: {exc}",
                    seam="dcn.transport", attempts=attempts,
                    **({"flight_record": flight} if flight else {}),
                ) from exc
            attempt += 1
            continue
        sock.sendall(_ACK)
        if attempt > 1:
            telemetry.record_integrity(
                op, "recovered", seam="integrity.wire", nbytes=length,
                attempt=attempt, frame=seq)
        return blob


class SliceLink:
    """One reliable byte stream to a peer slice: 8-byte length-prefixed
    ``serialize_table`` frames, sealed and acknowledged (ACK 0x06, NAK
    0x15) with ``integrity.enabled``, bare otherwise. ``device`` is
    where received tables land (None: the card)."""

    _ACK = _ACK
    _NAK = _NAK

    def __init__(self, sock, device=None):
        self._sock = sock
        self._device = device
        self._send_seq = 0
        self._recv_seq = 0

    @classmethod
    def listen(cls, port: int, host: Optional[str] = None, *,
               device=None, timeout: Optional[float] = None) -> "SliceLink":
        srv = _bind_listener(port, host, backlog=1)
        srv.settimeout(timeout)
        try:
            conn, _ = srv.accept()
        finally:
            srv.close()
        conn.settimeout(None)
        return cls(conn, device=device)

    @classmethod
    def connect(cls, port: int, host: Optional[str] = None,
                retries: int = 100, delay_s: float = 0.1, *,
                device=None) -> "SliceLink":
        return cls(dial(port, host, retries=retries, delay_s=delay_s),
                   device=device)

    def send_table(self, table: Table, compress_level: int = 3) -> int:
        from spark_rapids_jni_tpu_torch.runtime import faults, integrity, resilience

        def _frame():
            # seam and retry cover serialization only: once bytes are
            # on the wire a blind replay would corrupt the stream
            faults.fire("dcn.transport", 0, direction="send",
                        rows=table.num_rows)
            return serialize_table(table, compress_level)

        if resilience.enabled():
            blob = resilience.retrying("dcn.send_table", _frame,
                                       seam="dcn.transport",
                                       rows=table.num_rows)
        else:
            blob = _frame()
        if integrity.enabled():
            self._send_seq += 1
        return send_framed(self._sock, blob, self._send_seq,
                           op="dcn.send_table", rows=table.num_rows)

    def recv_table(self) -> Table:
        from spark_rapids_jni_tpu_torch.runtime import faults, integrity, resilience

        def _entry():
            # fires before any read, so an injected fault cannot desync
            # the framing
            faults.fire("dcn.transport", 0, direction="recv")

        if resilience.enabled():
            resilience.retrying("dcn.recv_table", _entry,
                                seam="dcn.transport")
        else:
            _entry()
        if integrity.enabled():
            self._recv_seq += 1
        return deserialize_table(
            recv_framed(self._sock, self._recv_seq, op="dcn.recv_table"),
            device=self._device)

    def close(self) -> None:
        self._sock.close()


@func_range("exchange_across_slices")
def exchange_across_slices(table: Table, keys: Sequence[int],
                           link: SliceLink, slice_id: int,
                           n_slices: int = 2,
                           compress_level: int = 3) -> Table:
    """Two-slice repartition: keep the rows this slice owns, ship the
    rest over ``link``, receive the peer's, concatenate (mine first).
    The lower slice id sends first, so the exchange cannot deadlock."""
    if n_slices != 2:
        raise NotImplementedError("the slice exchange models exactly "
                                  "two slices")
    from spark_rapids_jni_tpu_torch.ops.table_ops import concatenate

    parts = partition_for_slices(table, keys, n_slices)
    mine, theirs = parts[slice_id], parts[1 - slice_id]
    if slice_id == 0:
        link.send_table(theirs, compress_level)
        received = link.recv_table()
    else:
        received = link.recv_table()
        link.send_table(theirs, compress_level)
    if received.num_rows == 0:
        return mine
    if mine.num_rows == 0:
        return received
    return concatenate([mine, received])


# ---------------------------------------------------------------------------
# direct peer flights: HMAC-signed dial grants and the worker flight gateway
# ---------------------------------------------------------------------------

_GRANT_INFO = b"spark-rapids-tpu/peer-grant/v1"


def grant_key(boot_secret: str) -> bytes:
    """The per-boot peer-grant HMAC key, derived from the cluster's boot
    secret (which reaches each worker in its launch environment, never
    over the data path)."""
    import hashlib
    import hmac

    return hmac.new(boot_secret.encode("utf-8"), _GRANT_INFO,
                    hashlib.sha256).digest()


def sign_grant(key: bytes, *, xid: str, src: str, dest: str,
               part: int) -> str:
    """The grant for exactly one (exchange, source, destination host,
    destination part) flight."""
    import hashlib
    import hmac

    msg = f"{xid}|{src}|{dest}|{int(part)}".encode("utf-8")
    return hmac.new(key, msg, hashlib.sha256).hexdigest()


def verify_grant(key: bytes, grant: str, *, xid: str, src: str,
                 dest: str, part: int) -> bool:
    """Constant-time check of a presented grant."""
    import hmac

    want = sign_grant(key, xid=xid, src=src, dest=dest, part=part)
    return hmac.compare_digest(want, str(grant))


def flight_fingerprint(blob: bytes) -> str:
    """The content fingerprint of one serialized flight, which the
    supervisor's manifest carries and a destination checks before it
    decodes a byte."""
    import hashlib

    return hashlib.sha256(blob).hexdigest()


def send_peer_flight(addr, header: dict, blob: bytes, *,
                     retries: Optional[int] = None,
                     delay_s: Optional[float] = None,
                     op: str = "exchange.peer_flight", **ctx) -> int:
    """Dial a destination's :class:`PeerFlightServer` and ship one
    flight: a pickled header frame (xid, src, part, grant,
    fingerprint), then the blob, both under :func:`send_framed` (the
    blob on the ``exchange.wire`` corruption seam). The dial retries
    briefly (``exchange.peer_dial_retries`` x ``peer_dial_delay_s``):
    a dead peer must fail fast into the routed fallback."""
    import pickle

    host, port = addr
    n = int(retries if retries is not None
            else get_option("exchange.peer_dial_retries"))
    d = float(delay_s if delay_s is not None
              else get_option("exchange.peer_dial_delay_s"))
    sock = dial(int(port), host or None, retries=n, delay_s=d)
    try:
        send_framed(sock, pickle.dumps(header, protocol=4), 0,
                    op="dcn.peer_hello", corrupt_seam="integrity.wire")
        return send_framed(sock, blob, 1, op=op,
                           corrupt_seam="exchange.wire", **ctx)
    finally:
        try:
            sock.close()
        except OSError:
            pass


class PeerFlightServer:
    """A worker's flight gateway: other hosts dial it directly with
    exchange flights. Each connection is served on its own thread: the
    header first (the grant checked against the per-boot key before any
    flight byte is read; a bad one counts ``cluster.rejected_dials``),
    then the sealed flight, which lands in a mailbox keyed
    ``(xid, part)`` by source. The mailbox holds at most
    ``max_entries`` flights; overflow evicts the oldest, counted."""

    def __init__(self, key: bytes, *, dest: str,
                 host: Optional[str] = None, max_entries: int = 256):
        import threading

        self._key = key
        self._dest = str(dest)
        self._srv = SliceServer(host=host)
        self.host, self.port = self._srv.host, self._srv.port
        self._max_entries = int(max_entries)
        self._lock = threading.Lock()
        self._mail: "dict[tuple, dict]" = {}
        self._order: "list[tuple]" = []  # (xid, part, src) arrival order
        self._arrived = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"peer-flights-{self._dest}")
        self._thread.start()

    def _accept_loop(self) -> None:
        import threading

        while not self._stop.is_set():
            try:
                conn, _addr = self._srv.accept(timeout=0.2)
            except TimeoutError:
                continue
            except OSError:
                if self._stop.is_set():
                    return
                continue
            threading.Thread(target=self._serve_peer, args=(conn,),
                             daemon=True,
                             name=f"peer-flight-{self._dest}").start()

    def _serve_peer(self, conn) -> None:
        import pickle

        from spark_rapids_jni_tpu_torch.telemetry.events import record_fleet
        from spark_rapids_jni_tpu_torch.telemetry.registry import REGISTRY

        try:
            conn.settimeout(float(get_option("exchange.direct_timeout_s")))
            try:
                hdr = pickle.loads(recv_framed(conn, 0,
                                               op="dcn.peer_hello"))
                xid = str(hdr.get("xid", ""))
                src = str(hdr.get("src", ""))
                part = int(hdr.get("part", -1))
                if not verify_grant(self._key, str(hdr.get("grant", "")),
                                    xid=xid, src=src, dest=self._dest,
                                    part=part):
                    REGISTRY.counter("cluster.rejected_dials").inc()
                    record_fleet("cluster.peer_gateway", "rejected_dial",
                                 replica=self._dest, peer=src, xid=xid,
                                 part=part)
                    return
                blob = recv_framed(conn, 1, op="exchange.peer_flight")
            except Exception as exc:
                # a half-dial (the peer died mid-flight, or corruption
                # past the ARQ budget): counted; the exchange's own
                # timeout surfaces the missing flight classified
                REGISTRY.counter("exchange.peer_recv_failures").inc()
                record_fleet("cluster.peer_gateway", "peer_recv_failed",
                             replica=self._dest,
                             error_kind=type(exc).__name__)
                return
            REGISTRY.counter("exchange.peer_flights_recv").inc()
            self.deliver(xid, part, src, blob)
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def deliver(self, xid: str, part: int, src: str, blob: bytes) -> None:
        """Land one flight in the mailbox (also the path of a source
        whose destination is its own host)."""
        from spark_rapids_jni_tpu_torch.telemetry.registry import REGISTRY

        key = (str(xid), int(part))
        with self._lock:
            self._mail.setdefault(key, {})[str(src)] = blob
            self._order.append((key[0], key[1], str(src)))
            while len(self._order) > self._max_entries:
                oxid, opart, osrc = self._order.pop(0)
                box = self._mail.get((oxid, opart))
                if box is not None and box.pop(osrc, None) is not None:
                    REGISTRY.counter("exchange.peer_mail_evicted").inc()
                if box is not None and not box:
                    self._mail.pop((oxid, opart), None)
            self._arrived.set()

    def wait_flights(self, xid: str, part: int, srcs,
                     timeout: Optional[float] = None) -> dict:
        """Block until every source in ``srcs`` delivered its flight for
        ``(xid, part)``; returns ``{src: blob}``, which the caller
        checks against the manifest before decoding. ``TimeoutError``
        names the missing sources."""
        import time

        want = {str(s) for s in srcs}
        deadline = None if timeout is None else time.monotonic() + timeout
        key = (str(xid), int(part))
        while True:
            with self._lock:
                box = dict(self._mail.get(key) or {})
                self._arrived.clear()
            if want <= set(box):
                return {s: box[s] for s in want}
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                raise TimeoutError(
                    f"peer flights for exchange {xid!r} part {part} "
                    f"missing from {sorted(want - set(box))} after "
                    f"{timeout}s")
            self._arrived.wait(0.05 if left is None else min(left, 0.05))

    def discard(self, xid: str, part: Optional[int] = None) -> None:
        """Drop the mailbox state of a finished or abandoned exchange."""
        with self._lock:
            keys = {k for k in self._mail
                    if k[0] == str(xid)
                    and (part is None or k[1] == int(part))}
            for k in keys:
                self._mail.pop(k, None)
            self._order = [o for o in self._order
                           if (o[0], o[1]) not in keys]

    def close(self) -> None:
        self._stop.set()
        self._srv.close()
        self._thread.join(timeout=2.0)
