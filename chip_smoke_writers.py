"""Vectorised numpy writers of the Parquet and ORC files that
``chip_smoke.py``'s reader phase reads (the card's machine has no
pyarrow to write them, and the port, like the JAX package, has no
writer).

They follow the encoders of ``tests/parquet_util.py``, ``tests/orc_util.py``
and ``tests/thrift_util.py``, one page or stream at a time instead of one
value at a time:

- Parquet: flat OPTIONAL columns (one RLE run of definition levels a
  page, no nulls) and OPTIONAL groups of OPTIONAL leaves (a STRUCT:
  definition levels 0 / 1 / 2, one bit-packed run a page, only the
  present values in the page), v1 data pages of ``page_rows`` rows,
  SNAPPY pages
  made of literal elements of at most 64 KiB (a valid snappy stream, the
  tests' encoder), PLAIN or RLE_DICTIONARY (a dictionary page a column
  chunk, then one bit-packed run of indices a page) encodings, and the
  thrift compact footer;
- ORC: flat struct files without compression, RLEv1 literal runs for
  integer and date columns, byte RLE literals for BYTE columns, one
  stripe every ``stripe_rows`` rows.

Each writer streams pages to the file, so a 2 GB file is never held in
memory whole.
"""

from __future__ import annotations

import struct

import numpy as np

# ---- thrift compact protocol (tests/thrift_util.py's writer) ---------------

T_BOOL_T, T_BOOL_F, T_I32, T_I64, T_BINARY, T_LIST, T_STRUCT = \
    1, 2, 5, 6, 8, 9, 12


def _varint(u: int) -> bytes:
    out = bytearray()
    while u >= 0x80:
        out.append((u & 0x7F) | 0x80)
        u >>= 7
    out.append(u)
    return bytes(out)


def _zigzag(s: int) -> bytes:
    return _varint((s << 1) ^ (s >> 63) if s < 0 else s << 1)


def _value(wire: int, value) -> bytes:
    if wire in (T_I32, T_I64):
        return _zigzag(value)
    if wire == T_BINARY:
        raw = value.encode() if isinstance(value, str) else bytes(value)
        return _varint(len(raw)) + raw
    if wire == T_LIST:
        elem_wire, elems = value
        head = bytes([(len(elems) << 4) | elem_wire]) if len(elems) < 15 \
            else bytes([0xF0 | elem_wire]) + _varint(len(elems))
        return head + b"".join(_value(elem_wire, e) for e in elems)
    if wire == T_STRUCT:
        return thrift_struct(value)
    raise ValueError(f"wire type {wire}")


def thrift_struct(fields: dict) -> bytes:
    """``{field_id: (wire_type, value)}`` -> compact-protocol bytes."""
    out = bytearray()
    last = 0
    for fid in sorted(fields):
        wire, value = fields[fid]
        if wire in (T_BOOL_T, T_BOOL_F):
            wire = T_BOOL_T if value else T_BOOL_F
        delta = fid - last
        out += bytes([(delta << 4) | wire]) if 0 < delta <= 15 \
            else bytes([wire]) + _zigzag(fid)
        if wire not in (T_BOOL_T, T_BOOL_F):
            out += _value(wire, value)
        last = fid
    out.append(0)
    return bytes(out)


# ---- Parquet ---------------------------------------------------------------

INT32, INT64 = 1, 2
CONV_DECIMAL, CONV_DATE, CONV_INT_8 = 5, 6, 15
SNAPPY = 1
PLAIN, RLE, RLE_DICT = 0, 3, 8
PAGE_DATA, PAGE_DICT = 0, 2
_SNAPPY_BLOCK = 65536


def snappy_literals(raw: np.ndarray) -> bytes:
    """A snappy stream of literal elements of at most 64 KiB each (the
    tests' encoder, vectorised): the uncompressed length, then per block
    the tag 61 << 2, the block length - 1 in two little-endian bytes and
    the block's bytes."""
    raw = np.ascontiguousarray(raw).view(np.uint8).reshape(-1)
    n = raw.size
    full, tail = divmod(n, _SNAPPY_BLOCK)
    parts = [np.frombuffer(_varint(n), np.uint8)]
    if full:
        blocks = raw[:full * _SNAPPY_BLOCK].reshape(full, _SNAPPY_BLOCK)
        head = np.array([61 << 2, 0xFF, 0xFF], np.uint8)
        parts.append(np.hstack([np.broadcast_to(head, (full, 3)),
                                blocks]).reshape(-1))
    if tail:
        if tail <= 60:
            head = np.array([(tail - 1) << 2], np.uint8)
        else:
            head = np.array([61 << 2, (tail - 1) & 0xFF, (tail - 1) >> 8],
                            np.uint8)
        parts += [head, raw[full * _SNAPPY_BLOCK:]]
    return np.concatenate(parts).tobytes()


def rle_run(count: int, value: int, bit_width: int) -> bytes:
    """One RLE run of the RLE/bit-packed hybrid."""
    return _varint(count << 1) + int(value).to_bytes(
        (bit_width + 7) // 8, "little")


def bitpacked_run(idx: np.ndarray, bit_width: int) -> bytes:
    """One bit-packed run of the hybrid over ``idx`` (padded to 8)."""
    groups = (idx.size + 7) // 8
    padded = np.zeros(groups * 8, np.uint32)
    padded[:idx.size] = idx
    bits = ((padded[:, None] >> np.arange(bit_width, dtype=np.uint32))
            & 1).astype(np.uint8)
    return _varint((groups << 1) | 1) + np.packbits(
        bits.reshape(-1), bitorder="little").tobytes()


def _page(page_type: int, uncompressed: bytes, header_fields: dict) -> bytes:
    comp = snappy_literals(np.frombuffer(uncompressed, np.uint8))
    field_id = 5 if page_type == PAGE_DATA else 7
    header = thrift_struct({
        1: (T_I32, page_type), 2: (T_I32, len(uncompressed)),
        3: (T_I32, len(comp)), field_id: (T_STRUCT, header_fields)})
    return header + comp


class ParquetColumn:
    """One flat column: ``values`` (int32 or int64), its physical and
    converted type (``scale``/``precision`` for DECIMAL), and
    ``dictionary`` (True: RLE_DICTIONARY over the column's distinct
    values, PLAIN otherwise). ``valid`` (bool per row) makes it a leaf of
    a ``ParquetGroup`` with nulls of its own (PLAIN only)."""

    def __init__(self, name: str, values: np.ndarray, physical: int,
                 converted=None, dictionary: bool = False, scale=None,
                 precision=None, valid=None):
        self.name, self.physical, self.converted = name, physical, converted
        self.scale, self.precision = scale, precision
        self.values = np.ascontiguousarray(values, dtype=(
            np.int32 if physical == INT32 else np.int64))
        self.valid = None if valid is None else np.asarray(valid, bool)
        self.dictionary = dictionary
        if dictionary:
            self.uniq, inv = np.unique(self.values, return_inverse=True)
            self.index = inv.astype(np.uint32).reshape(-1)
            self.bit_width = max(1, int(self.uniq.size - 1).bit_length())

    def schema_element(self) -> dict:
        se = {1: (T_I32, self.physical), 3: (T_I32, 1),
              4: (T_BINARY, self.name)}
        if self.converted is not None:
            se[6] = (T_I32, self.converted)
        if self.scale is not None:
            se[7], se[8] = (T_I32, self.scale), (T_I32, self.precision)
        return se


class ParquetGroup:
    """An OPTIONAL group (a STRUCT) of OPTIONAL leaves: ``valid`` marks
    the present structs, each field's ``valid`` its present values."""

    def __init__(self, name: str, fields: list, valid: np.ndarray):
        self.name, self.fields = name, fields
        self.valid = np.asarray(valid, bool)
        self.values = fields[0].values  # the row count

    def leaves(self) -> list:
        """(path, column, definition levels) of each leaf: 0 where the
        struct is null, 1 where the field is, 2 where the value is."""
        return [([self.name, f.name], f,
                 self.valid.astype(np.uint8) + (self.valid & f.valid))
                for f in self.fields]


def _leaves(columns: list) -> list:
    out = []
    for c in columns:
        out += c.leaves() if isinstance(c, ParquetGroup) \
            else [([c.name], c, None)]
    return out


def write_parquet(path, columns: list, row_group_rows: int,
                  page_rows: int) -> int:
    """Write ``columns`` (``ParquetColumn``s and ``ParquetGroup``s of one
    length) to ``path``; returns the file's size."""
    n = columns[0].values.size
    leaves = _leaves(columns)
    row_groups = []
    with open(path, "wb") as fh:
        fh.write(b"PAR1")
        pos = 4
        for rg_start in range(0, n, row_group_rows):
            rg_rows = min(row_group_rows, n - rg_start)
            chunks, rg_bytes = [], 0
            for path_names, c, defs_all in leaves:
                chunk_start = pos
                dict_off = None
                if c.dictionary:
                    dict_off = pos
                    page = _page(PAGE_DICT, c.uniq.tobytes(),
                                 {1: (T_I32, c.uniq.size), 2: (T_I32, PLAIN)})
                    fh.write(page)
                    pos += len(page)
                data_off = pos
                for p in range(rg_start, rg_start + rg_rows, page_rows):
                    k = min(page_rows, rg_start + rg_rows - p)
                    defs = rle_run(k, 1, 1)
                    if defs_all is not None:  # a group's leaf
                        lv = defs_all[p:p + k]
                        defs = bitpacked_run(lv, 2)
                        payload = c.values[p:p + k][lv == 2].tobytes()
                    elif c.dictionary:
                        payload = bytes([c.bit_width]) + bitpacked_run(
                            c.index[p:p + k], c.bit_width)
                    else:
                        payload = c.values[p:p + k].tobytes()
                    page = _page(PAGE_DATA, struct.pack("<I", len(defs))
                                 + defs + payload, {
                        1: (T_I32, k),
                        2: (T_I32, RLE_DICT if c.dictionary else PLAIN),
                        3: (T_I32, RLE), 4: (T_I32, RLE)})
                    fh.write(page)
                    pos += len(page)
                size = pos - chunk_start
                rg_bytes += size
                md = {1: (T_I32, c.physical),
                      2: (T_LIST, (T_I32, [RLE_DICT, RLE] if c.dictionary
                                   else [PLAIN, RLE])),
                      3: (T_LIST, (T_BINARY, path_names)),
                      4: (T_I32, SNAPPY), 5: (T_I64, rg_rows),
                      6: (T_I64, size), 7: (T_I64, size),
                      9: (T_I64, data_off)}
                if dict_off is not None:
                    md[11] = (T_I64, dict_off)
                chunks.append({2: (T_I64, chunk_start), 3: (T_STRUCT, md)})
            row_groups.append({1: (T_LIST, (T_STRUCT, chunks)),
                               2: (T_I64, rg_bytes), 3: (T_I64, rg_rows),
                               6: (T_I64, rg_bytes)})
        schema = [{4: (T_BINARY, "schema"), 5: (T_I32, len(columns))}]
        for c in columns:
            if isinstance(c, ParquetGroup):
                schema.append({3: (T_I32, 1), 4: (T_BINARY, c.name),
                               5: (T_I32, len(c.fields))})
                schema += [f.schema_element() for f in c.fields]
            else:
                schema.append(c.schema_element())
        footer = thrift_struct({
            1: (T_I32, 1), 2: (T_LIST, (T_STRUCT, schema)),
            3: (T_I64, n), 4: (T_LIST, (T_STRUCT, row_groups)),
            6: (T_BINARY, "chip_smoke_writers")})
        fh.write(footer + struct.pack("<I", len(footer)) + b"PAR1")
        return pos + len(footer) + 8


def footer_bytes(path) -> bytes:
    """The raw thrift footer of a Parquet file (no PAR1 framing)."""
    with open(path, "rb") as fh:
        fh.seek(-8, 2)
        (flen,) = struct.unpack("<I", fh.read(4))
        fh.seek(-8 - flen, 2)
        return fh.read(flen)


# ---- ORC -------------------------------------------------------------------

ORC_BYTE, ORC_LONG, ORC_DATE = 1, 4, 15


def _pb_varint(number: int, value: int) -> bytes:
    return _varint(number << 3) + _varint(value)


def _pb_bytes(number: int, payload: bytes) -> bytes:
    return _varint((number << 3) | 2) + _varint(len(payload)) + payload


def varints(u: np.ndarray) -> tuple:
    """Unsigned LEB128 of each uint64 value: (bytes, byte count a value)."""
    u = u.astype(np.uint64)
    nbytes = np.ones(u.size, np.int64)
    for k in range(1, 10):
        nbytes += u >= (np.uint64(1) << np.uint64(7 * k))
    ends = np.cumsum(nbytes)
    out = np.empty(int(ends[-1]) if u.size else 0, np.uint8)
    starts = ends - nbytes
    for k in range(10):
        sel = nbytes > k
        if not sel.any():
            break
        byte = ((u[sel] >> np.uint64(7 * k)) & np.uint64(0x7F)).astype(
            np.uint8)
        byte |= np.where(nbytes[sel] > k + 1, 0x80, 0).astype(np.uint8)
        out[starts[sel] + k] = byte
    return out, nbytes


def _with_run_headers(body: np.ndarray, per_value: np.ndarray) -> bytes:
    """RLEv1 / byte-RLE literal runs of 128 values: a header byte
    ``256 - run length`` ahead of each run's bytes."""
    n = per_value.size
    runs = (n + 127) // 128
    run_len = np.full(runs, 128, np.int64)
    if n % 128:
        run_len[-1] = n % 128
    run_bytes = np.add.reduceat(per_value, np.arange(0, n, 128)) \
        if n else np.zeros(0, np.int64)
    out = np.empty(body.size + runs, np.uint8)
    dst = np.cumsum(run_bytes + 1) - (run_bytes + 1)
    out[dst] = (256 - run_len).astype(np.uint8)
    mask = np.ones(out.size, bool)
    mask[dst] = False
    out[mask] = body
    return out.tobytes()


def rle_v1_signed(values: np.ndarray) -> bytes:
    v = values.astype(np.int64)
    zz = (v.view(np.uint64) << np.uint64(1)) ^ (v >> 63).view(np.uint64)
    body, nbytes = varints(zz)
    return _with_run_headers(body, nbytes)


def byte_rle_literals(values: np.ndarray) -> bytes:
    raw = values.astype(np.int8).view(np.uint8)
    return _with_run_headers(raw, np.ones(raw.size, np.int64))


def write_orc(path, columns: list, stripe_rows: int) -> int:
    """Write ``columns`` (``(name, kind, values)``, kinds BYTE, LONG or
    DATE, no nulls) as an uncompressed ORC file; returns its size."""
    n = columns[0][2].size
    stripes = []
    with open(path, "wb") as fh:
        fh.write(b"ORC")
        pos = 3
        for s in range(0, n, stripe_rows):
            k = min(stripe_rows, n - s)
            directory, data_len = [], 0
            for ci, (_, kind, values) in enumerate(columns):
                part = values[s:s + k]
                stream = byte_rle_literals(part) if kind == ORC_BYTE \
                    else rle_v1_signed(part)
                fh.write(stream)
                directory.append((1, ci + 1, len(stream)))  # DATA
                data_len += len(stream)
            sf = b"".join(_pb_bytes(1, _pb_varint(1, kd) + _pb_varint(2, col)
                                    + _pb_varint(3, ln))
                          for kd, col, ln in directory)
            sf += b"".join(_pb_bytes(2, _pb_varint(1, 0))
                           for _ in range(len(columns) + 1))  # DIRECT
            fh.write(sf)
            stripes.append((pos, data_len, len(sf), k))
            pos += data_len + len(sf)
        footer = b"".join(_pb_bytes(3, _pb_varint(1, off) + _pb_varint(2, 0)
                                    + _pb_varint(3, dl) + _pb_varint(4, fl)
                                    + _pb_varint(5, rows))
                          for off, dl, fl, rows in stripes)
        root = _pb_varint(1, 12) + b"".join(
            _pb_varint(2, ci + 1) for ci in range(len(columns))) + b"".join(
            _pb_bytes(3, name.encode()) for name, _, _ in columns)
        footer += _pb_bytes(4, root)
        footer += b"".join(_pb_bytes(4, _pb_varint(1, kind))
                           for _, kind, _ in columns)
        footer += _pb_varint(6, n)
        ps = _pb_varint(1, len(footer)) + _pb_varint(2, 0) \
            + _pb_varint(3, 256 * 1024) + _pb_bytes(8000, b"ORC")
        fh.write(footer + ps + bytes([len(ps)]))
        return pos + len(footer) + len(ps) + 1
