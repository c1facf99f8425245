"""Arrow interop (counterpart of ``spark_rapids_jni_tpu/columnar/arrow.py``):
the cuDF ``to_arrow``/``from_arrow`` surface. pyarrow tables are host
data, so these run at the host boundary: one host-device copy per
buffer, built from the Arrow buffers with numpy (no Python list of rows,
except for decimal256 values).

The type mapping is the reference's (Spark/cuDF): Arrow decimal128 with
precision <= 18 lands in DECIMAL64 storage, wider in DECIMAL128 limb
pairs; date32 -> TIMESTAMP_DAYS; timestamp (any unit, cast to us) ->
TIMESTAMP_MICROSECONDS; string and binary keep their bytes (a null row's
are dropped). ``pyarrow`` is imported inside the functions only: the
card's machine has none, so this module is verified on the CPU.
"""

from __future__ import annotations

import numpy as np

from spark_rapids_jni_tpu_torch import types as t
from spark_rapids_jni_tpu_torch.columnar.column import Column
from spark_rapids_jni_tpu_torch.columnar.table import Table
from spark_rapids_jni_tpu_torch.utils.platform import resolve_device


def _string_buffers(arr, mask, wide: bool):
    """(int32 offsets, uint8 chars) of an Arrow string/binary array (int64
    offsets when ``wide``), each null row empty."""
    n = len(arr)
    bufs = arr.buffers()
    offsets = np.frombuffer(bufs[1], np.int64 if wide else np.int32)[
        arr.offset:arr.offset + n + 1].astype(np.int64)
    data = np.frombuffer(bufs[2], np.uint8) if bufs[2] is not None \
        else np.zeros(0, np.uint8)
    lengths = np.diff(offsets)
    if mask is not None:
        lengths[~mask] = 0
    out = np.zeros(n + 1, np.int64)
    np.cumsum(lengths, out=out[1:])
    if out[-1] > np.iinfo(np.int32).max:
        raise ValueError("string column over 2 GiB: int32 offsets overflow")
    idx = np.repeat(offsets[:-1] - out[:-1], lengths) + np.arange(out[-1])
    return out.astype(np.int32), data[idx]


def _decimal_limbs(arr, mask):
    """int64[n, 2] (lo, hi) limbs of an Arrow decimal128 array (its
    16-byte little-endian two's-complement slots), nulls 0."""
    n = len(arr)
    limbs = np.frombuffer(arr.buffers()[1], np.int64).reshape(-1, 2)[
        arr.offset:arr.offset + n].copy()
    if mask is not None:
        limbs[~mask] = 0
    return limbs


def from_arrow(table, device=None) -> Table:
    """pyarrow.Table -> Table on ``device`` (None: the CUDA device).
    Columns are taken by position, so duplicate names round-trip."""
    import pyarrow as pa
    import pyarrow.compute as pc

    device = resolve_device(device)
    cols = []
    for col_idx in range(table.num_columns):
        arr = table.column(col_idx).combine_chunks()
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.chunk(0) if arr.num_chunks else pa.array(
                [], type=arr.type)
        ty = arr.type
        mask = None if arr.null_count == 0 else np.asarray(arr.is_valid())
        if pa.types.is_string(ty) or pa.types.is_large_string(ty) or \
                pa.types.is_binary(ty):
            offsets, chars = _string_buffers(
                arr, mask, pa.types.is_large_string(ty))
            cols.append(Column.from_numpy(offsets, t.STRING, mask, device,
                                          chars=chars))
            continue
        if pa.types.is_decimal(ty):
            dt = (t.decimal128(-ty.scale) if ty.precision > 18
                  else t.decimal64(-ty.scale))
            if ty.byte_width == 16:
                limbs = _decimal_limbs(arr, mask)
                cols.append(Column.from_numpy(
                    limbs if dt.is_decimal128 else limbs[:, 0], dt, mask,
                    device))
                continue
            import decimal as _d  # decimal256: through Python integers

            with _d.localcontext(_d.Context(prec=80)):
                vals = [None if v is None else int(v.scaleb(ty.scale))
                        for v in arr.to_pylist()]
            cols.append(Column.from_pylist(vals, dt, device))
            continue

        # nulls are filled IN ARROW before the numpy conversion: numpy of
        # a null-bearing integer array goes through float64 and loses
        # values past 2^53; the validity mask was taken above (a boolean
        # array takes False: the integer 0 does not convert to it)
        def exact(a, pa_type):
            a = a.cast(pa_type)
            if a.null_count:
                a = pc.fill_null(a, pa.scalar(0).cast(pa_type))
            return np.ascontiguousarray(np.asarray(a))

        if pa.types.is_date32(ty):
            cols.append(Column.from_numpy(exact(arr, pa.int32()),
                                          t.TIMESTAMP_DAYS, mask, device))
        elif pa.types.is_timestamp(ty):
            if ty.unit != "us":
                arr = arr.cast(pa.timestamp("us"))
            cols.append(Column.from_numpy(exact(arr, pa.int64()),
                                          t.TIMESTAMP_MICROSECONDS, mask,
                                          device))
        else:
            cols.append(Column.from_numpy(exact(arr, ty), validity=mask,
                                          device=device))
    return Table(cols)


def to_arrow(table: Table, names: list[str] | None = None):
    """Table -> pyarrow.Table (one device-to-host copy per buffer).
    Columns are placed by position: duplicate names are kept."""
    import pyarrow as pa

    from spark_rapids_jni_tpu_torch.ops.strings import unpad_strings

    arrays, out_names = [], []
    for i, c in enumerate(table.columns):
        out_names.append(names[i] if names else f"c{i}")
        valid = c.valid_mask().cpu().numpy()
        n = len(valid)
        nulls = int(n - valid.sum())
        bitmap = None if not nulls else pa.py_buffer(
            np.packbits(valid, bitorder="little"))
        mask = None if not nulls else ~valid
        if c.dtype.is_string:
            a = unpad_strings(c)
            offsets = a.data.cpu().numpy()
            chars = a.chars.cpu().numpy()[:int(offsets[-1])]
            arrays.append(pa.StringArray.from_buffers(
                n, pa.py_buffer(offsets), pa.py_buffer(chars), bitmap,
                nulls))
            continue
        data = c.data.cpu().numpy()
        if c.dtype.is_decimal:
            if c.dtype.is_decimal128:
                limbs, precision = np.ascontiguousarray(data), 38
            else:
                lo = data.astype(np.int64)
                limbs, precision = np.stack([lo, lo >> 63], axis=1), 18
            arrays.append(pa.Array.from_buffers(
                pa.decimal128(precision, -c.dtype.scale), n,
                [bitmap, pa.py_buffer(limbs)], nulls))
        elif c.dtype.type_id == t.TypeId.TIMESTAMP_DAYS:
            arrays.append(pa.array(data, type=pa.date32(), mask=mask))
        elif c.dtype.type_id == t.TypeId.TIMESTAMP_MICROSECONDS:
            arrays.append(pa.array(data.view("datetime64[us]"), mask=mask))
        else:
            arrays.append(pa.array(data, mask=mask))
    return pa.table(arrays, names=out_names)
