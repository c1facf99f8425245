"""Host-to-device staging of decoded reads (the staging part of the
reference's ``runtime/memory.py``: ``_col_from_host``, ``HostTableChunk``,
``host_table_chunk`` and ``_host_snap_nbytes``; the limiter, spill store
and staging pool wait for ROADMAP.md Queue 1 entry 10), and the byte-
budget chunk plan that the Parquet and ORC chunked readers share.

Where the port differs from the reference: the native engine's copy-out
(``tpudf_read_col_copy``) writes into buffers the caller gives, so the
readers allocate those buffers as page-locked (pinned) CPU tensors when
the target is a CUDA device, let the copy-out land there, and stage each
buffer with one ``non_blocking`` host-to-device copy on the current
stream. A column whose storage differs from the file's physical values
(a narrowing cast, a view, a decimal widening) carries a ``finish``
function that ``stage()`` applies after the copy, on the target device.
So there is no second host copy and no pageable staging, for
``stage="host"`` as for a direct read. PyTorch's caching host allocator
keeps a pinned block from reuse until the copies that read it have run,
so a snapshot may be dropped as soon as it is staged. For a CPU target
nothing is pinned and staging hands the tensors over as they are.

A column snapshot is the reference's tuple ``(dtype, data, validity,
chars, children)``, with CPU tensors in place of numpy arrays; where the
column has a ``finish``, ``data`` holds the physical values it is
applied to.
"""

from __future__ import annotations

from typing import Callable, Iterator, NamedTuple, Optional, Sequence

import torch


def host_empty(numel: int, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """An uninitialised CPU buffer for the native copy-out, pinned when
    it will be staged to a CUDA device."""
    return torch.empty(max(int(numel), 0), dtype=dtype,
                       pin_memory=device.type == "cuda")


def stage_tensor(x: Optional[torch.Tensor],
                 device: torch.device) -> Optional[torch.Tensor]:
    """``x`` on ``device``: one asynchronous copy from pinned memory on
    the current stream for CUDA (raises without a CUDA device), ``x``
    itself for the CPU."""
    if x is None or device.type == "cpu":
        return x
    return x.to(device, non_blocking=True)


def _col_from_host(snap, device: torch.device,
                   finish: Optional[Callable] = None):
    """A column snapshot staged to ``device``, ``finish`` applied to its
    data there."""
    from spark_rapids_jni_tpu_torch.columnar import Column

    dtype, data, validity, chars, children = snap
    data = stage_tensor(data, device)
    if finish is not None:
        data = finish(data)
    return Column(
        dtype, data, stage_tensor(validity, device),
        chars=stage_tensor(chars, device),
        children=None if children is None
        else [_col_from_host(ch, device) for ch in children])


class HostTableChunk(NamedTuple):
    """A host-decoded table chunk awaiting device staging.

    ``cols`` holds column snapshots (CPU tensors, pinned for a CUDA
    target) and ``finish`` each column's function from staged physical
    values to storage (None: the data is its storage). ``nbytes`` is
    the device footprint of the table that ``stage()`` returns, so a
    caller can reserve it before the copy; a finished column also holds
    its physical buffer on the device until its ``finish`` has run.
    ``device`` is where ``stage()`` puts the table."""

    cols: tuple
    nbytes: int
    num_rows: int
    device: torch.device
    finish: tuple

    def stage(self):
        """The host-to-device copy: a Table on ``device``."""
        from spark_rapids_jni_tpu_torch.columnar import Table

        return Table([_col_from_host(snap, self.device, fin)
                      for snap, fin in zip(self.cols, self.finish,
                                           strict=True)])


def host_table_chunk(snaps, num_rows: int, device: torch.device,
                     finish: Optional[Sequence] = None) -> HostTableChunk:
    snaps = tuple(snaps)
    finish = tuple(finish) if finish is not None else (None,) * len(snaps)
    nbytes = sum(_host_snap_nbytes(s, num_rows if f is not None else None)
                 for s, f in zip(snaps, finish, strict=True))
    return HostTableChunk(snaps, nbytes, int(num_rows),
                          torch.device(device), finish)


def _host_snap_nbytes(snap, finished_rows: Optional[int] = None) -> int:
    """A snapshot's device bytes; with ``finished_rows``, its data
    counts as that many values of the column's storage type."""
    dtype, data, validity, chars, children = snap
    n = sum(x.nbytes for x in (validity, chars) if x is not None)
    if finished_rows is not None:
        n += finished_rows * dtype.size_bytes
    elif data is not None:
        n += data.nbytes
    for ch in (children or []):
        n += _host_snap_nbytes(ch)
    return n


def _col_nbytes(c) -> int:
    total = c.data.nbytes
    for x in (c.validity, c.chars):
        if x is not None:
            total += x.nbytes
    return total + sum(_col_nbytes(ch) for ch in (c.children or ()))


def table_nbytes(table) -> int:
    """A table's device bytes: data, validity, chars and children."""
    return sum(_col_nbytes(c) for c in table.columns)


class ByteBudgetChunks:
    """A file as a sequence of Tables bounded by a byte budget, cuDF's
    chunked-reader contract at the file's own unit (a Parquet row group,
    an ORC stripe): each chunk is the longest run of units whose summed
    on-disk size fits ``chunk_read_limit``, and always at least one unit.

    ``infos`` is ``[(num_rows, byte_size)]`` per unit; ``read(units,
    stage)`` decodes a run of unit indices (``stage`` as the readers'
    ``read_table`` takes it)."""

    def __init__(self, infos: Sequence[tuple[int, int]],
                 chunk_read_limit: int, read: Callable):
        self._infos = list(infos)
        self._limit = max(int(chunk_read_limit), 1)
        self._read = read
        self._next = 0

    def has_next(self) -> bool:
        return self._next < len(self._infos)

    def _chunk_end(self, start: int) -> int:
        total = 0
        end = start
        while end < len(self._infos):
            total += self._infos[end][1]
            if end > start and total > self._limit:
                break
            end += 1
        return end

    def read_chunk(self):
        if not self.has_next():
            raise StopIteration
        start = self._next
        end = self._chunk_end(start)
        self._next = end
        return self._read(list(range(start, end)), "device")

    def chunk_plan(self) -> list[list[int]]:
        """Unit index runs, one per remaining chunk; decodes nothing and
        leaves the cursor where it is."""
        plans = []
        start = self._next
        while start < len(self._infos):
            end = self._chunk_end(start)
            plans.append(list(range(start, end)))
            start = end
        return plans

    def chunk_sources(self, stage: str = "host") -> list:
        """Zero-argument decode thunks, one per remaining chunk, each
        decoding its own run of units (safe on pool threads: the native
        decode and copy-out release the GIL). ``stage="host"`` gives
        ``HostTableChunk``s, staged by their ``stage()``."""
        read = self._read
        return [(lambda units=units: read(units, stage))
                for units in self.chunk_plan()]

    def __iter__(self) -> Iterator:
        while self.has_next():
            yield self.read_chunk()
