"""``runtime/outofcore.py::prefetch_chunks`` releases what its caller
released: a delivered chunk the caller dropped is freed while the next
chunk is awaited (the producer and the consumer loop keep no reference
to it), in the style of ``test_torch_pipeline.py``'s
``test_delivered_chunks_are_not_held``. The reference's
``prefetch_chunks`` keeps that chunk alive until the next one arrives
(ROADMAP.md Queue 3). Every wait carries its own time limit."""

from __future__ import annotations

import gc
import threading
import time
import weakref

from spark_rapids_jni_tpu_torch.runtime.outofcore import prefetch_chunks
from torch_ooc import port_chunks

JOIN_S = 30  # seconds a wait may take


def test_prefetch_delivered_chunks_are_not_held():
    chunks = port_chunks()
    made = {}
    gate = threading.Event()

    def make(i):
        table = type(chunks[i])([type(c)(c.dtype, c.data.clone())
                                 for c in chunks[i].columns])
        made[i] = weakref.ref(table.columns[0].data)
        return table

    def source():
        yield make(0)
        assert gate.wait(JOIN_S)  # chunk 1 waits until the check is made
        yield make(1)

    gc.collect()
    gc.disable()
    try:
        stream = prefetch_chunks(source(), depth=1)
        first = next(stream)
        assert first.num_rows == chunks[0].num_rows
        del first
        got = []
        th = threading.Thread(target=lambda: got.append(next(stream)))
        th.start()
        time.sleep(0.2)  # the consumer now waits for chunk 1
        held = made[0]() is not None
        gate.set()
        th.join(JOIN_S)
        assert not th.is_alive() and got[0].num_rows == chunks[1].num_rows
        assert not held, "chunk 0 was still held while chunk 1 was awaited"
        stream.close()
    finally:
        gate.set()
        gc.enable()
