"""The string columns of ``bench.py``'s ``regexp`` and ``json_extract``
configurations, and a mixed-script column for case mapping, built at any
row count from a seed.

- ``log_lines``: RLIKE's log lines, 2-5 of bench.py's nine words joined
  by spaces, the word ``id=`` carrying the row number. Built on the
  device as an Arrow column (one masked byte write per word byte), with
  the words drawn for each row, so a caller can check a pattern against
  them; never a Python list of rows.
- ``json_docs``: get_json_object's documents, bench.py's 4,096 templates
  from ``numpy.random.default_rng(0)`` tiled to n rows (row i holds
  template i mod 4,096), padded: one row gather of the template matrix.
  At 59,986,052 rows the text is 3.2 GB, past the int32 offsets of an
  Arrow column.
- ``mixed_script_rows``: 0-4 words of Latin-1, Greek, Cyrillic,
  full-width and ASCII text, a share of them holding a character whose
  case mapping is special (ß, final sigma, dotless and dotted i, an
  astral character), as a host list: callers keep it to a few million
  rows.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.columnar import Column
from spark_rapids_jni_tpu_torch.types import STRING
from spark_rapids_jni_tpu_torch.utils.platform import resolve_device

LOG_WORDS = ("GET", "POST", "/api/v2/items", "status=200", "status=404",
             "id=", "1970-01-01", "ERROR", "ok")
ID_WORD = 5      # "id=" + the row number
MAX_WORDS = 5    # a line holds 2-5 words

# words whose case maps 1:1 in place, and words holding a special
# character for upper or lower (ß, final sigma, dotless and dotted i, an
# astral character)
CASE_WORDS = ("Café", "ÜBER", "ñoño", "łódź", "αβγ", "Ωμέγα", "Привет",
              "жёлтый", "ＡＢＣｄｅｆ", "plain", "MiXeD", "123", "Ärger",
              "çà", "Ελλάδα", "МИР")
SPECIAL_WORDS = ("straße", "ΟΔΟΣ", "ısı", "İstanbul", "\U00010400x")


def log_lines(n: int, seed: int = 0, device=None):
    """(Arrow STRING column of n log lines, int8 (MAX_WORDS, n) word index
    of each slot, -1 past the row's word count)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    k = torch.randint(2, MAX_WORDS + 1, (n,), generator=gen, device=dev)
    words = torch.randint(0, len(LOG_WORDS), (MAX_WORDS, n), generator=gen,
                          device=dev)
    slot = torch.arange(MAX_WORDS, device=dev)[:, None]
    words = torch.where(slot < k[None, :], words, -1)
    enc = [w.encode() for w in LOG_WORDS]
    width = max(len(w) for w in enc)
    table = torch.zeros((len(enc), width), dtype=torch.uint8)
    for i, w in enumerate(enc):
        table[i, :len(w)] = torch.tensor(list(w), dtype=torch.uint8)
    table = table.to(dev)
    wlen = torch.tensor([len(w) for w in enc], device=dev)
    rowid = torch.arange(n, device=dev)
    max_digits = len(str(max(n - 1, 0)))
    ndig = torch.ones_like(rowid)
    for p in range(1, max_digits):
        ndig += rowid >= 10 ** p
    safe = words.clamp(min=0)
    slot_len = torch.where(words >= 0, wlen[safe] + (words == ID_WORD) * ndig,
                           0)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(slot_len.sum(0) + (k - 1), 0)
    total = int(offsets[-1])
    if total >= 2 ** 31:
        raise OverflowError(f"{total} bytes: past int32 offsets")
    chars = torch.empty(total + 1, dtype=torch.uint8, device=dev)
    dump = total  # masked lanes write here; the byte is cut off below
    pos = offsets[:-1].clone()
    for s in range(MAX_WORDS):
        active = words[s] >= 0
        if s:
            chars[torch.where(active, pos, dump)] = ord(" ")
            pos += active
        w = safe[s]
        wl = torch.where(active, wlen[w], 0)
        for b in range(width):
            chars[torch.where(b < wl, pos + b, dump)] = table[w, b]
        pos += wl
        is_id = active & (w == ID_WORD)
        for d in range(max_digits):
            digit = rowid // 10 ** (ndig - 1 - d).clamp(min=0) % 10
            chars[torch.where(is_id & (d < ndig), pos + d, dump)] = \
                (digit + ord("0")).to(torch.uint8)
        pos += torch.where(is_id, ndig, 0)
    return (Column(STRING, offsets.to(torch.int32), None,
                   chars=chars[:total]), words.to(torch.int8))


def json_templates(count: int = 4096) -> list:
    """bench.py's template pool: ``count`` documents from seed 0."""
    rng = np.random.default_rng(0)
    docs = []
    for i in range(count):
        price = int(rng.integers(1, 10_000))
        qty = int(rng.integers(1, 100))
        docs.append('{"sku":"s%d","price":%d,"qty":%d,"meta":{"w":%d}}'
                    % (i, price, qty, qty * 2))
    return docs


def json_docs(n: int, device=None) -> Column:
    """Padded STRING column of n documents, row i = template i mod 4,096
    (of ``json_templates(min(n, 4096))``)."""
    from spark_rapids_jni_tpu_torch.ops.strings import static_strings

    dev = resolve_device(device)
    lens, mat = static_strings(json_templates(min(n, 4096)), dev)
    tid = torch.arange(n, device=dev) % max(int(lens.shape[0]), 1)
    return Column(STRING, lens[tid], None, chars=mat[tid])


def mixed_script_rows(n: int, seed: int = 0,
                      special_share: float = 0.25) -> list:
    """n host rows of 0-4 words joined by spaces, each word special with
    probability ``special_share``."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 5, n)
    common = rng.integers(0, len(CASE_WORDS), (n, 4))
    special = rng.integers(0, len(SPECIAL_WORDS), (n, 4))
    is_special = rng.random((n, 4)) < special_share
    return [" ".join(SPECIAL_WORDS[special[i, j]] if is_special[i, j]
                     else CASE_WORDS[common[i, j]]
                     for j in range(counts[i])) for i in range(n)]
