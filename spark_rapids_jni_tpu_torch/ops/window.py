"""Window functions over sorted partitions (counterpart of
``spark_rapids_jni_tpu/ops/window.py``): the cuDF rolling/window surface
Spark's window expressions lower to.

One sort by (partition keys, order keys); per-row results from the
groupby module's segmented machinery; then one gather through the
sort's inverse permutation, so every result lines up with the input
rows (Spark: window results join back to their rows).

The design follows the reference, with three changes for the card that
leave every value as it is:

- partition and peer boundaries come from binary searches of
  non-decreasing segment ids, not associative-scan maxima (a 60M-row
  ``torch.cummax`` took ~180 ms on the card);
- the inverse permutation is one scatter, not the reference's argsort;
- columns are gathered into sort order when a function first reads
  them, not all at once; a RANGE frame's per-row binary search runs as
  many halvings as the widest partition needs, and its rolling min/max
  sparse table has as many levels as the widest frame present (one host
  read each): at SF10 the reference's 26 stacked levels and their two
  gathers would hold ~37 GB.

Float running and rolling sums take the reference's segmented-sum scan
in ``associative_scan``'s pairing, so they are bit-identical to it.
Null order keys sort by the sort module's rules and otherwise act as
values; null partition keys form their own partition (Spark).
"""

from __future__ import annotations

from fractions import Fraction
from typing import Sequence

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.columnar.column import take
from spark_rapids_jni_tpu_torch.ops._decimal128 import (
    recombine_sum128,
    split_sum128_lanes,
)
from spark_rapids_jni_tpu_torch.ops.groupby import (
    _rows_equal_prev,
    _segmented_extremum,
    _segmented_sum_scan,
    _starts,
    _sum_dtype,
)
from spark_rapids_jni_tpu_torch.ops.lists import (
    _ordered,
    _sentinel,
    _unordered,
    sparse_table_extremum,
)
from spark_rapids_jni_tpu_torch.ops.sort import gather, int64_value, sort_order
from spark_rapids_jni_tpu_torch.types import FLOAT64, INT64
from spark_rapids_jni_tpu_torch.utils.tracing import func_range

_INT64_MIN = -(1 << 63)
_INT64_MAX = (1 << 63) - 1


def _canonical_nan(x: torch.Tensor) -> torch.Tensor:
    """torch's CPU minimum/maximum return a NaN of their own bits; XLA's,
    the canonical quiet NaN."""
    if x.is_floating_point():
        return torch.where(torch.isnan(x), float("nan"), x)
    return x


def _square_residual(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """x - r*r with r*r taken exactly (Dekker's product of Veltkamp
    halves), then rounded once."""
    c = 134217729.0 * r  # 2^27 + 1
    hi = c - (c - r)
    lo = r - hi
    p = r * r
    e = ((hi * hi - p) + 2.0 * hi * lo) + lo * lo
    return (x - p) - e


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float64 square root. torch's CPU ``sqrt``
    can be one ulp off (it was on 2.78896475e+11); of the root and its
    two neighbours this keeps the one whose square is nearest x, which
    is the correctly rounded one (an exact midpoint cannot occur)."""
    r = torch.sqrt(x)
    best, err = r, _square_residual(x, r).abs()
    for d in (torch.inf, -torch.inf):
        cand = torch.nextafter(r, torch.full_like(r, d))
        ce = _square_residual(x, cand).abs()
        take_it = ce < err
        best = torch.where(take_it, cand, best)
        err = torch.where(take_it, ce, err)
    # zeros, infinities, NaN and huge values keep torch's root
    plain = ~torch.isfinite(r) | (r == 0) | (r > 1e150)
    return torch.where(plain, r, best)


class Window:
    """Shared precompute for one PARTITION BY / ORDER BY spec: the sort,
    its inverse, and the partition and peer boundaries. Build once, call
    any number of window functions against it."""

    def __init__(
        self,
        table: Table,
        partition_by: Sequence[int],
        order_by: Sequence[int],
        ascending: Sequence[bool] | None = None,
        nulls_first: Sequence[bool] | None = None,
    ):
        self._table = table
        n = table.num_rows
        self._n = n
        keys = list(partition_by) + list(order_by)
        asc = ([True] * len(partition_by) + list(ascending)
               if ascending is not None else None)
        nf = ([True] * len(partition_by) + list(nulls_first)
              if nulls_first is not None else None)
        self._order_by = list(order_by)
        self._order_asc = (list(ascending) if ascending is not None
                           else [True] * len(self._order_by))
        self._order_nf = (list(nulls_first) if nulls_first is not None
                          else [True] * len(self._order_by))
        self._order = sort_order(table, keys, ascending=asc, nulls_first=nf)
        device = self._order.device
        self._idx = torch.arange(n, dtype=torch.int64, device=device)
        self._inv = torch.empty_like(self._order)
        self._inv[self._order] = self._idx
        self._sorted: dict[int, Column] = {}
        key_sorted = gather(Table([table.column(k) for k in keys]),
                            self._order)
        # same_p[i]: sorted row i continues row i-1's partition;
        # same_peer[i]: ... and has an equal order-key tuple (rank peers)
        self._same_p = _rows_equal_prev(key_sorted,
                                        list(range(len(partition_by))))
        self._same_peer = _rows_equal_prev(key_sorted,
                                           list(range(len(keys))))
        del key_sorted
        self._p_start = _starts(~self._same_p)
        self._p_end = self._segment_end(self._same_p)
        self._peer_end_cache: torch.Tensor | None = None
        self._widest: int | None = None

    def _col(self, col_idx: int) -> Column:
        """Column ``col_idx`` in sort order (gathered once; strings
        padded)."""
        if col_idx not in self._sorted:
            self._sorted[col_idx] = gather(
                Table([self._table.column(col_idx)]), self._order).column(0)
        return self._sorted[col_idx]

    def _segment_end(self, same_prev: torch.Tensor) -> torch.Tensor:
        """Sorted position of the last row of each row's segment, where a
        segment starts wherever ``same_prev`` is False."""
        sid = torch.cumsum((~same_prev).to(torch.int64), 0)
        return torch.searchsorted(sid, sid, right=True) - 1

    @property
    def _peer_end(self) -> torch.Tensor:
        """Sorted position of the last row of each row's peer group: the
        frame end of Spark's default RANGE UNBOUNDED PRECEDING .. CURRENT
        ROW window."""
        if self._peer_end_cache is None:
            self._peer_end_cache = self._segment_end(self._same_peer)
        return self._peer_end_cache

    def _unsort(self, sorted_vals: torch.Tensor) -> torch.Tensor:
        return sorted_vals[self._inv]

    def _int_col(self, sorted_vals: torch.Tensor) -> Column:
        return Column(INT64, self._unsort(sorted_vals.to(torch.int64)), None)

    @func_range("window_row_number")
    def row_number(self) -> Column:
        """1-based position within the partition (ROW_NUMBER)."""
        return self._int_col(self._idx - self._p_start + 1)

    def _first_peer(self) -> torch.Tensor:
        """Sorted position of the first row of each row's peer group."""
        return _starts(~self._same_peer)

    @func_range("window_rank")
    def rank(self) -> Column:
        """RANK: 1 + rows strictly before the first peer (gaps on ties)."""
        return self._int_col(self._first_peer() - self._p_start + 1)

    @func_range("window_dense_rank")
    def dense_rank(self) -> Column:
        """DENSE_RANK: distinct order-key values seen so far (no gaps)."""
        new_val = (~self._same_peer).to(torch.int64)
        return self._int_col(
            _segmented_sum_scan(new_val[:, None], ~self._same_p)[:, 0])

    def _shifted(self, col_idx: int, k: int) -> Column:
        pos = self._idx - k
        src = pos.clamp(0, max(self._n - 1, 0))
        in_bounds = (pos >= 0) & (pos < self._n)
        # same partition iff the partition start did not change
        same_part = self._p_start[src] == self._p_start
        return self._gather_at(self._col(col_idx), pos,
                               in_bounds & same_part)

    @func_range("window_lag")
    def lag(self, col_idx: int, k: int = 1) -> Column:
        """Value k rows earlier in the partition, null past the edge."""
        if k < 0:
            raise ValueError("lag offset must be >= 0 (use lead)")
        return self._shifted(col_idx, k)

    @func_range("window_lead")
    def lead(self, col_idx: int, k: int = 1) -> Column:
        """Value k rows later in the partition, null past the edge."""
        if k < 0:
            raise ValueError("lead offset must be >= 0 (use lag)")
        return self._shifted(col_idx, -k)

    def _seg_sum(self, values: torch.Tensor) -> torch.Tensor:
        """Running sum of one lane within each partition."""
        return _segmented_sum_scan(values[:, None], ~self._same_p)[:, 0]

    def _sum_lane(self, c: Column) -> torch.Tensor:
        """The masked values of ``c`` as an int64 (integral, decimal,
        bool) or float64 lane."""
        valid = c.valid_mask()
        if c.data.is_floating_point():
            return torch.where(valid, c.data.to(torch.float64), 0.0)
        return torch.where(valid, int64_value(c.data), 0)

    def _running(self, col_idx: int, op: str) -> Column:
        c = self._col(col_idx)
        if c.dtype.is_string or c.dtype.is_decimal128:
            raise NotImplementedError(
                f"running {op} needs fixed-width numeric columns")
        valid = c.valid_mask()
        # running count of valid values: all-null-so-far stays null
        has = self._unsort(self._seg_sum(valid.to(torch.int64)) > 0)
        if op == "sum":
            acc_dt = _sum_dtype(c.dtype)
            run = self._seg_sum(self._sum_lane(c))
            return Column(acc_dt, self._unsort(run.to(acc_dt.torch_dtype)),
                          has)
        vv = torch.where(valid, _ordered(c.data),
                         _sentinel(c.data.dtype, op))
        run = _canonical_nan(_segmented_extremum(vv, self._p_start, op))
        return Column(c.dtype, self._unsort(_unordered(run, c.data.dtype)),
                      has)

    def _frame_bounds(self, preceding: int, following: int):
        """Sorted-position [lo, hi] of each row's ROWS frame, clamped to
        its partition."""
        if preceding < 0 or following < 0:
            raise ValueError("rolling bounds must be >= 0")
        lo = torch.minimum(torch.maximum(self._idx - preceding,
                                         self._p_start), self._p_end)
        hi = torch.minimum(torch.maximum(self._idx + following,
                                         self._p_start), self._p_end)
        return lo, hi

    def _bounds(self, preceding, following, frame: str):
        if frame == "rows":
            return self._frame_bounds(preceding, following)
        if frame == "range":
            return self._range_frame_bounds(preceding, following)
        raise ValueError(f"frame must be 'rows' or 'range', got {frame!r}")

    def _bounded_search(self, v: torch.Tensor, target: torch.Tensor,
                        lo0: torch.Tensor, hi0: torch.Tensor,
                        side_left: bool) -> torch.Tensor:
        """Per-row binary search of ``target`` inside [lo0, hi0) over the
        partition-sorted values ``v``: vectorised halvings, as many as the
        widest partition needs (no more change a converged search)."""
        if self._widest is None:
            self._widest = int((self._p_end - self._p_start + 1).max()) \
                if self._n else 0
        steps = int(np.ceil(np.log2(max(self._widest, 2)))) + 1
        lo_b, hi_b = lo0, hi0
        for _ in range(steps):
            active = lo_b < hi_b
            mid = (lo_b + hi_b) >> 1
            mv = v[mid.clamp(0, max(self._n - 1, 0))]
            go_right = (mv < target) if side_left else (mv <= target)
            lo_b = torch.where(active & go_right, mid + 1, lo_b)
            hi_b = torch.where(active & ~go_right, mid, hi_b)
        return lo_b

    def _range_frame_bounds(self, preceding, following):
        """Sorted-position [lo, hi] of each row's RANGE frame: the rows of
        its partition whose ORDER BY value lies in [v - preceding, v +
        following]. Needs exactly one numeric ORDER BY key, ascending and
        nulls first (the defaults). A null order value frames over the
        partition's null run; a NaN over its NaN run (at the end)."""
        if len(self._order_by) != 1:
            raise ValueError("RANGE frames need exactly one ORDER BY key")
        if not self._order_asc[0] or not self._order_nf[0]:
            raise NotImplementedError(
                "RANGE frames need an ascending, nulls-first ORDER BY "
                "key (the defaults)")
        if preceding < 0 or following < 0:
            raise ValueError("RANGE bounds must be >= 0")
        oc = self._col(self._order_by[0])
        if oc.dtype.is_string or oc.dtype.is_decimal128 or \
                oc.dtype.storage_dtype.kind not in ("i", "u", "f"):
            raise TypeError(
                f"RANGE frames need a numeric ORDER BY key, got {oc.dtype}")
        if oc.dtype.is_decimal:
            # bounds are value distances: rescale to unscaled units
            # exactly, or refuse
            factor = 10 ** (-oc.dtype.scale)
            scaled = []
            for name, b in (("preceding", preceding),
                            ("following", following)):
                fb = Fraction(str(b)) * factor
                if fb.denominator != 1:
                    raise ValueError(
                        f"RANGE {name}={b} is not representable at "
                        f"{oc.dtype} scale")
                scaled.append(int(fb))
            preceding, following = scaled
        kind = oc.dtype.storage_dtype.kind
        v = oc.data
        if kind == "u":
            if oc.dtype.storage_dtype.itemsize == 8:
                raise NotImplementedError(
                    "RANGE frames on uint64 ORDER BY keys (bound "
                    "arithmetic would wrap)")
            v = int64_value(v)
        elif kind == "i":
            v = v.to(torch.int64)  # headroom for v +- bound
        last = self._p_end.clamp(0, max(self._n - 1, 0))
        is_null = ~oc.valid_mask()
        nc = self._seg_sum(is_null.to(torch.int64))[last]
        valid_start = self._p_start + nc
        valid_end = self._p_end + 1
        is_nan = None
        if kind == "f":
            # NaN orders greatest, so the NaN run ends the partition; the
            # value searches exclude it
            is_nan = torch.isnan(v) & ~is_null
            valid_end = valid_end - self._seg_sum(
                is_nan.to(torch.int64))[last]
        lo_t = v - preceding
        hi_t = v + following
        if kind in ("i", "u"):
            # saturate: int64 keys near the edge must not wrap
            if preceding > 0:
                lo_t = torch.where(lo_t > v, _INT64_MIN, lo_t)
            if following > 0:
                hi_t = torch.where(hi_t < v, _INT64_MAX, hi_t)
        lo = self._bounded_search(v, lo_t, valid_start, valid_end, True)
        hi = self._bounded_search(v, hi_t, valid_start, valid_end,
                                  False) - 1
        lo = torch.where(is_null, self._p_start, lo)
        hi = torch.where(is_null, self._p_start + nc - 1, hi)
        if is_nan is not None:
            lo = torch.where(is_nan, valid_end, lo)
            hi = torch.where(is_nan, self._p_end, hi)
        return lo, hi

    def _frame_diff(self, running: torch.Tensor, lo: torch.Tensor,
                    hi: torch.Tensor) -> torch.Tensor:
        """Per-frame total of a partition running sum by prefix
        difference (the base at lo - 1 is zero at a partition start)."""
        top = max(self._n - 1, 0)
        base = torch.where(lo > self._p_start,
                           running[(lo - 1).clamp(0, top)], 0)
        return running[hi.clamp(0, top)] - base

    def _frame_valid_count(self, valid: torch.Tensor, lo: torch.Tensor,
                           hi: torch.Tensor) -> torch.Tensor:
        return self._frame_diff(self._seg_sum(valid.to(torch.int64)), lo, hi)

    def _rolling_parts(self, col_idx: int, preceding: int, following: int,
                       frame: str = "rows"):
        """Per-row frame sums and valid counts: prefix differences of the
        partition running sum (exact for integer lanes; float error stays
        partition-local)."""
        lo, hi = self._bounds(preceding, following, frame)
        c = self._col(col_idx)
        if c.dtype.is_string or c.dtype.is_decimal128:
            raise NotImplementedError(
                "rolling aggregates need fixed-width numeric columns")
        run = self._seg_sum(self._sum_lane(c))
        return (c, self._frame_diff(run, lo, hi),
                self._frame_valid_count(c.valid_mask(), lo, hi))

    def _rolling_sum128(self, col_idx: int, preceding: int,
                        following: int, frame: str) -> Column:
        """Exact DECIMAL128 rolling SUM: four 32-bit limb lanes and the
        validity lane, each a partition running sum differenced per
        frame, then carry recombination; a frame whose sum passes 128
        bits is null, never a wrapped value."""
        lo_b, hi_b = self._bounds(preceding, following, frame)
        c = self._col(col_idx)
        valid = c.valid_mask()
        lanes = split_sum128_lanes(torch.where(valid, c.data[:, 0], 0),
                                   torch.where(valid, c.data[:, 1], 0))
        lanes.append(valid.to(torch.int64))
        segs = [self._frame_diff(self._seg_sum(x), lo_b, hi_b)
                for x in lanes]
        lo_out, hi_out, ovf = recombine_sum128(*segs[:4])
        out = torch.stack([lo_out, hi_out], dim=-1)
        return Column(c.dtype, self._unsort(out),
                      self._unsort((segs[4] > 0) & ~ovf))

    @func_range("window_rolling_sum")
    def rolling_sum(self, col_idx: int, preceding: int,
                    following: int = 0, frame: str = "rows") -> Column:
        """SUM over ROWS (or RANGE) BETWEEN preceding PRECEDING AND
        following FOLLOWING. Exact for integer and decimal lanes."""
        if self._table.column(col_idx).dtype.is_decimal128:
            return self._rolling_sum128(col_idx, preceding, following,
                                        frame)
        c, wsum, wcnt = self._rolling_parts(col_idx, preceding,
                                            following, frame)
        acc_dt = _sum_dtype(c.dtype)
        return Column(acc_dt, self._unsort(wsum.to(acc_dt.torch_dtype)),
                      self._unsort(wcnt > 0))

    @func_range("window_rolling_count")
    def rolling_count(self, col_idx: int, preceding: int,
                      following: int = 0, frame: str = "rows") -> Column:
        """COUNT of non-null values in the frame (every dtype)."""
        lo, hi = self._bounds(preceding, following, frame)
        valid = self._table.column(col_idx).valid_mask()[self._order]
        return Column(INT64,
                      self._unsort(self._frame_valid_count(valid, lo, hi)),
                      None)

    @func_range("window_rolling_mean")
    def rolling_mean(self, col_idx: int, preceding: int,
                     following: int = 0, frame: str = "rows") -> Column:
        """AVG over the frame (FLOAT64, decimals rescaled)."""
        c, wsum, wcnt = self._rolling_parts(col_idx, preceding,
                                            following, frame)
        m = wsum.to(torch.float64) / wcnt.clamp(min=1).to(torch.float64)
        if c.dtype.is_decimal:
            m = m * (10.0 ** c.dtype.scale)
        return Column(FLOAT64, self._unsort(m), self._unsort(wcnt > 0))

    @func_range("window_rolling_var")
    def rolling_var(self, col_idx: int, preceding: int,
                    following: int = 0, ddof: int = 1,
                    frame: str = "rows") -> Column:
        """VARIANCE over the frame (var_samp at ddof=1, var_pop at 0):
        values centred on the partition mean before squaring, so the
        prefix difference subtracts sums of small deviations."""
        if ddof not in (0, 1):
            raise ValueError("ddof must be 0 (population) or 1 (sample)")
        lo, hi = self._bounds(preceding, following, frame)
        c = self._col(col_idx)
        if c.dtype.is_string or c.dtype.is_decimal128 or \
                c.dtype.storage_dtype.kind not in ("i", "u", "f"):
            raise TypeError(
                f"rolling var/std need a numeric column, got {c.dtype}")
        valid = c.valid_mask()
        scale_f = (10.0 ** c.dtype.scale) if c.dtype.is_decimal else 1.0
        x = c.data.to(torch.float64) * scale_f
        x0 = torch.where(valid, x, 0.0)
        runs = _segmented_sum_scan(
            torch.stack([x0, valid.to(torch.float64)], dim=1), ~self._same_p)
        tot = runs[self._p_end, 0]
        cntp = runs[self._p_end, 1]
        mean_p = tot / cntp.clamp(min=1.0)
        cx = torch.where(valid, x - mean_p, 0.0)
        runs2 = _segmented_sum_scan(torch.stack([cx, cx * cx], dim=1),
                                    ~self._same_p)
        s1 = self._frame_diff(runs2[:, 0], lo, hi)
        s2 = self._frame_diff(runs2[:, 1], lo, hi)
        cnt = self._frame_diff(runs[:, 1], lo, hi).to(torch.int64)
        m = cnt.to(torch.float64)
        num = (s2 - s1 * s1 / m.clamp(min=1.0)).clamp(min=0.0)
        var = num / (m - ddof).clamp(min=1.0)
        return Column(FLOAT64, self._unsort(var), self._unsort(cnt > ddof))

    @func_range("window_rolling_std")
    def rolling_std(self, col_idx: int, preceding: int,
                    following: int = 0, ddof: int = 1,
                    frame: str = "rows") -> Column:
        """STDDEV over the frame (the square root of rolling_var)."""
        v = self.rolling_var(col_idx, preceding, following, ddof, frame)
        return Column(v.dtype, sqrt_rn(v.data), v.validity)

    @func_range("window_rolling_min")
    def rolling_min(self, col_idx: int, preceding: int,
                    following: int = 0, frame: str = "rows") -> Column:
        """MIN over the frame: a sparse-table range minimum (doubling
        levels, two overlapping blocks a row)."""
        return self._rolling_extremum(col_idx, preceding, following,
                                      "min", frame)

    @func_range("window_rolling_max")
    def rolling_max(self, col_idx: int, preceding: int,
                    following: int = 0, frame: str = "rows") -> Column:
        """MAX over the frame (see rolling_min)."""
        return self._rolling_extremum(col_idx, preceding, following,
                                      "max", frame)

    def _rolling_extremum(self, col_idx: int, preceding: int,
                          following: int, op: str,
                          frame: str = "rows") -> Column:
        lo, hi = self._bounds(preceding, following, frame)
        c = self._col(col_idx)
        if c.dtype.is_string or c.dtype.is_decimal128:
            raise NotImplementedError(
                "rolling min/max needs fixed-width numeric columns")
        n = self._n
        valid = c.valid_mask()
        wcnt = self._frame_valid_count(valid, lo, hi)
        if n == 0:
            return Column(c.dtype, c.data, wcnt > 0)
        vv = torch.where(valid, _ordered(c.data),
                         _sentinel(c.data.dtype, op))
        # levels to cover the widest frame: the row budget for ROWS
        # frames, the widest frame present for RANGE frames
        w = preceding + following + 1 if frame == "rows" \
            else int((hi - lo + 1).max())
        nlev = max(1, min(w, n).bit_length())
        pick = torch.minimum if op == "min" else torch.maximum
        out = _canonical_nan(sparse_table_extremum(vv, lo, hi, nlev, pick))
        return Column(c.dtype, self._unsort(_unordered(out, c.data.dtype)),
                      self._unsort(wcnt > 0))

    @func_range("window_ntile")
    def ntile(self, buckets: int) -> Column:
        """NTILE(k): the partition's rows in k buckets whose sizes differ
        by at most one, the larger buckets first."""
        if buckets <= 0:
            raise ValueError("ntile bucket count must be positive")
        size = self._p_end - self._p_start + 1
        pos = self._idx - self._p_start
        q = size // buckets
        r = size - q * buckets
        big = r * (q + 1)  # rows in the (q+1)-sized buckets
        tile = torch.where(pos < big, pos // (q + 1).clamp(min=1),
                           r + (pos - big) // q.clamp(min=1))
        return self._int_col(tile + 1)

    @func_range("window_percent_rank")
    def percent_rank(self) -> Column:
        """PERCENT_RANK: (rank - 1) / (partition rows - 1); 0.0 for a
        single-row partition."""
        rank = self._first_peer() - self._p_start
        size = self._p_end - self._p_start + 1
        pr = rank.to(torch.float64) / (size - 1).clamp(min=1).to(
            torch.float64)
        return Column(FLOAT64, self._unsort(pr), None)

    @func_range("window_cume_dist")
    def cume_dist(self) -> Column:
        """CUME_DIST: rows up to and including the current row's peers
        over the partition's rows."""
        size = self._p_end - self._p_start + 1
        upto = self._peer_end - self._p_start + 1
        cd = upto.to(torch.float64) / size.to(torch.float64)
        return Column(FLOAT64, self._unsort(cd), None)

    def _gather_at(self, c: Column, pos: torch.Tensor,
                   in_frame: torch.Tensor) -> Column:
        """Values of the sorted column ``c`` at sorted positions ``pos``,
        null outside ``in_frame``, back in input row order (one gather
        through the composed index)."""
        src = pos.clamp(0, max(self._n - 1, 0))[self._inv]
        validity = c.valid_mask()[src] & in_frame[self._inv]
        if c.dtype.is_string:
            from spark_rapids_jni_tpu_torch.ops.strings import pad_strings

            c = pad_strings(c)
            return Column(c.dtype, c.data[src], validity, chars=c.chars[src])
        return Column(c.dtype, take(c.data, src), validity)

    @func_range("window_first_value")
    def first_value(self, col_idx: int) -> Column:
        """FIRST_VALUE under Spark's default frame (RANGE UNBOUNDED
        PRECEDING .. CURRENT ROW): the partition's first row."""
        return self._gather_at(self._col(col_idx), self._p_start,
                               torch.ones_like(self._same_p))

    @func_range("window_last_value")
    def last_value(self, col_idx: int) -> Column:
        """LAST_VALUE under Spark's default frame: the last row of the
        current row's peer group."""
        return self._gather_at(self._col(col_idx), self._peer_end,
                               torch.ones_like(self._same_p))

    @func_range("window_nth_value")
    def nth_value(self, col_idx: int, k: int) -> Column:
        """NTH_VALUE(col, k), 1-based from the frame start; null when the
        default frame (partition start .. peer end) has fewer than k
        rows."""
        if k <= 0:
            raise ValueError("nth_value offset is 1-based and positive")
        pos = self._p_start + (k - 1)
        return self._gather_at(self._col(col_idx), pos,
                               pos <= self._peer_end)

    @func_range("window_running_sum")
    def running_sum(self, col_idx: int) -> Column:
        """SUM over ROWS UNBOUNDED PRECEDING .. CURRENT ROW."""
        return self._running(col_idx, "sum")

    @func_range("window_running_min")
    def running_min(self, col_idx: int) -> Column:
        return self._running(col_idx, "min")

    @func_range("window_running_max")
    def running_max(self, col_idx: int) -> Column:
        return self._running(col_idx, "max")
