"""Fused TPC-H q1: the whole query as ONE CUDA kernel.

Replaces the Pallas kernel ``spark_rapids_jni_tpu/ops/pallas/q1.py``
(``_q1_partials_fn``, body ``_q1_kernel``, driven by ``tpch_q1_pallas``).
Source: ``csrc/q1.cu``, which says what bounds it on an H100 (bytes: 38
read per row) and how its design differs from the TPU kernel (stored
columns read as they are, per-row int64 charge instead of limb lanes,
per-thread register partials instead of per-row atomics).

``q1_partials`` returns int64[8, 6]: for each slot the row count and the
sums of quantity, price, discount, disc_price and charge. Slots 0-5 are
the real groups (returnflag_code * 2 + linestatus_code over the declared
domains), slot 6 holds the rows the shipdate filter drops and slot 7 the
kept rows whose flags miss the domains.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import types as t
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.models.tpch import (
    _Q1_CUTOFF_DAYS,
    _Q1_LS_DOMAIN,
    _Q1_RF_DOMAIN,
    L_DISCOUNT,
    L_EXTENDEDPRICE,
    L_LINESTATUS,
    L_QUANTITY,
    L_RETURNFLAG,
    L_SHIPDATE,
    L_TAX,
)
from spark_rapids_jni_tpu_torch.ops.kernels import (
    _build,
    count_launch,
    register_kernel,
)

NAME = "tpch_q1.fused"
_M = 8             # 3*2 real groups + dropped-row slot 6 + domain-miss 7
_SUMS = 6          # count, qty, price, disc, disc_price, charge
_COLUMNS = (L_QUANTITY, L_EXTENDEDPRICE, L_DISCOUNT, L_TAX,
            L_RETURNFLAG, L_LINESTATUS, L_SHIPDATE)
_DTYPES = (torch.int64, torch.int64, torch.int64, torch.int64,
           torch.int8, torch.int8, torch.int32)

register_kernel(
    NAME,
    oracle="spark_rapids_jni_tpu_torch.ops.kernels.q1.q1_partials_plain",
    source="csrc/q1.cu",
    replaces="spark_rapids_jni_tpu/ops/pallas/q1.py:168 _q1_partials_fn",
    doc="whole-query q1: filter + decimal derives + per-slot sums in one "
        "pass, int64 register partials",
)


def q1_partials(qty, price, disc, tax, rf, ls, ship) -> torch.Tensor:
    """int64[8, 6] slot sums over lineitem's q1 columns. CUDA tensors
    launch the kernel, CPU tensors run :func:`q1_partials_plain`."""
    if qty.is_cuda:
        return _q1_partials_cuda(qty, price, disc, tax, rf, ls, ship)
    return q1_partials_plain(qty, price, disc, tax, rf, ls, ship)


def _slots(rf, ls, ship) -> torch.Tensor:
    """Per-row slot (ops/pallas/q1.py:100-109)."""
    keep = ship <= _Q1_CUTOFF_DAYS
    rfc = torch.full(rf.shape, -1, dtype=torch.int64, device=rf.device)
    for code, value in enumerate(_Q1_RF_DOMAIN):
        rfc = torch.where(rf == value, code, rfc)
    lsc = torch.full(ls.shape, -1, dtype=torch.int64, device=ls.device)
    for code, value in enumerate(_Q1_LS_DOMAIN):
        lsc = torch.where(ls == value, code, lsc)
    miss = (rfc < 0) | (lsc < 0)
    return torch.where(keep & ~miss, rfc * 2 + lsc,
                       torch.where(keep, 7, 6))


def q1_partials_plain(qty, price, disc, tax, rf, ls, ship) -> torch.Tensor:
    """Plain PyTorch version of the kernel: per-row slot and derived
    values, then one masked sum per (slot, sum)."""
    slot = _slots(rf, ls, ship)
    dp = price * (100 - disc)
    charge = dp * (100 + tax)
    values = (torch.ones_like(qty), qty, price, disc, dp, charge)
    return torch.stack([
        torch.stack([torch.where(slot == s, v, 0).sum() for v in values])
        for s in range(_M)
    ])


def _q1_partials_cuda(*cols) -> torch.Tensor:
    n = cols[0].shape[0]
    device = cols[0].device
    for c, dt in zip(cols, _DTYPES):
        if c.dtype != dt or c.shape != (n,) or c.device != device:
            raise TypeError(
                f"{NAME}: expected {dt}[{n}] on {device}, got "
                f"{c.dtype}{tuple(c.shape)} on {c.device}")
    cols = [c.contiguous() for c in cols]
    out = torch.zeros((_M, _SUMS), dtype=torch.int64, device=device)
    if n == 0:
        return out  # no rows: every sum is 0, nothing to launch
    rf_dom = (ctypes.c_int32 * 3)(*_Q1_RF_DOMAIN)
    ls_dom = (ctypes.c_int32 * 2)(*_Q1_LS_DOMAIN)
    fn = _build.function("srjt_q1_partials", [
        *[ctypes.c_void_p] * 7, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p])
    count_launch(NAME)
    status = fn(*[c.data_ptr() for c in cols], n, _Q1_CUTOFF_DAYS,
                ctypes.cast(rf_dom, ctypes.c_void_p),
                ctypes.cast(ls_dom, ctypes.c_void_p), out.data_ptr(),
                _build.sm_count(device), _build.stream_handle(device))
    _build.check(status, NAME)
    return out


def tpch_q1_pallas(lineitem: Table) -> Table:
    """q1 through the fused kernel. Same output schema and ordering as
    ``tpch_q1_planned`` restricted to its 6 real groups (keys + 8
    aggregates, real groups lexicographic; domain-missed and filtered
    rows excluded). The name is the reference's, so callers of either
    package find it.

    Planner contract: NON-NULLABLE measure and key columns (the kernel
    would otherwise count null rows that SQL aggregates skip)."""
    for idx in _COLUMNS:
        if lineitem.column(idx).validity is not None:
            raise NotImplementedError(
                "tpch_q1_pallas requires non-nullable inputs (planner "
                "contract); a nullable column routes the batch to "
                "tpch_q1_planned, whose aggregates skip nulls"
            )
    agg = q1_partials(*[lineitem.column(idx).data for idx in _COLUMNS])
    device = agg.device

    counts = agg[:6, 0]
    present = counts > 0
    sum_qty, sum_price, sum_disc, sum_dp, sum_ch = (
        agg[:6, k] for k in range(1, 6))
    denom = torch.clamp(counts, min=1).to(torch.float64)

    def avg(total, scale):
        return total.to(torch.float64) / denom * (10.0 ** scale)

    keys_rf = np.repeat(np.asarray(_Q1_RF_DOMAIN, np.int8), 2)
    keys_ls = np.tile(np.asarray(_Q1_LS_DOMAIN, np.int8), 3)
    return Table([
        Column(t.INT8, torch.from_numpy(keys_rf).to(device), present),
        Column(t.INT8, torch.from_numpy(keys_ls).to(device), present),
        Column(t.decimal64(-2), sum_qty, present),
        Column(t.decimal64(-2), sum_price, present),
        Column(t.decimal64(-4), sum_dp, present),
        Column(t.decimal64(-6), sum_ch, present),
        Column(t.FLOAT64, avg(sum_qty, -2), present),
        Column(t.FLOAT64, avg(sum_price, -2), present),
        Column(t.FLOAT64, avg(sum_disc, -2), present),
        Column(t.INT64, counts, present),
    ])
