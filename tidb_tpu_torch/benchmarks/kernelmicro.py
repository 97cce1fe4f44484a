"""The kernel-only Q1 figure: `kernel_only_q1_rows_per_sec`, the port's
counterpart of the JAX package's `bench.py: _kernel_micro`.

One HashAggKernel with TPC-H Q1's filter, group keys and aggregates over
one Q1-shaped chunk of 2^20 rows (seed 0), called once to fill the
device transfer memo, then timed over 8 calls. Each call includes the
small group table's device->host read; the input stays resident. The
chunk and the expressions are the port's own copies of the JAX
package's `__graft_entry__.py` helpers (`_lineitem_chunk`, `_q1_exprs`).
"""

from __future__ import annotations

import time

import numpy as np

__all__ = ["ROWS", "ITERS", "lineitem_chunk", "q1_exprs", "run", "hold"]

ROWS = 1 << 20
ITERS = 8


def lineitem_chunk(n: int):
    """A TPC-H lineitem-shaped chunk of the Q1 input columns (seed 0)."""
    from tidb_tpu_torch.chunk import Chunk, Column
    from tidb_tpu_torch.sqltypes import new_double_field, new_int_field
    rng = np.random.default_rng(0)
    return Chunk([
        Column(new_int_field(), rng.integers(0, 3, n).astype(np.int64)),
        Column(new_int_field(), rng.integers(0, 2, n).astype(np.int64)),
        Column(new_double_field(), rng.uniform(1, 50, n)),
        Column(new_double_field(), rng.uniform(900, 105000, n)),
        Column(new_double_field(), rng.uniform(0, 0.1, n)),
        Column(new_double_field(), rng.uniform(0, 0.08, n)),
        Column(new_int_field(),
               rng.integers(8000, 10600, n).astype(np.int64)),
    ])


def q1_exprs():
    """Q1's filter, group and aggregate expression trees over
    lineitem_chunk's columns. -> (filter, groups, aggs)."""
    from tidb_tpu_torch.expression import AggDesc, AggFunc
    from tidb_tpu_torch.expression.core import Op, col, const, func
    from tidb_tpu_torch.sqltypes import new_double_field, new_int_field
    rf = col(0, new_int_field(), "l_returnflag")
    ls = col(1, new_int_field(), "l_linestatus")
    qty = col(2, new_double_field(), "l_quantity")
    px = col(3, new_double_field(), "l_extendedprice")
    disc = col(4, new_double_field(), "l_discount")
    tax = col(5, new_double_field(), "l_tax")
    ship = col(6, new_int_field(), "l_shipdate")
    flt = func(Op.LE, ship, const(10471))
    disc_px = func(Op.MUL, px, func(Op.MINUS, const(1.0), disc))
    charge = func(Op.MUL, disc_px, func(Op.PLUS, const(1.0), tax))
    aggs = [AggDesc(AggFunc.SUM, qty), AggDesc(AggFunc.SUM, px),
            AggDesc(AggFunc.SUM, disc_px), AggDesc(AggFunc.SUM, charge),
            AggDesc(AggFunc.AVG, qty), AggDesc(AggFunc.AVG, px),
            AggDesc(AggFunc.AVG, disc), AggDesc(AggFunc.COUNT, None)]
    return flt, [rf, ls], aggs


def run(rows: int = ROWS, iters: int = ITERS, device="cuda") -> dict:
    """-> {"rows_per_sec", "rows", "iters", "secs", "result"}: rows x
    iters over the timed calls' wall seconds; `result` is the last
    call's GroupResult (for a caller that checks it)."""
    from tidb_tpu_torch.ops import runtime
    from tidb_tpu_torch.ops.hashagg import HashAggKernel
    dev = runtime.resolve_device(device)
    chunk = lineitem_chunk(rows)
    flt, groups, aggs = q1_exprs()
    kernel = HashAggKernel(flt, groups, aggs, capacity=64, device=dev)
    kernel(chunk)           # fills the device transfer memo
    t0 = time.perf_counter()
    for _ in range(iters):
        res = kernel(chunk)
    secs = time.perf_counter() - t0
    return {"rows_per_sec": chunk.num_rows * iters / secs,
            "rows": chunk.num_rows, "iters": iters, "secs": secs,
            "result": res}


def hold(result, chunk) -> float:
    """The largest relative error of `result` (the kernel's GroupResult
    over `chunk`) against numpy: per (returnflag, linestatus) group of
    the rows with shipdate <= 10471, the row count and the four SUMs
    (quantity, price, discounted price, charge). Raises AssertionError
    where the groups differ."""
    cols = [np.asarray(c.data) for c in chunk.columns]
    rf, ls, qty, px, disc, tax, ship = cols
    keep = ship <= 10471
    disc_px = px * (1.0 - disc)
    sums = [qty, px, disc_px, disc_px * (1.0 + tax)]
    want = {}
    for key in sorted(set(zip(rf[keep].tolist(), ls[keep].tolist()))):
        m = keep & (rf == key[0]) & (ls == key[1])
        want[key] = (int(m.sum()), [float(np.sum(v[m])) for v in sums])
    got = {tuple(k): i for i, k in enumerate(result.keys)}
    if set(got) != set(want):
        raise AssertionError(f"kernel micro groups {sorted(got)} != "
                             f"{sorted(want)}")
    worst = 0.0
    for key, (count, truth) in want.items():
        i = got[key]
        if int(result.counts[i]) != count:
            raise AssertionError(f"kernel micro group {key}: count "
                                 f"{int(result.counts[i])} != {count}")
        for a, t in enumerate(truth):
            v = float(result.partials[a][0][i])
            worst = max(worst, abs(v - t) / max(abs(t), 1e-300))
    return worst
