"""The port's expression evaluation against the JAX package's.

Each expression is built once with the JAX package's constructors and
carried into the port with `convert.expr_from`; the same chunk (made from
a numpy seed) goes through the reference's `eval_xp(jnp)` and the port's
`eval_xp(np)` (host path) and `eval_xp(tnp.on("cpu"))` (device path, on
the CPU here). int64 results are compared exactly, float64 ones at
rtol 1e-12; validity exactly.
"""

import datetime

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tidb_tpu import sqltypes as st
from tidb_tpu.chunk import Chunk as JChunk
from tidb_tpu.expression import Constant, Op, col, const, func
from tidb_tpu_torch import convert
from tidb_tpu_torch.ops import tnp

# one intra-op thread: these tests share the CPU with parallel test workers
torch.set_num_threads(1)

INT = st.new_int_field()
DBL = st.new_double_field()
DEC2 = st.new_decimal_field(15, 2)
DEC4 = st.new_decimal_field(15, 4)
DATE = st.FieldType(st.TypeCode.DATE)

N = 257


def _chunk():
    rng = np.random.default_rng(20260)
    datas = [
        rng.integers(-50, 51, N),                          # 0 int a
        rng.integers(-7, 8, N),                            # 1 int b (zeros)
        rng.integers(-10_000_000, 10_000_000, N),          # 2 dec2 price
        rng.integers(-12, 12, N),                          # 3 dec2 disc
        rng.integers(-9, 10, N),                           # 4 dec2 tax
        rng.normal(size=N) * 100,                          # 5 double
        st.parse_datetime("1992-01-01") +
        rng.integers(0, 2500, N) * 86_400_000_000,         # 6 date
        rng.integers(-99_999_999, 99_999_999, N),          # 7 dec4
    ]
    fts = [INT, INT, DEC2, DEC2, DEC2, DBL, DATE, DEC4]
    valids = [rng.random(N) > 0.15 for _ in fts]
    valids[6][:] = True
    return fts, [np.asarray(d) for d in datas], valids


FTS, DATAS, VALIDS = _chunk()
c = {i: col(i, ft) for i, ft in enumerate(FTS)}
_cutoff = st.date_to_micros(datetime.date(1998, 12, 1) -
                            datetime.timedelta(days=90))

EXPRS = {
    # TPC-H Q1's expressions
    "q1_disc_price": c[2] * func(Op.MINUS, const(1), c[3]),
    "q1_charge": c[2] * func(Op.MINUS, const(1), c[3]) *
    func(Op.PLUS, const(1), c[4]),
    "q1_date_filter": func(Op.LE, c[6],
                           Constant(_cutoff, st.new_datetime_field())),
    # decimal arithmetic with negatives and NULLs
    "dec_mul": c[2] * c[3],
    "dec_sub": c[2] - c[7],
    "dec_add_int": c[3] + c[0],
    "dec_div": c[2] / c[3],
    "dec_mod": func(Op.MOD, c[7], c[3]),
    "dec_cast_down": func(Op.CAST_DECIMAL, c[7],
                          extra=st.new_decimal_field(15, 2)),
    "dec_round": func(Op.ROUND, c[7], const(1)),
    "dec_cmp_int": c[2].gt(c[0]),
    "dec_neg": -c[3],
    # integer division and modulo: truncation toward zero, x/0 -> NULL
    "int_div": func(Op.INTDIV, c[0], c[1]),
    "int_mod": func(Op.MOD, c[0], c[1]),
    "int_div_real": func(Op.INTDIV, c[5], c[1]),
    "real_mod": func(Op.MOD, c[5], c[0]),
    # logic, nulls, control
    "and_or": func(Op.OR, func(Op.AND, c[0].gt(0), c[1].lt(0)),
                   c[5].ge(10.0)),
    "not_xor": func(Op.XOR, func(Op.NOT, c[0].eq(3)), c[1].ne(0)),
    "is_null": func(Op.IS_NULL, c[3]),
    "in_list": func(Op.IN, c[0], extra=[1, -3, 7, 40]),
    "if": func(Op.IF, c[0].gt(0), c[2], c[3]),
    "case": func(Op.CASE, c[0].lt(-20), c[5], c[0].lt(20), c[3], c[4]),
    "ifnull": func(Op.IFNULL, c[3], c[4]),
    "cast_int": func(Op.CAST_INT, c[5]),
    "cast_real": func(Op.CAST_REAL, c[7]),
    "abs_sign": func(Op.ABS, c[0]) * func(Op.SIGN, c[5]),
    "bit_shr": func(Op.SHR, c[0], c[1]),
    "bit_and_shl": func(Op.BIT_AND, func(Op.SHL, c[0], const(3)), c[1]),
    "year_month": func(Op.YEAR, c[6]) * 100 + func(Op.MONTH, c[6]),
    "date_add": func(Op.DATE_ADD_DAYS, c[6], c[0]),
    "datediff": func(Op.DATEDIFF, c[6], func(Op.DATE_SUB_DAYS, c[6], c[1])),
}


def _assert_same(got_d, got_v, want_d, want_v):
    got_d, got_v = np.asarray(got_d), np.asarray(got_v)
    want_d, want_v = np.asarray(want_d), np.asarray(want_v)
    np.testing.assert_array_equal(got_v, want_v)
    assert got_d.shape == want_d.shape
    if want_d.dtype.kind == "f":
        assert got_d.dtype == np.float64
        np.testing.assert_allclose(got_d, want_d, rtol=1e-12, equal_nan=True)
    else:
        np.testing.assert_array_equal(got_d.astype(np.int64),
                                      want_d.astype(np.int64))


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_eval_matches_reference(name):
    e = EXPRS[name]
    want = e.eval_xp(jnp, [(jnp.asarray(d), jnp.asarray(v))
                           for d, v in zip(DATAS, VALIDS)], N)
    pe = convert.expr_from(e)
    assert pe.ft == convert._ft(e.ft)
    host = pe.eval_xp(np, list(zip(DATAS, VALIDS)), N)
    _assert_same(*host, *want)
    dev = pe.eval_xp(tnp.on("cpu"), [(torch.from_numpy(d),
                                      torch.from_numpy(v))
                                     for d, v in zip(DATAS, VALIDS)], N)
    assert isinstance(dev[0], torch.Tensor)
    _assert_same(dev[0].numpy(), dev[1].numpy(), *want)


def test_chunk_eval_through_convert():
    """Expression.eval over a chunk carried across with chunk_from_arrays."""
    jch = JChunk.from_arrays(FTS, DATAS, VALIDS)
    pch = convert.chunk_from_arrays(
        [(cc.ft.tp, cc.ft.flen, cc.ft.frac, cc.ft.collation, cc.data,
          cc.valid) for cc in jch.columns])
    e = EXPRS["q1_charge"]
    _assert_same(*convert.expr_from(e).eval(pch), *e.eval(jch))


def test_floor_division_negative_operands():
    """torch's // on int64 floors like numpy's (the decimal rescale and
    the DIV/MOD fix-ups rely on it)."""
    a = np.array([-7, 7, -7, 7, -1, 0], dtype=np.int64)
    b = np.array([2, -2, -2, 2, 3, -3], dtype=np.int64)
    t = torch.from_numpy(a) // torch.from_numpy(b)
    np.testing.assert_array_equal(t.numpy(), a // b)


def test_tnp_float_constants_are_float64():
    xp = tnp.on("cpu")
    assert xp.full(3, 1.5).dtype == torch.float64
    assert xp.asarray(1.5).dtype == torch.float64
    assert xp.where(torch.tensor([True, False]), 1.5,
                    torch.tensor([1, 2])).dtype == torch.float64
    assert xp.asarray(torch.tensor([1, 2]), np.float64).dtype == \
        torch.float64
