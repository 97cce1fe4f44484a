"""The port's ops/encoded.py (a numpy-only copy) against the JAX
package's on the same inputs.

`translate_filter` must give the same code-space expression (the same
structural fingerprint) or None for the same filters, and the rewritten
filter evaluated by the port on its device lanes (the CPU here) must
select exactly the rows that the original filter selects in value space
on the host. `code_translation`, `decode_codes` and `encoded_lane` must
give equal arrays. Everything compared is int64, bool or a string:
tolerance 0.
"""

import numpy as np
import pytest
import torch

from tidb_tpu import sqltypes as st
from tidb_tpu.chunk import Chunk, Column
from tidb_tpu.expression import Op, col, const, func
from tidb_tpu.ops import encoded as je
from tidb_tpu.ops import runtime as jruntime
from tidb_tpu_torch import convert
from tidb_tpu_torch.ops import encoded as pe
from tidb_tpu_torch.ops import runtime as pruntime
from tidb_tpu_torch.ops import tnp

# one intra-op thread: these tests share the CPU with parallel test workers
torch.set_num_threads(1)

STR = st.new_string_field()
INT = st.new_int_field()


def _chunk():
    rng = np.random.default_rng(9)
    n = 500
    words = np.array(["alpha", "beta", "gamma", "delta", "eps"],
                     dtype=object)[rng.integers(0, 5, n)]
    valid = rng.random(n) > 0.1
    words = np.where(valid, words, "")
    return Chunk([Column(STR, words, valid),
                  Column(INT, rng.integers(0, 100, n).astype(np.int64),
                         np.ones(n, bool))])


def _port(ch):
    return convert.chunk_from_arrays(
        [(c.ft.tp, c.ft.flen, c.ft.frac, c.ft.collation, c.data, c.valid)
         for c in ch.columns])


FILTERS = {
    "eq": lambda: func(Op.EQ, col(0, STR, "s"), const("beta")),
    "ne_reversed": lambda: func(Op.NE, const("gamma"), col(0, STR, "s")),
    "nulleq": lambda: func(Op.NULLEQ, col(0, STR, "s"), const("delta")),
    "missing_constant": lambda: func(Op.EQ, col(0, STR, "s"),
                                     const("zeta")),
    "in": lambda: func(Op.IN, col(0, STR, "s"),
                       extra=["alpha", "eps", "nope"]),
    "is_null": lambda: func(Op.IS_NULL, col(0, STR, "s")),
    "and_or_mixed": lambda: func(
        Op.OR, func(Op.AND, func(Op.EQ, col(0, STR, "s"), const("beta")),
                    col(1, INT, "k").lt(50)),
        func(Op.IS_NOT_NULL, col(0, STR, "s"))),
}


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_translate_filter_matches_reference(name):
    ch = _chunk()
    pch = _port(ch)
    expr = FILTERS[name]()
    want = je.translate_filter(expr, ch)
    got = pe.translate_filter(convert.expr_from(expr), pch)
    assert want is not None and got is not None
    assert pruntime._expr_fp(got) == jruntime._expr_fp(want)
    # the code-space filter over the port's device lanes selects exactly
    # the rows the value-space filter selects on the host
    cols, _dicts = pruntime.device_put_chunk(pch, "cpu", memo=False)
    n = pch.num_rows
    mask = pruntime.filter_mask_xp(tnp.on(torch.device("cpu")), got, cols,
                                   cols[0][0].shape[0])[:n].numpy()
    np.testing.assert_array_equal(mask,
                                  jruntime.eval_filter_host(expr, ch))


def test_translate_filter_unsupported_is_none():
    ch = _chunk()
    pch = _port(ch)
    for expr in (func(Op.LT, col(0, STR, "s"), const("beta")),
                 func(Op.EQ, col(0, STR, "s"), const(3))):
        assert je.translate_filter(expr, ch) is None
        assert pe.translate_filter(convert.expr_from(expr), pch) is None
    assert pe.translate_filter(None, pch) is None


def test_code_translation_matches_reference():
    src = ["x", "b", "a", "q", "B"]
    dst = ["a", "b", "c"]
    for ci in (False, True):
        want = je.code_translation(src, dst, ci)
        got = pe.code_translation(src, dst, ci)
        np.testing.assert_array_equal(got, want)
        assert got[-1] == -1                 # the NULL slot
    np.testing.assert_array_equal(pe.code_translation(src, dst, False),
                                  [-2, 1, 0, -5, -6, -1])


def test_decode_codes_matches_reference():
    values = ["a", "b", "c"]
    codes = np.array([2, -1, 0, 1, -7, 2], np.int64)
    want = je.decode_codes(values, codes)
    got = pe.decode_codes(values, codes)
    assert list(got) == list(want) == ["c", None, "a", "b", None, "c"]


def test_encoded_lane_matches_reference():
    ch = _chunk()
    pch = _port(ch)
    jc, jv = je.encoded_lane(col(0, STR, "s"), ch)
    pc, pv = pe.encoded_lane(convert.expr_from(col(0, STR, "s")), pch)
    np.testing.assert_array_equal(pc, jc)
    assert list(pv) == list(jv)
    # the memo: a second ask returns the same dictionary object
    assert pe.encoded_lane(convert.expr_from(col(0, STR, "s")),
                           pch)[1] is pv
    assert pe.encoded_lane(convert.expr_from(col(1, INT, "k")), pch) is None
