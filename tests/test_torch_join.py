"""The port's sort-join matcher (tidb_tpu_torch/ops/join.py) against the
JAX package's ops/join.py on the same seeded numpy inputs.

The five cases of tests/test_ops_join.py go through both packages'
JoinKernel (the port's on the CPU) and must give the same (li, ri)
SEQUENCES, not only the same pair sets: both sort the build hashes
stably. `match_pairs` must give the same (li, ri, ok, total) on an
overflowing out_cap, `host_match_pairs` the same pairs, and
JoinKeyEncoder the same code lanes over raw strings, a shared dictionary
and a translated one. Every lane is int64 or bool and compared exactly:
tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidb_tpu.ops import hashagg as jh
from tidb_tpu.ops import join as jj
from tidb_tpu_torch.ops import join as pj

# one intra-op thread: these tests share the CPU with parallel test workers
torch.set_num_threads(1)


def _both(bk, pk, out_cap=None):
    nb, np_ = len(bk[0][0]), len(pk[0][0])
    want = jj.JoinKernel(len(bk))(bk, pk, nb, np_, out_cap=out_cap)
    got = pj.JoinKernel(len(bk), device="cpu")(bk, pk, nb, np_,
                                                out_cap=out_cap)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, np.asarray(w))
    return got


def _truth_pairs(bk, pk):
    table = {}
    for i in range(len(bk[0][0])):
        if all(v[i] for _d, v in bk):
            table.setdefault(tuple(d[i] for d, _v in bk), []).append(i)
    pairs = set()
    for i in range(len(pk[0][0])):
        if any(not v[i] for _d, v in pk):
            continue
        for r in table.get(tuple(d[i] for d, _v in pk), ()):
            pairs.add((i, r))
    return pairs


def _int_keys():
    rng = np.random.default_rng(1)
    nb, npr = 5000, 7000
    return ([(rng.integers(0, 800, nb).astype(np.int64),
              rng.random(nb) > 0.05)],
            [(rng.integers(0, 1000, npr).astype(np.int64),
              rng.random(npr) > 0.05)])


def _multi_keys():
    rng = np.random.default_rng(2)
    nb, npr = 3000, 4000
    bk = [(rng.integers(0, 40, nb).astype(np.int64), np.ones(nb, bool)),
          (rng.normal(size=nb).round(1), rng.random(nb) > 0.1)]
    pk = [(rng.integers(0, 40, npr).astype(np.int64), np.ones(npr, bool)),
          (rng.normal(size=npr).round(1), rng.random(npr) > 0.1)]
    return bk, pk


def _skewed_keys():
    # one key matches everything: 64 * 4096 pairs, past the first capacity
    nb, npr = 64, 4096
    return ([(np.zeros(nb, dtype=np.int64), np.ones(nb, bool))],
            [(np.zeros(npr, dtype=np.int64), np.ones(npr, bool))])


@pytest.mark.parametrize("case", ["int_keys_with_dups_and_nulls",
                                  "multi_key", "overflow_retry"])
def test_join_kernel_matches_reference(case):
    bk, pk = {"int_keys_with_dups_and_nulls": _int_keys,
              "multi_key": _multi_keys,
              "overflow_retry": _skewed_keys}[case]()
    li, ri = _both(bk, pk)
    assert set(zip(li.tolist(), ri.tolist())) == _truth_pairs(bk, pk)
    if case == "overflow_retry":
        assert len(li) == 64 * 4096


def test_join_string_keys_shared_dict():
    rng = np.random.default_rng(3)
    nb, npr = 2000, 3000
    words_b = np.array([f"w{v}" for v in rng.integers(0, 50, nb)],
                       dtype=object)
    words_p = np.array([f"w{v}" for v in rng.integers(0, 70, npr)],
                       dtype=object)
    bv = rng.random(nb) > 0.05
    pv = rng.random(npr) > 0.05
    lanes = []
    for mod in (jj, pj):
        enc = mod.JoinKeyEncoder(1)
        bk = enc.fit_build([(words_b, bv)])
        pk = enc.transform_probe([(words_p, pv)])
        lanes.append((bk, pk))
    (jbk, jpk), (pbk, ppk) = lanes
    for a, b in zip(jbk + jpk, pbk + ppk):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    li, ri = _both(pbk, ppk)
    assert set(zip(li.tolist(), ri.tolist())) == \
        _truth_pairs([(words_b, bv)], [(words_p, pv)])


def test_join_empty_sides():
    e = (np.empty(0, dtype=np.int64), np.empty(0, dtype=bool))
    d = (np.arange(10, dtype=np.int64), np.ones(10, dtype=bool))
    for bk, pk in (([e], [d]), ([d], [e])):
        li, ri = _both(bk, pk)
        assert len(li) == len(ri) == 0


def _padded_hashes(bk, pk, b_n, p_n):
    """Reference hashes with dead sentinels over padded lanes (numpy)."""
    out = []
    for keys, n, size, dead in ((bk, len(bk[0][0]), b_n, jj._DEAD_BUILD),
                                (pk, len(pk[0][0]), p_n, jj._DEAD_PROBE)):
        lanes = []
        valid = np.arange(size) < n
        for d, v in keys:
            pd = np.zeros(size, d.dtype)
            pd[:n] = d
            pv = np.zeros(size, bool)
            pv[:n] = v
            lanes.append((pd, pv))
            valid &= pv
        h = jh._hash_keys(np, [(d, v & valid) for d, v in lanes], size,
                          seed=0x9E3779B97F4A7C15)
        out.append((np.where(valid, h, dead), [d for d, _v in lanes]))
    return out


@pytest.mark.parametrize("out_cap", [1024, 8192])
def test_match_pairs_matches_reference_on_overflow(out_cap):
    """A capacity below the true pair count: both report the same total
    and the same truncated (li, ri, ok) lists."""
    rng = np.random.default_rng(5)
    bk = [(rng.integers(0, 30, 3000).astype(np.int64),
           rng.random(3000) > 0.1)]
    pk = [(rng.integers(0, 40, 2000).astype(np.int64),
           rng.random(2000) > 0.1)]
    (hb, bd), (hp, pd) = _padded_hashes(bk, pk, 4096, 2048)
    want = jj.match_pairs(jnp, jnp.asarray(hb), jnp.asarray(hp),
                          [jnp.asarray(x) for x in bd],
                          [jnp.asarray(x) for x in pd], out_cap)
    got = pj.match_pairs(torch.from_numpy(hb), torch.from_numpy(hp),
                         [torch.from_numpy(x) for x in bd],
                         [torch.from_numpy(x) for x in pd], out_cap)
    assert int(got[3]) == int(want[3]) > out_cap
    for w, g in zip(want[:3], got[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", ["int", "multi", "empty_probe"])
def test_host_match_pairs_matches_reference(case):
    if case == "empty_probe":
        bk, _ = _int_keys()
        pk = [(np.empty(0, np.int64), np.empty(0, bool))]
    else:
        bk, pk = _int_keys() if case == "int" else _multi_keys()
    nb, np_ = len(bk[0][0]), len(pk[0][0])
    want = jj.host_match_pairs(bk, pk, nb, np_)
    got = pj.host_match_pairs(bk, pk, nb, np_)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_key_encoder_shared_and_translated_dicts():
    """Pre-encoded lanes: a probe sharing the build's dictionary object
    passes its codes through; another dictionary re-keys through a
    translation array (absent values get unique negative codes); a raw
    probe side looks values up in the build's map."""
    bvals = ["a", "b", "c", "d"]
    bcodes = np.array([0, 1, 2, 3, 1, -1], np.int64)
    bv = bcodes >= 0
    pvals = ["d", "x", "a"]                 # another dictionary
    pcodes = np.array([0, 1, 2, -1, 2], np.int64)
    pv = pcodes >= 0
    raw = np.array(["b", "zz", "c", "a"], dtype=object)
    rv = np.array([True, True, False, True])
    outs = []
    for mod in (jj, pj):
        enc = mod.JoinKeyEncoder(1)
        bk = enc.fit_build([(np.zeros(6, np.int64), bv)],
                           encoded=[(bcodes, bvals)], ci=[False])
        shared = enc.transform_probe([(np.zeros(6, np.int64), bv)],
                                     encoded=[(bcodes, bvals)])
        translated = enc.transform_probe([(np.zeros(5, np.int64), pv)],
                                         encoded=[(pcodes, pvals)])
        raw_probe = enc.transform_probe([(raw, rv)])
        outs.append([bk[0], shared[0], translated[0], raw_probe[0]])
    for (wd, wv), (gd, gv) in zip(*outs):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(outs[1][2][0], [3, -3, 0, -1, 0])
