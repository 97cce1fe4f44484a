"""The port's HBM block cache (store/device_cache.py) against the JAX
package's, at module level (no session), on the same chunks.

Both caches see the same sequence of fills and lookups: fill, hit and
LRU eviction under a budget of about two and a half blocks; the
`hbm-cache` ledger node equal to the resident bytes through fill, evict
and shed, and back to its baseline after it; the SERVER spill action
registered; a data-version mismatch dropping the entry for every
reader; a reader older than the fill missing while the entry survives;
a block over the budget never cached; a budget of 0 shedding on the next
consult. The resident lanes themselves, read back as numpy, equal the
reference's (int, float, decimal and dictionary-coded string columns,
NULLs, the padding tail), and so do the dictionaries. Exact.
"""

import contextlib

import numpy as np
import pytest
import torch

from test_torch_hashagg import port_chunk
from tidb_tpu import config as jconfig
from tidb_tpu import memtrack as jmemtrack
from tidb_tpu import metrics as jmetrics
from tidb_tpu import sqltypes as jst
from tidb_tpu.chunk import Chunk as JChunk
from tidb_tpu.chunk import Column as JColumn
from tidb_tpu.store import device_cache as jdc
from tidb_tpu_torch import config as pconfig
from tidb_tpu_torch import memtrack as pmemtrack
from tidb_tpu_torch import metrics as pmetrics
from tidb_tpu_torch.store import device_cache as pdc

# one intra-op thread: these tests share the CPU with parallel test workers
torch.set_num_threads(1)

SIDES = {"jax": (jdc, jconfig, jmetrics, jmemtrack),
         "torch": (pdc, pconfig, pmetrics, pmemtrack)}


@contextlib.contextmanager
def budget(nbytes):
    old = [(cfg, cfg.get_var("tidb_tpu_device_cache_bytes"))
           for cfg in (jconfig, pconfig)]
    for cfg, _v in old:
        cfg.set_var("tidb_tpu_device_cache_bytes", nbytes)
    try:
        yield
    finally:
        for cfg, v in old:
            cfg.set_var("tidb_tpu_device_cache_bytes", v)


def _jchunk(n: int, seed: int) -> JChunk:
    rng = np.random.default_rng(seed)
    strs = np.array(["k%d" % i for i in rng.integers(0, 23, n)],
                    dtype=object)
    cols = [(jst.new_int_field(), rng.integers(-500, 500, n)),
            (jst.new_double_field(), rng.normal(size=n)),
            (jst.new_decimal_field(12, 2), rng.integers(-10 ** 6, 10 ** 6, n)),
            (jst.new_string_field(16), strs)]
    out = []
    for j, (ft, data) in enumerate(cols):
        valid = rng.random(n) > 0.1 * (j % 2 + 1)
        if data.dtype == object:
            data = np.where(valid, data, "")
        out.append(JColumn(ft, data, valid))
    return JChunk(out)


def _new_cache(side):
    mod = SIDES[side][0]
    return mod.DeviceCache() if side == "jax" else mod.DeviceCache("cpu")


def _hbm(metrics):
    snap = metrics.snapshot()
    return [int(snap.get(k, 0)) for k in (metrics.HBM_CACHE_HITS,
                                          metrics.HBM_CACHE_MISSES,
                                          metrics.HBM_CACHE_EVICTIONS)]


def _lanes(block):
    """A block's resident lanes as numpy, per column (data, valid)."""
    out = []
    for d, v in block.cols:
        if isinstance(d, torch.Tensor):
            out.append((d.cpu().numpy(), v.cpu().numpy()))
        else:
            out.append((np.asarray(d), np.asarray(v)))
    return out


def test_resident_lanes_and_dicts_equal():
    jch = _jchunk(3000, 1)
    jc, pc = _new_cache("jax"), _new_cache("torch")
    jb = jc.fill("k", 1, 10, jch)
    pb = pc.fill("k", 1, 10, port_chunk(jch))
    assert (pb.nrows, pb.size, pb.nbytes) == (jb.nrows, jb.size, jb.nbytes)
    for (pd_, pv), (jd, jv) in zip(_lanes(pb), _lanes(jb)):
        np.testing.assert_array_equal(pv, jv)
        np.testing.assert_array_equal(pd_, jd)
    assert pb.dicts == jb.dicts
    jc.shed()
    pc.shed()


def _sequence(side):
    """Fills past a small budget, lookups, then shed: what the cache,
    its metrics and its ledger node say after each step."""
    mod, _cfg, metrics, memtrack = SIDES[side]
    chunks = [_jchunk(2000 + 100 * i, i) for i in range(5)]
    if side == "torch":
        chunks = [port_chunk(c) for c in chunks]
    node = mod.tracker()
    base = node.snapshot()["device"]
    cache = _new_cache(side)
    out = []
    h0 = _hbm(metrics)
    for i, ch in enumerate(chunks):
        blk = cache.fill(("k", i), 1, 10, ch)
        out.append(("fill", i, blk is not None, len(cache),
                    cache.resident_bytes(),
                    node.snapshot()["device"] - base))
    for i in range(5):
        blk = cache.get(("k", i), 1, 11)
        out.append(("get", i, blk is not None, cache.resident_bytes()))
    out.append(("metrics", [b - a for a, b in zip(h0, _hbm(metrics))]))
    out.append(("registered", mod._shed_all in memtrack.SERVER._actions))
    out.append(("shed", cache.shed(), cache.resident_bytes(),
                node.snapshot()["device"] - base, len(cache)))
    return out


def test_fill_hit_evict_and_ledger_under_a_small_budget():
    per = 4096 * 4 * 9                # one 4,096-row bucket of 4 lanes
    with budget(int(per * 2.5)):
        want = _sequence("jax")
        got = _sequence("torch")
    assert got == want
    fills = [o for o in got if o[0] == "fill"]
    assert all(o[4] == o[5] for o in fills)        # ledger == resident
    assert max(o[4] for o in fills) <= per * 2.5
    assert got[-3][1][2] >= 3                      # evictions counted
    assert got[-1][2:] == (0, 0, 0)                # back to the baseline


def _mvcc(side):
    ch = _jchunk(100, 7)
    if side == "torch":
        ch = port_chunk(ch)
    out = []
    cache = _new_cache(side)
    blk = cache.fill("k", 1, 10, ch)
    out.append(cache.get("k", 1, 10) is blk)
    out.append(cache.get("k", 1, 9) is None)       # too old for the reader
    out.append(len(cache))                          # ... entry survives
    out.append(cache.get("k", 2, 10) is None)       # stale for everyone
    out.append((len(cache), cache.resident_bytes()))
    with budget(64):
        out.append(cache.fill("k", 1, 10, ch) is None)
        out.append((len(cache), cache.resident_bytes()))
    cache.fill("k2", 1, 10, ch)
    with budget(0):
        out.append(cache.enabled())                 # 0 sheds on consult
    out.append((len(cache), cache.resident_bytes()))
    return out


def test_version_mismatch_old_reader_and_budget():
    want = _mvcc("jax")
    got = _mvcc("torch")
    assert got == want
    assert got == [True, True, 1, True, (0, 0), True, (0, 0), False,
                   (0, 0)]


def test_key_is_the_chunk_cache_key_plus_types():
    from tidb_tpu_torch.benchmarks import tpch
    from tidb_tpu_torch.mockstore.cluster import Region
    plan = tpch.q1_cop_plan(tpch.table_infos()["lineitem"])
    region = Region(3, b"a", b"z", 2, 1, 1, (1,))
    key = pdc.DeviceCache.key(region, plan, b"a", b"z")
    assert key[0] == (3, 2, 13, None, tuple(range(1, 13)), None, b"a", b"z")
    assert key[1] == tuple(c.ft.tp for c in plan.cols)


def test_entry_point_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        pdc.DeviceCache()
