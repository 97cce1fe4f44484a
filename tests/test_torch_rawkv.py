"""The port's raw KV client (`store/rawkv.py`), the status port's
region/MVCC debug API, `benchmarks/benchkv.py` and `benchraw.py`, and
the thread-leak check (`util/testleak.py`).

Replayed against the port (`replay`: the source pointed at
`tidb_tpu_torch`, storages and store planes on the CPU):
`tests/test_debug_api_rawkv.py` and `tests/test_benchkv_leak.py`. Then
the raw legs over the wire: benchkv (txn and raw) and benchraw against a
`RemoteStorage` of a `StorageServer`, and the same seeded raw puts,
scans and deletes through both packages' `RawKVClient` give the same
keys and values.
"""

import numpy as np
import pytest

from tests.test_torch_server import replay
from tidb_tpu.store.rawkv import RawKVClient as JRawKV
from tidb_tpu.store.storage import new_mock_storage as jnew_storage
from tidb_tpu_torch.benchmarks import benchkv, benchraw
from tidb_tpu_torch.store.rawkv import RawKVClient as PRawKV
from tidb_tpu_torch.store.remote import StorageServer, connect
from tidb_tpu_torch.util import testleak

replay("test_debug_api_rawkv.py", globals())
replay("test_benchkv_leak.py", globals(), subs={
    'benchkv.main(["--keys", "200", "--batch", "50"])':
    'benchkv.main(["--keys", "200", "--batch", "50", "--device", "cpu"])'})


@pytest.fixture(scope="module")
def remote():
    srv = StorageServer(device="cpu")
    srv.start()
    st = connect("127.0.0.1", srv.port, device="cpu")
    yield st
    st.close()
    srv.close()


@pytest.mark.parametrize("mode", ["txn", "raw"])
def test_benchkv_over_the_wire(remote, mode):
    before = testleak.snapshot()
    out = benchkv.run(remote, mode=mode, keys=400, batch=50, workers=2)
    assert out["metric"] == f"benchkv_{mode}_ops_per_sec"
    assert out["value"] > 0 and out["workers"] == 2
    assert testleak.check(before) == []


def test_benchraw_over_the_wire(remote):
    out = benchraw.run(remote, num=300, batch=32, value_size=16, workers=2)
    assert out["num"] == 300
    assert all(v > 0 for k, v in out.items() if k.endswith("secs"))


def test_raw_ops_equal_the_reference(remote):
    rng = np.random.default_rng(3)
    keys = sorted({b"rk%05d" % int(k) for k in rng.integers(0, 5000, 300)})
    pairs = [(k, rng.bytes(int(rng.integers(1, 24)))) for k in keys]
    jst = jnew_storage()
    jst.cluster.split(keys[len(keys) // 2])
    remote.cluster.split(keys[len(keys) // 3])
    out = []
    for c in (JRawKV(jst), PRawKV(remote)):
        c.batch_put(pairs[:150])
        for k, v in pairs[150:]:
            c.put(k, v)
        c.delete(keys[7])
        c.delete_range(keys[20], keys[40])
        out.append((c.scan(b"rk", b"rl", limit=1000),
                    c.batch_get(keys[:60]), c.get(keys[7]),
                    c.get(keys[100])))
    jst.close()
    assert out[1] == out[0]
    assert len(out[1][0]) == len(pairs) - 21
