"""The port's memory ledger (tidb_tpu_torch/memtrack.py) against the JAX
package's, on the unit cases of tests/test_memtrack.py.

Every case runs once through each package's module (parametrized by
package) and must give the same numbers: rollup and peaks, detach, the
quota firing a spill and then a cancel, a re-armed spill action,
`track_to`, `suspended`. `device_put_bytes` and `chunk_bytes` of the
same chunk must agree between the two. All ledgers are integers:
tolerance 0.
"""

import numpy as np
import pytest

from tidb_tpu import memtrack as jmemtrack
from tidb_tpu import sqltypes as st
from tidb_tpu.chunk import Chunk
from tidb_tpu_torch import memtrack as pmemtrack
from tidb_tpu_torch import metrics as pmetrics

from test_torch_hashagg import port_chunk

MODULES = {"jax": jmemtrack, "port": pmemtrack}


@pytest.fixture(params=sorted(MODULES))
def memtrack(request):
    return MODULES[request.param]


def test_rollup_peaks_and_ledgers(memtrack):
    root = memtrack.MemTracker("root")
    sess = memtrack.statement_root(root, label="s")
    op = sess.node(object())
    op.consume(host=100, device=40)
    assert (op.host, op.device) == (100, 40)
    assert (sess.host, sess.device) == (100, 40)
    assert (root.host, root.device) == (100, 40)
    op.release(host=60)
    assert root.host == 40 and root.host_peak == 100
    assert root.device == 40 and root.device_peak == 40


def test_detach_zeroes_the_parent(memtrack):
    root = memtrack.MemTracker("root")
    sess = memtrack.statement_root(root, label="s")
    sess.node(object()).consume(host=512, device=64)
    sess.detach()
    assert root.total() == 0
    assert root.host_peak == 512 and sess.host_peak == 512


def test_quota_fires_spill_then_cancel(memtrack):
    root = memtrack.statement_root(None, label="q")
    root.quota = 1000
    shed = []

    def spill():
        shed.append(True)
        root.release(host=900)

    root.add_spill_action(spill)
    root.consume(host=950)
    root.consume(host=200)          # crosses: spill sheds 900
    assert shed and root.total() == 250
    root.remove_spill_action(spill)
    with pytest.raises(memtrack.QuotaExceededError,
                       match="Out Of Memory Quota"):
        root.consume(host=2000)
    # the cancel is latched: a straggler re-raises, the spill chain stays
    with pytest.raises(memtrack.QuotaExceededError):
        root.consume(host=1)


def test_spill_action_is_rearmed(memtrack):
    root = memtrack.statement_root(None, label="q")
    root.quota = 100
    fired = []
    root.add_spill_action(lambda: (fired.append(1),
                                   root.release(host=root.host)))
    root.consume(host=150)
    root.consume(host=150)
    assert len(fired) == 2


def test_track_to_moves_absolute(memtrack):
    root = memtrack.statement_root(None, label="t")
    plan = object()
    with memtrack.tracking(root):
        prev = memtrack.track_to(plan, 500)
        prev = memtrack.track_to(plan, 200, prev)
        assert root.total() == 200 and root.host_peak == 500
        memtrack.release(plan, host=prev)
    assert root.total() == 0


def test_suspended_hides_the_tracker(memtrack):
    root = memtrack.statement_root(None, label="t")
    with memtrack.tracking(root):
        with memtrack.suspended():
            memtrack.consume(object(), host=999)
            assert memtrack.current() is None
        assert memtrack.current() is root
    assert root.total() == 0


def test_register_spill_and_run_spill_actions(memtrack):
    root = memtrack.statement_root(None, label="t")
    node = root.node(object())
    node.consume(host=300)
    with memtrack.tracking(root):
        unregister = memtrack.register_spill(
            lambda: node.release(host=200))
    assert root.run_spill_actions(target=150) == 200
    unregister()
    assert root.run_spill_actions(target=0) == 0
    assert memtrack.register_spill(lambda: None)() is None   # no root


def test_total_peak_is_simultaneous():
    """The port's total_peak: the high-water mark of host + device at
    one moment, which the per-ledger peaks' sum overstates."""
    root = pmemtrack.statement_root(None, label="t")
    root.consume(host=100)
    root.release(host=100)
    root.consume(device=80)
    assert root.peak_total() == 180
    assert (root.total_peak, root.device_at_peak) == (100, 0)
    root.consume(host=30)
    assert (root.total_peak, root.device_at_peak) == (110, 80)


def test_quota_counters():
    before = pmetrics.snapshot()
    root = pmemtrack.statement_root(None, quota=10, label="q")
    root.add_spill_action(lambda: root.release(host=root.host))
    root.consume(host=20)
    with pytest.raises(pmemtrack.QuotaExceededError):
        root.consume(host=5, device=20)
    after = pmetrics.snapshot()
    key = pmetrics.MEM_QUOTA_EXCEEDED
    # both crossings shed bytes (20, then the 5 host bytes); the second
    # stays over the quota on its device bytes and cancels
    for action, times in (("spill", 2), ("cancel", 1)):
        k = f'{key}{{action="{action}"}}'
        assert after.get(k, 0) - before.get(k, 0) == times, action


def _chunk():
    rng = np.random.default_rng(3)
    n = 3000
    valid = rng.random(n) > 0.1
    return Chunk.from_arrays(
        [st.new_int_field(), st.new_double_field(), st.new_string_field()],
        [rng.integers(-5, 5, n), rng.normal(size=n),
         np.array(["a", "bcd", "", "xy"], dtype=object)[
             rng.integers(0, 4, n)]],
        [valid, ~valid, np.ones(n, dtype=bool)])


@pytest.mark.parametrize("size", [None, 4096, 1 << 16])
def test_device_put_bytes_of_the_same_chunk(size):
    jc = _chunk()
    pc = port_chunk(jc)
    assert pmemtrack.device_put_bytes(pc, size) == \
        jmemtrack.device_put_bytes(jc, size)
    assert pmemtrack.chunk_bytes(pc) == jmemtrack.chunk_bytes(jc)


@pytest.mark.parametrize("values", [
    ["a", "bcd", "", "xyzw"],                     # plain strings
    ["a", b"bytes", "", "été"],         # str and bytes
    ["a", None, 7, b"xy", np.str_("np")],         # anything else
], ids=["str", "str-bytes", "mixed"])
def test_chunk_bytes_of_object_columns(values):
    rng = np.random.default_rng(len(values))
    data = np.array(values, dtype=object)[rng.integers(0, len(values), 999)]
    jc = Chunk.from_arrays([st.new_string_field()], [data])
    assert pmemtrack.chunk_bytes(port_chunk(jc)) == \
        jmemtrack.chunk_bytes(jc)
