"""The port's typed wire codec (`tidb_tpu_torch/store/wire.py`) against
the JAX package's.

The reference's own `tests/test_wire.py` is replayed against the port
(`replay`), its fuzzing included. Byte parity: for a seeded set of
values (integers of every width, bytes, strings, decimals, numpy lanes of
each wire dtype, Chunks with fixed-width and string columns, CopPlans with
filters, aggregates and ranges, cop requests and responses, regions,
group results, typed KV errors, StreamFrames), the
port's `encode` returns the reference's bytes; and each package's
`decode` reads the other's frames into its own classes. A torch tensor
is not in the contract: `encode` raises WireError on one.
"""

from decimal import Decimal

import numpy as np
import pytest
import torch

from tests.test_torch_server import replay
from tidb_tpu import kv as jkv
from tidb_tpu.chunk import Chunk as JChunk
from tidb_tpu.store import wire as jwire
from tidb_tpu_torch import kv as pkv
from tidb_tpu_torch.chunk import Chunk as PChunk
from tidb_tpu_torch.store import wire as pwire

replay("test_wire.py", globals())


def _seeded_values(pkg, rng):
    """The same value set built from one package's classes."""
    from importlib import import_module
    kv = import_module(f"{pkg}.kv")
    sqltypes = import_module(f"{pkg}.sqltypes")
    chunk = import_module(f"{pkg}.chunk")
    expr = import_module(f"{pkg}.expression")
    core = import_module(f"{pkg}.expression.core")
    physical = import_module(f"{pkg}.plan.physical")
    ranger = import_module(f"{pkg}.ranger")
    stream = import_module(f"{pkg}.store.stream")
    rpc = import_module(f"{pkg}.mockstore.rpc")
    model = import_module(f"{pkg}.schema.model")
    cluster = import_module(f"{pkg}.mockstore.cluster")
    hashagg = import_module(f"{pkg}.ops.hashagg")
    ints = [int(x) for x in rng.integers(-(1 << 62), 1 << 62, 8)]
    ift, sft = sqltypes.new_int_field(), sqltypes.new_string_field(32)
    dft = sqltypes.new_double_field()
    n = 37
    data = rng.integers(-1000, 1000, n)
    valid = rng.random(n) > 0.2
    strs = np.array([f"s{int(x)}" for x in rng.integers(0, 50, n)],
                    dtype=object)
    ch = chunk.Chunk([chunk.Column(ift, data, valid),
                      chunk.Column(dft, rng.random(n), np.ones(n, bool)),
                      chunk.Column(sft, strs, valid)])
    cols = [model.ColumnInfo(id=1, name="a", offset=0, ft=ift),
            model.ColumnInfo(id=2, name="b", offset=1, ft=sft)]
    info = model.TableInfo(id=7, name="t", columns=cols)
    filt = core.ScalarFunc(core.Op.GT, [expr.col(0, ift),
                                        core.Constant(5, ift)])
    in_list = core.ScalarFunc(core.Op.IN, [expr.col(0, ift)],
                              extra=[1, 2, 3])
    aggs = [expr.AggDesc(expr.AggFunc.SUM, expr.col(0, ift)),
            expr.AggDesc(expr.AggFunc.COUNT, None)]
    rng_ = kv.KVRange(b"t\x80a", b"t\x80z")
    plan = physical.CopPlan(table=info, cols=cols, ranges=[rng_],
                            filter=filt, group_exprs=[expr.col(1, sft)],
                            aggs=aggs)
    return [
        None, True, False, 0, -1, 1 << 63, -(1 << 70), *ints, 2.5, -0.0,
        b"", bytes(range(256)), "", "päx", Decimal("-12.3400"),
        [1, [2, (3, {"k": b"v"})]], {1: "a", "b": None},
        data, rng.random(5), data.astype(np.int32), np.float32(1.5),
        valid, np.arange(4, dtype=np.uint8),
        np.arange(3, dtype=np.uint64), strs,
        ch, rng_, plan, filt, in_list, ranger.DatumRange([1], [9]),
        kv.Mutation(kv.MutationOp.PUT, b"k", b"v"),
        kv.KVError("boom"), kv.NotLeaderError(3, 4),
        kv.EpochNotMatchError("stale"), kv.KeyLockedError(
            kv.LockInfo(b"p", 5, b"k", 3000)),
        kv.WriteConflictError(b"k", 4, 5), kv.ServerBusyError("busy"),
        rpc.TimeoutError_("slow"), kv.StreamInterruptedError("cut"),
        stream.StreamFrame(chunk=ch, range=rng_, last=True),
        kv.ReqType.DAG, kv.Priority.HIGH,
        kv.CopRequest(kv.ReqType.DAG, [rng_], plan, 42, keep_order=True),
        kv.CopResponse(ch, rng_),
        cluster.Region(2, b"a", b"b", 3, 1, 1, (1,)),
        cluster.Store(1, "127.0.0.1:20160"),
        rpc.RegionCtx(2, 3, 1, 1),
        hashagg.GroupResult(keys=[(data, valid)], partials=[data],
                            counts=data),
    ]


def _both():
    return (_seeded_values("tidb_tpu", np.random.default_rng(11)),
            _seeded_values("tidb_tpu_torch", np.random.default_rng(11)))


def test_port_encodes_the_reference_bytes():
    jvals, pvals = _both()
    assert len(jvals) == len(pvals)
    for jv, pv in zip(jvals, pvals):
        assert pwire.encode(pv) == jwire.encode(jv), repr(jv)


def test_each_package_decodes_the_others_frames():
    jvals, pvals = _both()
    for jv, pv in zip(jvals, pvals):
        jb, pb = jwire.encode(jv), pwire.encode(pv)
        # a port value read back by the reference re-encodes to the same
        # bytes there, and the other way round
        jback, pback = jwire.decode(pb), pwire.decode(jb)
        assert jwire.encode(jback) == jb
        assert pwire.encode(pback) == pb
        if isinstance(pv, PChunk):
            assert isinstance(pback, PChunk) and isinstance(jback, JChunk)
            assert all(type(c).__module__.startswith("tidb_tpu_torch")
                       for c in pback.columns)


def test_registered_errors_rebuild_as_port_classes():
    err = pwire.decode(jwire.encode(jkv.NotLeaderError(7, -1)))
    assert type(err) is pkv.NotLeaderError and err.leader_store == -1


@pytest.mark.parametrize("t", [torch.arange(4), torch.zeros(2, 2)])
def test_a_torch_tensor_is_not_in_the_contract(t):
    with pytest.raises(pwire.WireError, match="torch"):
        pwire.encode(t)
    with pytest.raises(pwire.WireError, match="torch"):
        pwire.encode({"lane": t})
