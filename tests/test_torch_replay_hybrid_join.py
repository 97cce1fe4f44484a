"""The reference's `tests/test_hybrid_join.py`, replayed against the port
(`replay`: its source with the package pointed at `tidb_tpu_torch` and
every storage on the CPU)."""

from tests.test_torch_server import replay

replay("test_hybrid_join.py", globals(), drop={
    "TestPartitionedAgg::test_collision_retries_per_partition":
        "its stand-in kernel_for takes no device argument, which the "
        "port's partitioned_agg passes to every kernel it makes",
    "TestQuotaSpill::test_sql_join_completes_with_spill_under_quota":
        "sets the quota 4,096 B under the statement's own ledger peak; "
        "the port's ledger bills no storage-reader buffers (the reader "
        "chunks the reference bills), so that margin is not the spill's "
        "and the statement is cancelled; test_torch_hybrid.py holds the "
        "port's quota spill against the reference's with the margin "
        "taken from the port's device share"},
    subs={
    "JoinKernel(1)": 'JoinKernel(1, device="cpu")',
    "object(),\n                                    parts=4)":
    'object(),\n                                    parts=4, device="cpu")',
    'parts=4, reason="collision")':
    'parts=4, reason="collision", device="cpu")',
    "kernel_for(None, [g], aggs, capacity=64)":
    'kernel_for(None, [g], aggs, capacity=64, device="cpu")',
    "s._last_mem": "s.last_mem",
    # the port's agg_retry takes the error before the stats
    "object(),\n                              ei.value)":
    'ei.value,\n                              object(), device="cpu")'})
