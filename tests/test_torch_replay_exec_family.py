"""The reference's `tests/test_exec_family.py`, replayed against the port
(`replay`: its source with the package pointed at `tidb_tpu_torch` and
every storage on the CPU)."""

from tests.test_torch_server import replay

replay("test_exec_family.py", globals(), drop={
    "TestStreamAgg::test_device_kernel_used":
        "spies on the reference kernel's dispatch(chunk, donate): the "
        "port has no buffer donation (a recorded deviation), and its "
        "dispatch takes the chunk alone"},
    subs={
    "ExecContext(sess.storage, sess._read_ts(), None)":
    "ExecContext(sess.storage.device, storage=sess.storage, "
    "read_ts=sess._read_ts())"})
