"""The port's streaming coprocessor against the reference's own
`tests/test_copr_stream.py`, replayed (`replay`: the source pointed at
`tidb_tpu_torch`, storages and store planes on the CPU): bounded frames,
keep-order parity, contiguous frame ranges, resume after a mid-stream
kill or split, and `TestRemoteStream`, the frames over the wire under
credit flow control (store/remote.py, store/wire.py), and
`TestMeshFeed`, streamed frames feeding the plane's super-batches (its
`tidb_tpu.parallel` mapped onto the port's devplane, an 8-shard plane on
the CPU).
"""

from tests.test_torch_server import replay

replay("test_copr_stream.py", globals(), subs={
    "        from tidb_tpu import parallel\n":
        "        from tidb_tpu import devplane as parallel\n",
    "parallel.enable_mesh(8)": 'parallel.enable_mesh(8, device="cpu")'})
