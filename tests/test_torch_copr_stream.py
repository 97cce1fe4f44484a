"""The port's streaming coprocessor against the reference's own
`tests/test_copr_stream.py`, replayed (`replay`: the source pointed at
`tidb_tpu_torch`, storages and store planes on the CPU): bounded frames,
keep-order parity, contiguous frame ranges, resume after a mid-stream
kill or split, and `TestRemoteStream`, the frames over the wire under
credit flow control (store/remote.py, store/wire.py). `TestMeshFeed`
is not replayed (the multi-device plane).
"""

from tests.test_torch_server import replay

replay("test_copr_stream.py", globals(), drop={
    "TestMeshFeed": "streamed frames feeding the mesh's superbatches "
                    "(tidb_tpu.parallel): the multi-device plane is not "
                    "ported"})
