"""The port's local benchmark tools and the X-Protocol skeleton.

Replayed against the port (`replay`: the source pointed at
`tidb_tpu_torch`, storages on the CPU): `tests/test_bench_tools.py`
(benchdb's job string over `Session`, benchraw, benchfilesort over
`executor/extsort.SpillSorter`) and `tests/test_json_xserver.py`, whose
`TestXServer` drives `server/xserver.XServer` over a socket.
`test_ssb_streaming_wide_scan` is replayed on its own in
test_torch_replay_ssb.py, on an 8-shard plane. Then
benchdb's `--store` leg runs against a store plane over the wire, and
the CLI of each tool on the CPU.
"""


from tests.test_torch_server import replay
from tidb_tpu_torch.benchmarks import benchdb, benchfilesort, benchraw
from tidb_tpu_torch.store.remote import StorageServer

replay("test_bench_tools.py", globals(), drop={
    "test_ssb_streaming_wide_scan": "replayed in test_torch_replay_ssb.py "
                                    "on an 8-shard plane"})
replay("test_json_xserver.py", globals())


def test_benchdb_store_leg_over_the_wire(capsys):
    srv = StorageServer(device="cpu")
    srv.start()
    try:
        assert benchdb.main([
            "--addr", f"127.0.0.1:{srv.port}", "--device", "cpu",
            "--run", "create|insert:0_200|select:0_200:2|truncate",
            "--batch", "50"]) == 0
    finally:
        srv.close()
    assert "insert" in capsys.readouterr().out


def test_benchraw_and_benchfilesort_cli(capsys):
    assert benchraw.main(["--num", "200", "--batch", "50",
                          "--device", "cpu"]) == 0
    assert benchfilesort.main(["--rows", "5000", "--run-rows", "2000"]) == 0
    out = capsys.readouterr().out
    assert "rows=5000" in out
