"""The reference's `tests/test_bench_tools.py::test_ssb_streaming_wide_scan`,
replayed against the port (`replay`: its source with the package pointed
at `tidb_tpu_torch` and every storage on the CPU): BASELINE config 5's
shape, the SSB wide scan streaming through the plane's aggregation in
super-batches, on an 8-shard plane on the CPU (the reference's
`enable_mesh()` covers conftest's 8 virtual devices). The file's other
cases are replayed in test_torch_bench_tools.py."""

from tests.test_torch_server import replay

_ELSEWHERE = "replayed in test_torch_bench_tools.py"

replay("test_bench_tools.py", globals(), subs={
    "ssb.run(sf=0.005, regions=4, stream_rows=8192)":
        'ssb.run(sf=0.005, regions=4, stream_rows=8192, device="cpu", '
        'shards=8)'},
    drop={"test_benchdb_jobs": _ELSEWHERE, "test_benchraw": _ELSEWHERE,
          "test_benchfilesort_spills_and_sorts": _ELSEWHERE})
