"""The reference's `tests/test_parser_longtail.py`, replayed against the port
(`replay`: its source with the package pointed at `tidb_tpu_torch` and
every storage on the CPU)."""

from tests.test_torch_server import replay

replay("test_parser_longtail.py", globals(), drop={
    "TestThirdReviewRegressions::test_pallas_dispatcher_1d_shape":
        "drives the Pallas kernel's JAX dispatcher (ops/pallas_agg.py) in "
        "interpret mode; its port is the CUDA kernel csrc/segsum.cu, "
        "whose 1-D shapes tests/test_torch_segsum.py holds"})
