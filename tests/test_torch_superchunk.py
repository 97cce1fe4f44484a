"""Superchunk batching and the dispatch-ahead pipeline of the port.

The reference's own `tests/test_superchunk.py` is replayed against the
port (`replay`: its source with the package pointed at `tidb_tpu_torch`
and the storage on the CPU; the kernels it builds itself are made on the
CPU too): the assembly edge cases of `ops/runtime.superchunk_batches`
(0-row chunks, exact powers of two, oversize slicing, source counts
across a boundary, dictionary columns spanning one), the masked tail
against the host, `pipeline_map`'s order and depth, the kernel cache,
and end to end the device path against the host path with EXPLAIN
ANALYZE's superchunk cell and the five superchunk metrics.
"""

from tests.test_torch_server import replay

_CPU = ', device="cpu")'

replay("test_superchunk.py", globals(), drop={
    "test_super_batches_wrapper_yields_chunks":
        "the reference's chunk-only wrapper `super_batches` serves its "
        "legacy callers; the port has none and no such wrapper"},
    subs={"HashAggKernel(None, [col(0, STR)], aggs)":
          "HashAggKernel(None, [col(0, STR)], aggs" + _CPU,
          "HashAggKernel(None, [col(0, INT)], aggs)":
          "HashAggKernel(None, [col(0, INT)], aggs" + _CPU,
          "aggs1)": "aggs1" + _CPU,
          "aggs2)": "aggs2" + _CPU,
          "capacity=8192)": "capacity=8192" + _CPU,
          "kernel_for(f1, [col(0, INT)], aggs)":
          "kernel_for(f1, [col(0, INT)], aggs" + _CPU,
          "kernel_for(f2, [col(0, INT)], aggs)":
          "kernel_for(f2, [col(0, INT)], aggs" + _CPU})
