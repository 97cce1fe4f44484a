"""The reference's `tests/test_statistics.py`, replayed against the port
(`replay`: its source with the package pointed at `tidb_tpu_torch` and
every storage on the CPU)."""

from tests.test_torch_server import replay

replay("test_statistics.py", globals(), drop={
    "TestDeviceSort::test_same_bucket_reuses_one_program":
        "counts the XLA program cache of the reference's jitted sort "
        "(_jit_sort._cache_size); the port's device_sort is one torch.sort "
        "with no compiled program to reuse"},
    subs={"build_column_stats(col)": 'build_column_stats(col, device="cpu")',
          "build_column_stats(Column(new_int_field(), data))":
          'build_column_stats(Column(new_int_field(), data), device="cpu")',
          "device_sort(ints)": 'device_sort(ints, device="cpu")',
          "device_sort(fl)": 'device_sort(fl, device="cpu")',
          "device_sort(maxed)": 'device_sort(maxed, device="cpu")'})
