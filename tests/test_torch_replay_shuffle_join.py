"""The reference's `tests/test_shuffle_join.py`, replayed against the
port (`replay`: its source with the package pointed at `tidb_tpu_torch`).
The port has no `parallel/` import shims: the shuffle kernel comes from
ops/meshshuffle.py and `build_mesh` from devplane.py, on 8-shard and
1-shard planes on the CPU. One case is dropped, with its reason below."""

from tests.test_torch_server import replay

replay("test_shuffle_join.py", globals(), subs={
    "from tidb_tpu.parallel import build_mesh":
        "from tidb_tpu.devplane import build_mesh",
    "from tidb_tpu.parallel.shuffle_join import":
        "from tidb_tpu.ops.meshshuffle import",
    "return build_mesh(8)": 'return build_mesh(8, device="cpu")',
    "m1 = build_mesh(1)": 'm1 = build_mesh(1, device="cpu")'},
    drop={"test_skewed_single_key_forces_bucket_retry":
          "its oracle enumerates ~13 M pairs into a Python set (~40 s of "
          "host time per package); test_torch_meshjoin.py holds the "
          "bucket retry against the reference at a skew that overflows "
          "the buckets"})
