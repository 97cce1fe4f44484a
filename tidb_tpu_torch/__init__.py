"""tidb_tpu_torch — the PyTorch/CUDA port of the tidb_tpu data plane.

A second package beside the JAX one, module for module: sqltypes/,
chunk/ and expression/ as in the reference; ops/ holds the device work
as torch programs plus the hand-written CUDA kernel (csrc/segsum.cu,
ops/segsum.py); executor/ holds the scan, hash join and hash agg
operators and the entry points of TPC-H Q1, Q3 and Q5.
It imports torch and numpy, never jax and never tidb_tpu. Its entry
points run on CUDA unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
