"""The port's whole-program flow rules (`tidb_tpu_torch/lint/flow`):
the reference's `tests/test_lint_flow.py` replayed against the port
(`replay`: its source with the package pointed at `tidb_tpu_torch`) —
the lock registry and its resolution policy, lock-order cycles (intra-
and interprocedural, acquire/release sequences, reentrancy),
`# guarded-by:` checking with caller-held propagation, paired-resource
balance, the call graph and the DAG export the sanitizer reads. Every
case is replayed: these rules carry over unchanged in logic.
"""

from tests.test_torch_server import replay

replay("test_lint_flow.py", globals())
