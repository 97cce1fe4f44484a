"""The port's out-of-process storage (`store/remote.py`) and the
journal-window RPC fleet caches pull, against the reference's own tests.

Replayed against the port (`replay`: the source pointed at
`tidb_tpu_torch`, every storage, `StorageServer` and `connect` on the
CPU, a spawned store plane with `--device cpu`):
`tests/test_remote_storage.py` (SQL over the wire, transactions across
two clients, bulk load and splits, reconnects, a store process killed
and restarted from its snapshot, TPC-H through the wire) and
`tests/test_journal_window.py`. The streamed coprocessor over the wire
(`test_copr_stream.py::TestRemoteStream`) is in
`test_torch_copr_stream.py`. The store plane refuses to start without a
card unless it is asked for the CPU.
"""

import os
import subprocess
import sys

import pytest

from tests.test_torch_server import replay

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_storeserve_without_a_card_refuses_to_start():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    proc = subprocess.run(
        [sys.executable, "-m", "tidb_tpu_torch", "storeserve", "--port",
         "0", "--no-status"], capture_output=True, text=True, cwd=ROOT,
        timeout=120)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr and "listening" not in proc.stdout


replay("test_remote_storage.py", globals())
replay("test_journal_window.py", globals())
