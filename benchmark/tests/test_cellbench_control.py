"""The control (the reference one precision down) comes out wrong at the
cell's own size, and the harness sees `correct` false when the program
is broken underneath it: an answer altered where it is produced, and
half of each scanned batch left out."""

import pytest

from benchmark import catalog, control, harness

CELLS = [w["name"] for w in catalog.spec()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_wrong_at_the_cell_size(cell):
    out = control.judge(cell, 2**31 + 17, answers=6)
    assert out["judged"] == 6
    assert out["wrong"] == out["judged"]


def _run(cell):
    return harness.Run(cell, 2**31 + 99, 2, False, device="cpu",
                       scale=0.002).execute()


@pytest.mark.parametrize("cell", CELLS)
def test_altered_answer_is_caught(monkeypatch, cell):
    from tidb_tpu_torch import server
    orig = server.ClientConn._encode_row

    def altered(row):
        row = list(row)
        if row and isinstance(row[-1], int) and not isinstance(row[-1], bool):
            row[-1] += 1
        return orig(row)
    monkeypatch.setattr(server.ClientConn, "_encode_row",
                        staticmethod(altered))
    line = _run(cell)
    assert line["correct"] is False
    assert line["checks"]["wrong_answers"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_batch_left_out_is_caught(monkeypatch, cell):
    from tidb_tpu_torch.store import copr
    orig = copr.decode_cop_batch

    def half(plan, batch):
        return orig(plan, batch[:(len(batch) + 1) // 2])
    monkeypatch.setattr(copr, "decode_cop_batch", half)
    line = _run(cell)
    assert line["correct"] is False
    assert line["checks"]["wrong_answers"]["value"] > 0
