"""The look behind the fp32 training cell's swinging numbers
(``signs.py``), on the CPU at a small size: a second plain run of the
reference reads nothing, one turned L1 sign at step 1 moves the first
gradient, and the scan finds no turned sign where the program and the
reference agree."""

import json

from conftest import tiny_cell

from portbench import harness, signs


def lines(monkeypatch, capsys, mode):
    monkeypatch.setattr(harness, "cell", tiny_cell)
    assert signs.main([mode, "--seed", str(2 ** 31 + 3)], device="cpu") == 0
    return [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]


def test_plant(monkeypatch, capsys):
    by_step = {r["turned_at"]: r["numbers"] for r in lines(monkeypatch, capsys, "plant")}
    assert set(by_step) == {None, 0, 1, 2}
    assert by_step[None]["grad_gap"] == 0.0 and by_step[None]["change_gap"] == 0.0
    assert by_step[0]["grad_gap"] > 0.0 and by_step[0]["loss1_gap"] == 0.0
    assert by_step[2]["grad_gap"] == 0.0 and by_step[2]["change_gap"] > 0.0


def test_scan(monkeypatch, capsys):
    (r,) = lines(monkeypatch, capsys, "scan")
    assert r["turned"] == 0 and r["max_out_gap"] < 1e-4
