"""The check that decides ``correct``, driven on the CPU at a small size
with the look for a card skipped: a sound run passes it, and the control
(the reference in the precision below the configuration's, in the
program's place) and each fault a cell can have, planted under the timed
path, fail it. The limits are the cells' own."""

import functools
import json

import pytest
from conftest import tiny_cell

from portbench import harness, run

TRAIN = ["ddpm_train.fp32", "ddpm_train.bf16_fused.b64"]
SERVE = ["tedm_serve.fp32", "tedm_serve.bf16_fused"]
SEEDS = [11, 2 ** 31 + 5]  # seeds as large as a check's


def judged(monkeypatch, capsys, name, seed, **kw):
    """``correct`` of a whole run of ``run.py`` on the CPU, the cell cut to
    a small size, with ``kw`` (a fault, or the control) handed to its
    driver."""
    monkeypatch.setattr(harness, "cell", tiny_cell)
    driver = harness.driver(tiny_cell(name)["mix"]["driver"])
    monkeypatch.setattr(driver, "run", functools.partial(driver.run, **kw))
    assert run.main(["--workload", name, "--seed", str(seed), "--seconds", "0.2"], device="cpu") == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])["correct"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["ddpm_train.fp32", "tedm_serve.fp32", "tedm_serve.bf16_fused"])
def test_a_sound_run_is_correct(monkeypatch, capsys, name, seed):
    assert judged(monkeypatch, capsys, name, seed)


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_the_control_is_not_correct(monkeypatch, capsys, name):
    assert not judged(monkeypatch, capsys, name, SEEDS[0], control=True)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("name", TRAIN)
def test_a_broken_training_step_is_not_correct(monkeypatch, capsys, name, fault):
    assert not judged(monkeypatch, capsys, name, SEEDS[1], fault=fault)


@pytest.mark.parametrize("fault", ["half_batch", "altered"])
@pytest.mark.parametrize("name", SERVE)
def test_a_broken_request_is_not_correct(monkeypatch, capsys, name, fault):
    assert not judged(monkeypatch, capsys, name, SEEDS[1], fault=fault)


def test_the_result_line(monkeypatch, capsys):
    """A whole run of ``run.py`` (on the CPU): the last line of standard
    output is the result, its compared numbers last, each printed on
    standard error beside its limit."""
    monkeypatch.setattr(harness, "cell", tiny_cell)
    assert run.main(["--workload", "ddpm_train.fp32", "--seed", str(2 ** 31 + 9), "--seconds", "0.2"],
                    device="cpu") == 0
    out, err = capsys.readouterr()
    result = json.loads(out.strip().splitlines()[-1])
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "compared" and result["correct"] is True
    assert set(result["metrics"]) == {"imgs_per_s", "peak_mem_gib", "setup_s"}
    assert result["attempted"] >= 1 and result["failed"] == 0
    limits = tiny_cell("ddpm_train.fp32")["limits"]
    assert set(result["compared"]) == set(limits)
    assert err.strip().splitlines()[-len(limits):] == [
        f"compared {k} {v['value']!r} limit {v['limit']!r}" for k, v in result["compared"].items()]


@pytest.mark.chip
def test_a_cell_on_the_card(card, capsys):
    """One short run of the cheapest cell on the card, as the check runs it."""
    assert run.main(["--workload", "tedm_serve.bf16_fused", "--seed", str(2 ** 31 + 77), "--seconds", "2"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
