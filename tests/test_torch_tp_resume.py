"""Checkpoints of tensor-parallel runs, through ``train.main`` on the CPU
(``torch_tp_worker.cli_run``; backbone of dim 16, one stage, 16x16, batch 2,
``--ckpt_every 1``), TP on 2 gloo ranks at mesh (1, 2), ``--tp_min_width 16``.

A resumed run starts its loader's epoch and its draws anew, as JAX's does,
so a resumed step is held against the step the same checkpoint gives when
it is resumed the other way (under TP, in one process), not against the
uninterrupted run's step, which reads another batch.

* U: a TP run of 2 steps; its checkpoints hold one process's full layout
  (the shapes of a one-process UNet), Adam's moments too.
* T2 and O2: U's step 1 resumed under TP and in one process take the same
  step 2: the loss to 1e-5 relative, the parameters within Adam's bound of
  ``test_torch_parallel_steps.py`` (1e-3 * lr where the gradient is
  significant, else 2 * lr) by O2's gradients.
* T3 and O3: O2's one-process step 2 resumed under TP and in one process
  take the same step 3, to the same tolerances.
* A TEDM head trained under TP on U's backbone (its frozen backbone sharded
  too) saves full layouts and serves in one process in ``Predictor``.
"""

import os
import sys

import numpy as np
import pytest
import torch

import test_torch_parallel_steps as S
import torch_parallel_worker as W
import torch_tp_worker as T
from tedm_tpu_torch.config import config_from_args
from tedm_tpu_torch.data.datasets import SyntheticCXRDataset
from tedm_tpu_torch.models.unet import Unet
from tedm_tpu_torch.serve.app import Predictor
from tedm_tpu_torch.utils.checkpoint import load_checkpoint

BB = ["--experiment", "img_only"]


def run_dir(argv):
    return config_from_args([*argv, *T.CLI]).log_dir


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp_resume"))
    sys.modules.setdefault("tensorflow", None)  # the one-process runs' TensorBoard writer works without it
    argv = {"U": [*BB, "--log_dir", os.path.join(tmp, "U"), "--max_steps", "2"]}
    u = run_dir(argv["U"])
    argv["TEDM"] = ["--experiment", "TEDM", "--n_labelled_images", "1", "--saved_diffusion_model",
                    os.path.join(u, "step_2"), "--max_steps", "1", "--log_dir", os.path.join(tmp, "logs", "run")]
    W.spawn(T.resume_cases, 2, tmp, tmp, argv, timeout=300)
    out = {k: torch.load(os.path.join(tmp, f"{k}.pt"), weights_only=False) for k in argv}
    argv["O2"] = [*BB, "--log_dir", os.path.join(tmp, "O2"), "--max_steps", "2", "--resume_path",
                  os.path.join(u, "step_1")]
    out["O2"] = T.cli_run(argv["O2"], tp=False)
    o2 = run_dir(argv["O2"])
    argv["O3"] = [*BB, "--log_dir", os.path.join(tmp, "O3"), "--max_steps", "3", "--resume_path",
                  os.path.join(o2, "step_2")]
    out["O3"] = T.cli_run(argv["O3"], tp=False)
    later = {"T2": [*BB, "--log_dir", os.path.join(tmp, "T2"), "--max_steps", "2", "--resume_path",
                    os.path.join(u, "step_1")],
             "T3": [*BB, "--log_dir", os.path.join(tmp, "T3"), "--max_steps", "3", "--resume_path",
                    os.path.join(o2, "step_2")]}
    W.spawn(T.resume_cases, 2, tmp, tmp, later, timeout=300)
    argv.update(later)
    out.update({k: torch.load(os.path.join(tmp, f"{k}.pt"), weights_only=False) for k in later})
    return tmp, {k: run_dir(a) for k, a in argv.items()}, out


def state(d, step):
    return load_checkpoint(os.path.join(d, f"step_{step}"), verbose=False)[0]


def held_to(got_dir, want_dir, step, logged, grads):
    """The deviations of ``got_dir``'s step against ``want_dir``'s, by the
    gradients of the run that wrote ``want_dir``."""
    want, got = state(want_dir, step), state(got_dir, step)
    names = list(want["params"])
    loss = dict(logged)
    return S.deviations({"loss": loss[step], "params": {k: v.numpy() for k, v in got["params"].items()},
                         "grads": dict(zip(names, grads))},
                        {"loss": loss[step], "params": {k: v.numpy() for k, v in want["params"].items()}})


def test_tp_checkpoint_holds_one_process_layout(runs):
    _, dirs, _ = runs
    one = Unet(dim=T.DIM, dim_mults=T.ONE_STAGE).state_dict()
    st = state(dirs["U"], 2)
    assert {k: tuple(v.shape) for k, v in st["params"].items()} == {k: tuple(v.shape) for k, v in one.items()}
    params = list(st["params"].values())
    moments = st["opt_state"]["state"]
    assert len(moments) == len(params) and all(m["exp_avg"].shape == p.shape for m, p in zip(moments.values(), params))


def test_tp_checkpoint_resumes_under_tp_and_in_one_process(runs):
    _, dirs, out = runs
    (o2_logged, o2_grads), t2_logged = out["O2"], out["T2"][0]
    assert [s for s, _ in o2_logged] == [s for s, _ in t2_logged] == [2]
    assert abs(t2_logged[0][1] - o2_logged[0][1]) <= 1e-5 * abs(o2_logged[0][1])
    assert held_to(dirs["T2"], dirs["O2"], 2, o2_logged, o2_grads[0]) == []


def test_one_process_checkpoint_resumes_under_tp(runs):
    _, dirs, out = runs
    (o3_logged, o3_grads), t3_logged = out["O3"], out["T3"][0]
    assert [s for s, _ in t3_logged] == [3]
    assert abs(t3_logged[0][1] - o3_logged[0][1]) <= 1e-5 * abs(o3_logged[0][1])
    assert held_to(dirs["T3"], dirs["O3"], 3, o3_logged, o3_grads[0]) == []


def test_tp_head_serves_in_one_process(runs):
    tmp, dirs, out = runs
    assert [s for s, _ in out["TEDM"][0]] == [1]
    st = state(dirs["TEDM"], 1)
    one = Unet(dim=T.DIM, dim_mults=T.ONE_STAGE).state_dict()
    assert {k: tuple(v.shape) for k, v in st["backbone"].items()} == {k: tuple(v.shape) for k, v in one.items()}
    assert tuple(st["classifier"]["1.weight"].shape) == (128, T.DIM, 1, 1)
    os.symlink(os.path.join(dirs["TEDM"], "step_1"), os.path.join(dirs["TEDM"], "best"))
    img = SyntheticCXRDataset("test", 1, 16, labelled=True, seed=0)[0][0][None]
    mask = Predictor(os.path.join(tmp, "logs"), device="cpu").predict(img, "TEDM", 1)
    assert mask.shape == (16, 16) and set(np.unique(mask)) <= {0.0, 1.0}
