"""The training tooling of ROADMAP A.5g, on the CPU.

* ``--remat`` (block checkpointing inside the ``Unet``): one backbone step's
  loss and gradients equal those of the same step without it (1e-6), with
  and without the opt-in ResnetBlock and flash kernels (their plain versions
  here), and the ``state_dict`` keys do not change.
* ``--profile_dir``: ``train.main`` traces steps 10 to 15 of the backbone's
  loop and of the segmentation loop into a trace file with host events;
  ``--remat`` and ``--profile_dir`` are no longer refused; ``--multihost``
  is taken (A.5h's data axis) and without torchrun's environment it is an
  error, never a quiet run as one process.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from tedm_tpu_torch.config import Config
from tedm_tpu_torch.ops.schedules import make_schedule
from tedm_tpu_torch.train import main as train_main
from tedm_tpu_torch.trainers import diffusion as D
from tedm_tpu_torch.trainers.common import make_optimizer

torch.set_num_threads(2)

SMALL = dict(experiment="img_only", dim=16, dim_mults=(1, 2), img_size=32, batch_size=4, num_workers=1,
             synthetic_data=True, timesteps=50)
ARGS = ["--synthetic_data", "--dim", "8", "--dim_mults", "1", "2", "--img_size", "16", "--batch_size", "2",
        "--timesteps", "20", "--val_steps", "4", "--n_sampled_imgs", "2", "--num_workers", "1"]


@pytest.mark.parametrize("flags", [{}, {"use_pallas_resblock": True, "use_pallas_flash": True}],
                         ids=["default", "resblock+flash"])
def test_remat_step_equals_the_step_without_it(flags):
    grads, losses, keys = [], [], []
    x = torch.from_numpy(np.random.RandomState(0).rand(4, 1, 32, 32).astype(np.float32))
    t = torch.tensor([1, 10, 25, 49])
    noise = torch.from_numpy(np.random.RandomState(1).randn(4, 1, 32, 32).astype(np.float32))
    for remat in (False, True):
        cfg = Config(**SMALL, remat=remat, **flags)
        unet = D.build_model(cfg)  # the same weights from cfg.seed
        assert unet.remat == remat
        steps = D.make_steps(cfg, unet, make_schedule(cfg.timesteps, cfg.beta_schedule),
                             make_optimizer(cfg, unet.parameters()))
        loss, _ = steps.train_step(x, torch.zeros(1), torch.ones(4), t=t, noise=noise)
        losses.append(float(loss))
        grads.append({n: p.grad.clone() for n, p in unet.named_parameters()})
        keys.append(list(unet.state_dict()))
    assert keys[0] == keys[1]
    assert abs(losses[0] - losses[1]) <= 1e-6 * abs(losses[0])
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, atol=1e-6, rtol=0, msg=name)


def _trace_files(root):
    return glob.glob(os.path.join(root, "**", "*.pt.trace.json"), recursive=True)


@pytest.mark.parametrize("experiment", ["img_only", "baseline"])
def test_profile_dir_writes_a_trace_and_remat_is_taken(experiment, tmp_path):
    prof = str(tmp_path / "prof")
    argv = ["--experiment", experiment, "--log_dir", str(tmp_path / "run"), "--max_steps", "16",
            "--val_freq", "100", "--log_freq", "8", "--profile_dir", prof, *ARGS]
    if experiment == "baseline":
        argv += ["--n_labelled_images", "3"]
    else:
        argv += ["--remat"]
    train_main(argv, device="cpu")
    files = _trace_files(prof)
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    # steps 10 to 15: the UNet's convolutions ran inside the trace
    assert sum("conv" in str(e.get("name", "")) for e in events) > 16


def test_a5h_flags_are_still_refused(tmp_path, monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="--multihost needs torchrun's environment"):
        train_main(["--log_dir", str(tmp_path / "r"), "--multihost", *ARGS], device="cpu")
