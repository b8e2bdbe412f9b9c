"""The port's supervised baseline against ``tedm_tpu/trainers/baseline.py``
and ``tedm_tpu/trainers/common.py``, on the CPU.

The UNet of the JAX baseline task (dim 16, mults (1, 2), 32x32) is carried
into the port by ``utils.convert``; with ``time=None`` its logits agree with
JAX's to 2e-4 of their largest entry. One training step of each (a padding
row in the batch) agrees at the tolerances of
``test_torch_train_segmentation.py``: the loss to 1e-5 relative, the
parameters after the Adam step to 1e-3 * lr where the gradient is more
than 1e-4 of its tensor's largest entry and more than 1e-6, else to
2 * lr. The time MLPs get no gradient on either side; with Adam and no
weight decay both leave them as they were (under ``--weight_decay``,
optax's AdamW would decay them and torch's skips them, so the step is
compared at weight decay 0). The port runs the step on its plain path and,
with each opt-in flag, through the kernels' plain versions without FiLM.
Also: ``train.main`` for the baseline, then ``run_tests`` and
``Predictor("Baseline")`` on what it saved.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tedm_tpu.config import Config as JaxConfig
from tedm_tpu.trainers.baseline import build_task as jax_build_task
from tedm_tpu.trainers.common import make_train_step as jax_make_train_step
from tedm_tpu_torch.config import Config
from tedm_tpu_torch.data.datasets import SyntheticCXRDataset
from tedm_tpu_torch.eval import run_tests
from tedm_tpu_torch.models.unet import Unet
from tedm_tpu_torch.serve.app import Predictor
from tedm_tpu_torch.train import main as train_main
from tedm_tpu_torch.trainers.baseline import BaselineTask, build_task
from tedm_tpu_torch.trainers.common import make_optimizer, make_train_step, to_nchw, unet_kernels
from tedm_tpu_torch.utils.checkpoint import load_checkpoint
from tedm_tpu_torch.utils.convert import load_numpy_state_dict, unet_state_dict

torch.set_num_threads(1)

SMALL = dict(dim=16, dim_mults=(1, 2), img_size=32, batch_size=2, num_workers=1,
             synthetic_data=True, n_labelled_images=1, lr=1e-3, experiment="baseline")
FLAGS = [(), ("use_pallas_resblock",), ("use_pallas_groupnorm",), ("use_pallas_flash",)]


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def jax_step(tmp_path_factory):
    """The JAX baseline's weights, batch, logits and one step from them."""
    jcfg = JaxConfig(**SMALL, log_dir=str(tmp_path_factory.mktemp("b") / "run")).apply_experiment_preset()
    jtask = jax_build_task(jcfg, jax.random.PRNGKey(0))
    params0 = jax.tree_util.tree_map(np.asarray, jtask.params)
    ds = SyntheticCXRDataset("train", 2, 32, labelled=True, seed=0)
    x, y = (np.stack(a) for a in zip(*(ds[i] for i in range(2))))
    valid = np.array([1, 0], np.float32)
    logits = np.asarray(jtask.apply(jtask.params, {}, jnp.asarray(x), None, False)[0])
    tx = optax.adam(jcfg.lr)
    params_j, _, _, loss_j, _ = jax_make_train_step(jtask, tx)(
        jtask.params, jtask.batch_stats, tx.init(jtask.params), x, y, valid, jax.random.PRNGKey(5), jnp.int32(1))
    return dict(params0=params0, x=x, y=y, valid=valid, logits=logits, loss=float(loss_j),
                params=jax.tree_util.tree_map(np.asarray, params_j))


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "+".join(f) or "plain")
def test_baseline_forward_and_step_match_jax(jax_step, flags, tmp_path):
    cfg = Config(**SMALL, log_dir=str(tmp_path / "run"), **{f: True for f in flags}).apply_experiment_preset()
    unet = Unet(dim=16, dim_mults=(1, 2), channels=cfg.out_channels, in_channels=cfg.channels, **unet_kernels(cfg))
    task = BaselineTask(unet=load_numpy_state_dict(unet, unet_state_dict(jax_step["params0"])))
    with torch.no_grad():
        got = task.apply(nchw(jax_step["x"])).numpy()
    want = nchw(jax_step["logits"]).numpy()
    assert got.shape == (2, 1, 32, 32) and want.std() > 1e-2
    np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max(), rtol=0)

    before = {n: p.detach().clone() for n, p in unet.named_parameters()}
    step = make_train_step(task, make_optimizer(cfg, unet.parameters()))
    loss, per_fold = step(nchw(jax_step["x"]), nchw(jax_step["y"]), torch.from_numpy(jax_step["valid"]))
    assert abs(float(loss) - jax_step["loss"]) <= 1e-5 * abs(jax_step["loss"])
    assert per_fold.shape == (1,) and abs(float(per_fold[0]) - float(loss)) <= 1e-6 * float(loss)
    want = unet_state_dict(jax_step["params"])
    for name, p in unet.named_parameters():
        got = p.detach().numpy()
        if p.grad is None:  # the time MLPs: no gradient, unchanged on both sides
            assert "time_mlp" in name and np.array_equal(got, before[name].numpy()), name
            np.testing.assert_array_equal(want[name], before[name].numpy())
            continue
        g = np.abs(p.grad.numpy())
        atol = np.where((g > 1e-4 * g.max()) & (g > 1e-6), 1e-3 * cfg.lr, 2 * cfg.lr)
        assert (np.abs(got - want[name]) <= atol).all(), name
        assert np.abs(got - before[name].numpy()).max() > 0.5 * cfg.lr, name  # the step moved it


@pytest.mark.parametrize("channels", [1, 3])
def test_to_nchw_gives_nchw_strides_and_the_unet_blocks_get_them(channels, tmp_path):
    """The loaders' NHWC batch goes to the UNet through ``to_nchw``. A
    permuted NHWC batch keeps a channel stride of 1, which torch reads as
    channels-last at C = 1 (cuDNN would then run every convolution
    channels-last, and the kernels of ``--use_pallas_resblock`` and
    ``--use_pallas_groupnorm`` take NCHW activations): ``to_nchw`` must give
    NCHW's own strides, and the UNet's blocks must get them."""
    nhwc = np.random.RandomState(0).rand(2, 32, 32, channels).astype(np.float32)
    assert torch.from_numpy(nhwc).permute(0, 3, 1, 2).is_contiguous(memory_format=torch.channels_last)
    x = to_nchw(nhwc, "cpu")
    assert x.stride() == torch.empty(x.shape).stride()
    np.testing.assert_array_equal(x.numpy(), nhwc.transpose(0, 3, 1, 2))
    if channels != 1:
        return
    cfg = Config(**SMALL, log_dir=str(tmp_path / "run")).apply_experiment_preset()
    task = build_task(cfg, device="cpu")
    seen = []
    for m in task.unet.modules():
        if type(m).__name__ == "ResnetBlock":
            m.register_forward_pre_hook(lambda m, args: seen.append((args[0].shape, args[0].stride())))
    with torch.no_grad():
        task.apply(x)
    assert len(seen) == 11  # 4 down, 2 mid, 4 up, the final block
    for shape, stride in seen:
        assert stride == torch.empty(shape).stride(), (shape, stride)


def test_build_task_is_the_whole_unet_trained(tmp_path):
    cfg = Config(**SMALL, log_dir=str(tmp_path / "run")).apply_experiment_preset()
    task = build_task(cfg, device="cpu")
    assert task.trained is task.unet and set(task.modules) == {"unet"} and task.fold == 1
    assert all(p.requires_grad for p in task.unet.parameters())
    assert task.unet.init_conv.weight.shape[1] == cfg.channels and task.unet.final_conv.weight.shape[0] == 1
    again = build_task(cfg, device="cpu")  # initialised from the seed
    for a, b in zip(task.unet.parameters(), again.unet.parameters()):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_baseline_main_then_run_tests_and_predictor(tmp_path, capsys):
    logs = tmp_path / "logs"
    train_main(["--experiment", "JSRT_baseline", "--n_labelled_images", "3", "--synthetic_data",
                "--dim", "8", "--dim_mults", "1", "2", "--img_size", "16", "--batch_size", "4",
                "--num_workers", "1", "--max_steps", "2", "--val_freq", "2", "--log_freq", "1",
                "--log_dir", str(logs / "run")], device="cpu")
    exp_dir = logs / "baseline" / "3" / "run"
    state, cfg = load_checkpoint(str(exp_dir / "best"), verbose=False)
    assert set(state) == {"unet", "opt_state", "step"} and state["step"] == 2 and cfg.experiment == "baseline"

    run_tests.main(["--experiment", str(exp_dir)], device="cpu")
    names = {f"{k}_predictions.npz" for k in ("JSRT_val", "JSRT_test", "NIH", "Montgomery")}
    assert names <= set(os.listdir(exp_dir))
    with np.load(exp_dir / "NIH_predictions.npz") as z:
        assert sorted(z.files) == ["dice", "precision", "recall", "y_hat", "y_star"]
        assert z["y_hat"].shape == z["y_star"].shape == (100, 16, 16, 1) and z["dice"].shape == (100, 1)
    capsys.readouterr()
    again = run_tests.evaluate_experiment(str(exp_dir), device="cpu")  # done: read back, not rerun
    assert "Experiment already tested" in capsys.readouterr().out and len(again) == 4

    pred = Predictor(logs_root=str(logs), device="cpu")
    mask = pred.predict(np.random.RandomState(0).rand(1, 16, 16, 1).astype(np.float32), "Baseline", 3)
    assert mask.shape == (16, 16) and set(np.unique(mask)) <= {0.0, 1.0}
    _, task = next(iter(pred._cache.values()))
    for k, v in task.unet.state_dict().items():  # the trained UNet is what it serves
        torch.testing.assert_close(v, state["unet"][k], atol=0, rtol=0)
