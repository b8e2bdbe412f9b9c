"""The port's TEDM head trainer against ``tedm_tpu/trainers/common.py`` and
``tedm_tpu/trainers/datasetdm.py``, on the CPU.

One training step of the shared-weights head (8 timesteps folded into the
batch, a padding row in the batch) through the JAX package's jitted
``make_train_step`` and through the port's, from the same backbone and head
(carried across by ``utils.convert``), the same batch, and the feature noise
JAX draws from the step's key: the loss and the per-timestep losses agree
to 1e-5 relative, the BatchNorm running statistics (flax's update, with the
biased batch variance) to 1e-6, and the head's parameters after the Adam
step to 1e-3 * lr where the gradient is more than 1e-4 of its tensor's
largest entry and more than 100 times Adam's eps, else to 2 * lr (see
``test_torch_train_diffusion.py``). Also: the metrics against
``tedm_tpu/ops/metrics.py`` with their NaN cases, and the head trainer's
``main`` for 2 steps followed by ``Predictor`` serving the checkpoint it
wrote. UNet dim 16, mults (1, 2), 32x32.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from tedm_tpu.config import Config as JaxConfig
from tedm_tpu.ops import metrics as JM
from tedm_tpu.trainers.common import make_train_step as jax_make_train_step
from tedm_tpu.trainers.datasetdm import build_task as jax_build_task
from tedm_tpu_torch.config import Config
from tedm_tpu_torch.data.datasets import SyntheticCXRDataset
from tedm_tpu_torch.models.segmentation import PixelClassifier
from tedm_tpu_torch.models.unet import Unet
from tedm_tpu_torch.ops import metrics as M
from tedm_tpu_torch.ops.schedules import make_schedule
from tedm_tpu_torch.serve.app import Predictor
from tedm_tpu_torch.train import main as train_main
from tedm_tpu_torch.trainers.common import make_optimizer, make_train_step
from tedm_tpu_torch.trainers.datasetdm import SegTask
from tedm_tpu_torch.utils.checkpoint import load_checkpoint
from tedm_tpu_torch.utils.convert import classifier_state_dict, load_numpy_state_dict, unet_state_dict

torch.set_num_threads(1)

SMALL = dict(dim=16, dim_mults=(1, 2), img_size=32, batch_size=2, num_workers=1,
             synthetic_data=True, n_labelled_images=1, lr=1e-3)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def test_tedm_head_step_matches_jax(tmp_path):
    kw = dict(SMALL, experiment="TEDM", saved_diffusion_model=str(tmp_path / "none"),
              log_dir=str(tmp_path / "run"))
    jcfg = JaxConfig(**kw).apply_experiment_preset()
    jtask = jax_build_task(jcfg, jax.random.PRNGKey(0))
    params0 = jax.tree_util.tree_map(np.asarray, jtask.params)
    stats0 = jax.tree_util.tree_map(np.asarray, jtask.batch_stats)
    ds = SyntheticCXRDataset("train", 2, 32, labelled=True, seed=0)
    x, y = (np.stack(a) for a in zip(*(ds[i] for i in range(2))))
    valid = np.array([1, 0], np.float32)
    rng = jax.random.PRNGKey(5)
    tx = optax.adam(jcfg.lr)
    step_j = jax_make_train_step(jtask, tx)
    params_j, stats_j, _, loss_j, per_fold_j = step_j(
        jtask.params, jtask.batch_stats, tx.init(jtask.params), x, y, valid, rng, jnp.int32(1))
    s = len(jcfg.t_steps_to_save)
    noise = jax.random.normal(rng, (s * 2, 32, 32, 1))  # as the JAX task draws the feature noise

    cfg = Config(**kw).apply_experiment_preset()
    unet = load_numpy_state_dict(Unet(dim=16, dim_mults=(1, 2)), unet_state_dict(stats0["backbone"]))
    clf = load_numpy_state_dict(
        PixelClassifier(stage_channels=(32, 16), n_steps=1, img_size=32, shared=True),
        classifier_state_dict(params0, stats0["bn"], shared=True),
    )
    task = SegTask(unet=unet.eval().requires_grad_(False), classifier=clf,
                   sched=make_schedule(cfg.timesteps, cfg.beta_schedule),
                   t_steps=tuple(cfg.t_steps_to_save), normalize=True, fold=s)
    step = make_train_step(task, make_optimizer(cfg, clf.parameters()))
    loss, per_fold = step(nchw(x), nchw(y), torch.from_numpy(valid), noise=nchw(noise))

    assert abs(float(loss) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    np.testing.assert_allclose(per_fold.numpy(), np.asarray(per_fold_j), rtol=1e-5, atol=0)
    want = classifier_state_dict(params_j, stats_j["bn"], shared=True)
    grads = {n: p.grad.numpy() for n, p in clf.named_parameters()}
    for name, got in clf.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        got = got.numpy()
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got, want[name], atol=1e-6, rtol=1e-5, err_msg=name)
            assert np.abs(got - classifier_state_dict(params0, stats0["bn"], True)[name]).max() > 1e-3
            continue
        g = np.abs(grads[name])
        atol = np.where((g > 1e-4 * g.max()) & (g > 1e-6), 1e-3 * cfg.lr, 2 * cfg.lr)
        assert (np.abs(got - want[name]) <= atol).all(), name
    for p in unet.parameters():  # the backbone is frozen
        assert p.grad is None


def test_metrics_match_jax():
    rs = np.random.RandomState(0)
    pred = rs.rand(4, 16, 16, 1) > 0.5
    target = rs.rand(4, 16, 16, 1) > 0.6
    pred[1] = False   # empty prediction: precision 0/0
    target[2] = False  # empty target: recall 0/0
    pred[3] = target[3] = False  # both empty: Dice 0/0
    for fn, jfn in ((M.dice, JM.dice), (M.precision, JM.precision), (M.recall, JM.recall)):
        got, want = fn(nchw(pred), nchw(target)).numpy(), np.asarray(jfn(jnp.asarray(pred), jnp.asarray(target)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        assert np.isnan(got).any() and np.isnan(got).tolist() == np.isnan(want).tolist()
    logits = (rs.randn(4, 16, 16, 1) * 30).astype(np.float32)
    np.testing.assert_allclose(
        M.bce_with_logits(nchw(logits), nchw(target.astype(np.float32))).numpy(),
        nchw(JM.bce_with_logits(jnp.asarray(logits), jnp.asarray(target, jnp.float32))).numpy(),
        rtol=1e-6, atol=1e-6,
    )


def test_head_main_then_predictor_serves_it(tmp_path):
    logs = tmp_path / "logs"
    train_main(["--experiment", "TEDM", "--n_labelled_images", "1", "--synthetic_data",
                "--dim", "16", "--dim_mults", "1", "2", "--img_size", "32", "--num_workers", "1",
                "--saved_diffusion_model", str(tmp_path / "none"), "--max_steps", "2",
                "--val_freq", "2", "--log_freq", "1", "--log_dir", str(logs / "run")], device="cpu")
    best = logs / "TEDM" / "1" / "run" / "best"
    state, cfg = load_checkpoint(str(best), verbose=False)
    assert set(state) == {"backbone", "classifier", "opt_state", "step"} and state["step"] == 2
    with open(logs / "TEDM" / "1" / "run" / "metrics.jsonl") as f:
        text = f.read()
    assert text.count("train_loss/step_800") == 2 and "val/dice" in text

    pred = Predictor(logs_root=str(logs), device="cpu")
    img = np.random.RandomState(0).rand(1, 32, 32, 1).astype(np.float32)
    mask = pred.predict(img, "TEDM", 1)
    assert mask.shape == (32, 32) and set(np.unique(mask)) <= {0.0, 1.0}
    _, task = pred._cache[os.path.join(str(logs / "TEDM" / "1"), "run")]
    for k, v in task.classifier.state_dict().items():  # the trained head is what it serves
        torch.testing.assert_close(v, state["classifier"][k], atol=0, rtol=0)
