"""The port's serving path as a whole, on the CPU, against the JAX package.

A TEDM model (small UNet, dim 16, mults (1, 2), 32x32) with JAX parameters
is written as a port checkpoint under ``logs/TEDM/1/best`` and served by
the port's ``Predictor(device="cpu")``; its ensembled probabilities for one
image and one noise array must match the JAX pipeline on the same inputs
(1e-4). Also: the package imports nothing of JAX or ``tedm_tpu``, and the
entry points refuse to fall back to the CPU.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tedm_tpu.models.segmentation import PixelClassifier as JaxPixelClassifier
from tedm_tpu.models.segmentation import extract_features as jax_extract_features
from tedm_tpu.models.unet import Unet as JaxUnet
from tedm_tpu.ops.schedules import make_schedule as jax_make_schedule
from tedm_tpu.serve.app import load_img as jax_load_img
from tedm_tpu.serve.app import postprocess as jax_postprocess
from tedm_tpu_torch.config import Config
from tedm_tpu_torch.eval.harness import build_eval_task
from tedm_tpu_torch.serve.app import Predictor, load_img, postprocess
from tedm_tpu_torch.train import main as train_main
from tedm_tpu_torch.trainers.baseline import BaselineTask
from tedm_tpu_torch.utils.checkpoint import save_checkpoint
from tedm_tpu_torch.utils.convert import classifier_state_dict, unet_state_dict

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM, MULTS, SIZE = 16, (1, 2), 32
FORBIDDEN = ("jax", "flax", "optax", "orbax", "tedm_tpu")


def _config(tmp_path, experiment="TEDM"):
    return Config(log_dir=str(tmp_path / "run")).replace(
        experiment=experiment, n_labelled_images=1, dim=DIM, dim_mults=MULTS, img_size=SIZE,
        saved_diffusion_model=str(tmp_path / "no_backbone"),
    ).apply_experiment_preset()


def test_predictor_matches_jax_pipeline(tmp_path):
    cfg = _config(tmp_path)
    t_steps = cfg.t_steps_to_save
    rs = np.random.RandomState(0)
    img = rs.rand(1, SIZE, SIZE, 1).astype(np.float32)
    noise = rs.randn(1, SIZE, SIZE, 1).astype(np.float32)

    jmodel = JaxUnet(dim=DIM, dim_mults=MULTS, channels=1, use_pallas=True)
    uparams = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 1)), jnp.zeros((1,), jnp.int32)
    )["params"]
    perturb = lambda tree: jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rs.randn(*p.shape).astype(np.float32), tree
    )
    uparams = perturb(uparams)
    feats = jax.jit(lambda p, x, n: jax_extract_features(
        lambda xx, tt, **kw: jmodel.apply({"params": p}, xx, tt, **kw),
        jax_make_schedule(cfg.timesteps, cfg.beta_schedule), x, t_steps, noise=n,
    ))(uparams, jnp.asarray(img), jnp.asarray(noise))
    jclf = JaxPixelClassifier(stage_channels=(32, 16), n_steps=1, img_size=SIZE)
    cvars = jclf.init(jax.random.PRNGKey(1), feats, train=False)
    cparams = perturb(cvars["params"])
    stats = {k: {"mean": np.zeros_like(v["mean"]), "var": np.ones_like(v["var"])}
             for k, v in cvars["batch_stats"].items()}
    logits = jclf.apply({"params": cparams, "batch_stats": stats}, feats, train=False)
    want = np.asarray(jax.nn.sigmoid(logits)).reshape(len(t_steps), 1, SIZE, SIZE, 1).mean(axis=0)

    as_tensors = lambda sd: {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    save_checkpoint(
        str(tmp_path / "logs" / "TEDM" / "1" / "best"),
        {"backbone": as_tensors(unet_state_dict(uparams)),
         "classifier": as_tensors(classifier_state_dict(cparams, stats, shared=True))},
        cfg,
    )
    pred = Predictor(logs_root=str(tmp_path / "logs"), device="cpu")
    got = pred._probabilities(img, "TEDM", 1, noise=noise)
    assert got.shape == (1, SIZE, SIZE, 1) and np.isfinite(got).all()
    assert 0.05 < want.std()  # probabilities not saturated: the comparison has teeth
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)

    mask = pred.predict(img, "TEDM", 1)
    assert mask.shape == (SIZE, SIZE) and set(np.unique(mask)) <= {0.0, 1.0}
    assert len(pred._cache) == 1  # the model was loaded once
    # a request of another size is resized to the checkpoint's resolution
    assert pred.predict(load_img(rs.rand(48, 48).astype(np.float32), 48), "TEDM", 1).shape == (SIZE, SIZE)


def test_entry_points_refuse_cpu_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_eval_task(_config(tmp_path))


def test_unported_experiment_names_its_roadmap_item(tmp_path, monkeypatch):
    """The contrastive finetunes are served as baseline UNets; nothing of
    ROADMAP A.5h is refused any more: spatial sharding of the contrastive
    arms and a mesh axis outside data, model and spatial reach their
    trainer; ``--multihost`` without torchrun's environment and a
    ``--mesh_shape`` the ranks do not fill are errors in JAX's words."""
    for experiment in ("global_finetune", "glob_loc_finetune"):
        task = build_eval_task(_config(tmp_path, experiment), device="cpu")
        assert isinstance(task, BaselineTask) and task.fold == 1
    with pytest.raises(ValueError, match="not recognized"):
        build_eval_task(_config(tmp_path, "global_cl"), device="cpu")
    from tedm_tpu_torch import train
    from tedm_tpu_torch.trainers import contrastive

    assert not hasattr(train, "NOT_PORTED")
    reached = []
    monkeypatch.setattr(contrastive, "main_global", lambda config, device: reached.append(config))
    for flags in (["--shard_spatial"], ["--mesh_shape", "1", "1", "--mesh_axes", "data", "spatial2"],
                  ["--mesh_axes", "replica"]):
        train_main(["--synthetic_data", "--experiment", "global_cl", "--log_dir", str(tmp_path / "r"), *flags],
                   device="cpu")
    assert [(c.shard_spatial, tuple(c.mesh_axes)) for c in reached] == [
        (True, ("data",)), (False, ("data", "spatial2")), (False, ("replica",))]
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="--multihost needs torchrun's environment"):
        train_main(["--synthetic_data", "--log_dir", str(tmp_path / "r"), "--multihost"], device="cpu")
    with pytest.raises(ValueError, match=r"mesh_shape \(2,\) needs 2 devices, have 1"):
        train_main(["--synthetic_data", "--log_dir", str(tmp_path / "r"), "--mesh_shape", "2"], device="cpu")


@pytest.mark.parametrize("model", ["Step_1", "../TEDM"])
def test_predictor_refuses_a_model_outside_its_folders(model, tmp_path):
    with pytest.raises(KeyError):
        Predictor(logs_root=str(tmp_path), device="cpu").predict(np.zeros((1, 8, 8, 1), np.float32), model, 1)


def test_load_img_and_postprocess_match_jax():
    rs = np.random.RandomState(3)
    raw = (rs.rand(40, 50, 3) * 255).astype(np.float32)
    np.testing.assert_array_equal(load_img(raw, 32), jax_load_img(raw, 32))
    pred = (rs.rand(32, 32) > 0.6).astype(np.float32)
    img = rs.rand(32, 32).astype(np.float32)
    np.testing.assert_array_equal(postprocess(pred, img), jax_postprocess(pred, img))


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_tedm_tpu():
    files = [os.path.join(REPO, "chip_smoke.py")]
    port_scripts = os.path.join(REPO, "scripts", "port")
    files += [os.path.join(port_scripts, n) for n in os.listdir(port_scripts) if n.endswith(".py")]
    for root, _, names in os.walk(os.path.join(REPO, "tedm_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    bad = [
        (os.path.relpath(f, REPO), mod) for f in files for mod in _imports(f)
        if mod.split(".")[0] in FORBIDDEN
    ]
    assert bad == []
