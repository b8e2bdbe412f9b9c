"""The port's grid composer and demo helpers against ``tedm_tpu/serve/app.py``.

* ``predict`` of both packages on one stub predictor (the same masks for
  each model and size): the grids are equal element for element, so the
  row order (``MODEL_ORDER``), the column order, the labels ``_put_text``
  draws, ``seg_img``'s post-processing and the padding to 330 are JAX's.
* The Baseline family end to end: JAX baseline weights (perturbed so that the
  predictions spread) carried into port checkpoints by ``utils.convert`` and
  served by the port's ``Predictor`` on the CPU; its probabilities agree with
  the JAX task's to 2e-4, and its grid equals the grid of JAX's ``predict``
  over the JAX task's masks wherever no probability lies within 2e-4 of 0.5.
* ``launch`` and ``main`` refuse without gradio with JAX's ``RuntimeError``;
  ``write_example_images`` writes JAX's 12 PNGs.
"""

import os
import zlib

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tedm_tpu.config import Config as JaxConfig
from tedm_tpu.eval import harness as jh
from tedm_tpu.serve import app as japp
from tedm_tpu_torch.config import Config
from tedm_tpu_torch.serve import app
from tedm_tpu_torch.utils.checkpoint import save_checkpoint
from tedm_tpu_torch.utils.convert import task_state_dicts

torch.set_num_threads(1)

JAX_MODELS = ["Baseline", "Global CL", "Global & Local CL", "LEDM", "LEDMe", "TEDM"]


class StubPredictor:
    """The same binary mask for a (model, size) in both packages."""

    def __init__(self, size):
        self.size = size

    def predict(self, img, model, training_size):
        rs = np.random.RandomState(zlib.crc32(f"{model}/{training_size}".encode()))
        return (rs.rand(self.size, self.size) > 0.5).astype(np.float32)


def test_model_order_keeps_jax_rows_and_puts_pddm_last():
    assert app.MODEL_ORDER[:6] == japp.MODEL_ORDER and app.MODEL_ORDER[6:] == ["PDDM"]
    assert app.ABSTRACT == japp.ABSTRACT


@pytest.mark.parametrize("seg_img", [False, True])
@pytest.mark.parametrize("models,sizes,mask_size", [
    (["TEDM", "Baseline"], [3], 128),                           # narrow: padded to 330
    (JAX_MODELS[::-1], [197, 1, 12], 128),                      # every JAX row, sizes sorted
    (["LEDMe", "Global CL", "LEDM"], [6, 3], 32),               # masks below the image's size
])
def test_grid_matches_jax(models, sizes, mask_size, seg_img):
    img = (np.random.RandomState(5).rand(150, 140) * 255).astype(np.uint8)
    got = app.predict(img, models, sizes, seg_img, predictor=StubPredictor(mask_size))
    want = japp.predict(img, models, sizes, seg_img, predictor=StubPredictor(mask_size))
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_put_text_matches_jax():
    tile = np.random.RandomState(0).rand(40, 40).astype(np.float32)
    for color in ((0.5, 0.5, 0.5), (1.0, 1.0, 1.0)):
        np.testing.assert_array_equal(app._put_text(tile, "TEDM 197", color), japp._put_text(tile, "TEDM 197", color))


class JaxTaskPredictor:
    """JAX's baseline task on its params: masks, and the probabilities kept."""

    def __init__(self, task, state):
        self.task, self.state, self.probs = task, state, {}

    def predict(self, img, model, training_size):
        if img.shape[1] != 32:  # as JAX's Predictor serves a checkpoint of another size
            img = japp.load_img(img[0, :, :, 0], 32)
        logits, _ = self.task.apply(self.state["params"], self.state["batch_stats"], img,
                                    jax.random.PRNGKey(0), False)
        probs = np.asarray(jax.nn.sigmoid(logits.astype(np.float32)))[0, :, :, 0]
        self.probs[training_size] = probs
        return (probs > 0.5).astype(np.float32)


def test_baseline_family_end_to_end(tmp_path):
    kw = dict(dim=16, dim_mults=(1, 2), img_size=32, batch_size=4, num_workers=1, synthetic_data=True,
              experiment="baseline", n_labelled_images=1, log_dir=str(tmp_path / "run"))
    jcfg = JaxConfig(**kw).apply_experiment_preset()
    jtask = jh.build_eval_task(jcfg)
    rs = np.random.RandomState(0)
    params = jax.tree_util.tree_map(lambda p: np.asarray(p) + 0.1 * rs.randn(*np.shape(p)).astype(np.float32),
                                    jtask.params)
    bstats = jax.tree_util.tree_map(np.asarray, jtask.batch_stats)
    cfg = Config(**kw).apply_experiment_preset()
    state = {k: {n: torch.from_numpy(np.array(v)) for n, v in sd.items()}
             for k, sd in task_state_dicts("baseline", params, bstats).items()}
    sizes = [3, 1]
    for n in sizes:  # one run dir per size, as train.main lays them out
        save_checkpoint(str(tmp_path / "logs" / "baseline" / str(n) / "run" / "best"), state, cfg)

    img = (np.random.RandomState(5).rand(128, 128) * 255).astype(np.uint8)
    predictor = app.Predictor(logs_root=str(tmp_path / "logs"), device="cpu")
    jpred = JaxTaskPredictor(jtask, {"params": params, "batch_stats": bstats})
    got = app.predict(img, ["Baseline"], sizes, False, predictor=predictor)
    want = japp.predict(img, ["Baseline"], sizes, False, predictor=jpred)
    assert got.shape == want.shape == (32, 330, 3)

    small = app.load_img(app.load_img(img)[0, :, :, 0], 32)
    border = []
    for n in sorted(sizes):
        probs = predictor._probabilities(small, "Baseline", n)[0, :, :, 0]
        np.testing.assert_allclose(probs, jpred.probs[n], atol=2e-4, rtol=0)
        assert 0.05 < (probs > 0.5).mean() < 0.95  # the masks are not trivial
        border.append(np.abs(jpred.probs[n] - 0.5) <= 2e-4)
    border = np.concatenate(border, axis=1)
    pad = (330 - border.shape[1]) // 2
    border = np.pad(border, ((0, 0), (pad, pad)))[..., None].repeat(3, axis=2)
    np.testing.assert_array_equal(got[~border], want[~border])


def test_launch_and_main_refuse_without_gradio(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_gradio(name, *args, **kw):
        if name == "gradio":
            raise ImportError("No module named 'gradio'")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_gradio)
    with pytest.raises(RuntimeError, match="gradio is not installed") as jax_err:
        japp.launch("logs")
    for call in (lambda: app.launch("logs", device="cpu"), lambda: app.main(["--logs", "x", "--device", "cpu"])):
        with pytest.raises(RuntimeError, match="gradio is not installed") as err:
            call()
        assert str(err.value).split(";")[0] == str(jax_err.value).split(";")[0]


def test_write_example_images_matches_jax(tmp_path):
    paths = app.write_example_images(str(tmp_path / "port"), img_size=64)
    jpaths = japp.write_example_images(str(tmp_path / "jax"), img_size=64)
    assert len(paths) == len(jpaths) == 12
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in jpaths]
    for p, q in zip(paths, jpaths):
        a, b = np.asarray(Image.open(p)), np.asarray(Image.open(q))
        assert a.shape == (64, 64) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
