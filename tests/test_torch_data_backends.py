"""The port's input backends against the JAX package's, on the CPU:
``--data_backend device`` (``tedm_tpu_torch/data/device_synthetic.py``
against ``tedm_tpu/data/device_synthetic.py``) and ``--data_backend grain``
(``tedm_tpu_torch/data/grain_pipeline.py`` against
``tedm_tpu/data/grain_pipeline.py``), and ``train.main``'s refusals.

* ``render`` fed JAX's own draws, re-derived here from ``jax.random`` by the
  key sequence of JAX's generator (fold_in the index, split in 3, each lung's
  key in 6, the last in 2), gives ``make_generator``'s images and masks to
  1e-6.
* An image is a pure function of (split, seed, index): the same index
  renders the same pixels in batches of other sizes, other shards and as a
  padding row.
* The index batches, ``valid`` masks and batch counts are those of JAX's
  ``DeviceSyntheticLoader`` on uneven shards, with and without
  ``drop_last`` (JAX's images are those of the port's index batches).
* The port's ``GrainLoader`` yields JAX's batches, epoch by epoch, filler
  batches included.
* ``train.main`` trains a backbone step on device-rendered batches, and
  refuses ``device`` without synthetic data, ``grain`` without the package,
  ``tp`` without a model axis (JAX's errors, in JAX's words), and no longer
  refuses what ROADMAP A.5h ported last (spatial sharding of the
  contrastive arms, a mesh axis of another name).
"""

import functools
import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tedm_tpu.config import Config as JaxConfig
from tedm_tpu.data import device_synthetic as jds
from tedm_tpu.data.grain_pipeline import GrainLoader as JaxGrainLoader
from tedm_tpu.data.pipeline import build_dataloaders as jax_build_dataloaders
from tedm_tpu.parallel import data_parallel_setup as jax_data_parallel_setup
from tedm_tpu_torch.data import device_synthetic as ds
from tedm_tpu_torch.data.datasets import SyntheticCXRDataset
from tedm_tpu_torch.data.grain_pipeline import GrainLoader
from tedm_tpu_torch.data.pipeline import build_dataloaders
from tedm_tpu_torch.train import main as train_main

SIZE = 16


def jax_draws(base, indices, s):
    """JAX's generator's draws of ``indices``, in ``draws``' layout."""
    lungs, ribs, speckles = [], [], []
    for idx in indices:
        ks = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(base), int(idx)), 3)
        per = []
        for i in range(2):
            k = jax.random.split(ks[i], 6)
            per.append([jax.random.normal(k[0]), jax.random.normal(k[1]), jax.random.uniform(k[2]),
                        jax.random.uniform(k[3]), jax.random.normal(k[4]), jax.random.uniform(k[5])])
        kr = jax.random.split(ks[2], 2)
        lungs.append(np.asarray(per, np.float32))
        ribs.append(np.float32(jax.random.uniform(kr[0])))
        speckles.append(np.asarray(jax.random.normal(kr[1], (s, s))))
    return {"lungs": torch.from_numpy(np.stack(lungs)), "rib": torch.from_numpy(np.asarray(ribs)),
            "speckle": torch.from_numpy(np.stack(speckles))}


@pytest.mark.parametrize("labelled", [True, False])
def test_render_of_jax_draws_is_jax_image(labelled):
    base, idx = ds.base_seed("train", 3), np.array([0, 5, 17, 4096], np.int32)
    assert base == jds._base_seed("train", 3)
    want_img, want_mask = jds.make_generator(SIZE, labelled)(base, jnp.asarray(idx))
    img, mask = ds.render(jax_draws(base, idx, SIZE), labelled)
    nhwc = lambda t: t.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(nhwc(img), np.asarray(want_img), atol=1e-6, rtol=0)
    if labelled:
        assert np.array_equal(nhwc(mask), np.asarray(want_mask))
    else:
        assert mask is None and want_mask is None
    assert img.shape == (4, 1, SIZE, SIZE) and img.is_contiguous()


def test_device_image_is_a_pure_function_of_its_index():
    one = ds.DeviceSyntheticLoader("cxr_train", 9, SIZE, 3, labelled=False, seed=1, device="cpu")
    two = ds.DeviceSyntheticLoader("cxr_train", 9, SIZE, 4, labelled=False, seed=1, shuffle=True, shard_index=1,
                                   shard_count=2, device="cpu")
    rows = []
    for loader in (one, two):
        batches = list(loader.index_batches())
        loader.epoch = 0
        for (idx, _), batch in zip(batches, loader):
            rows += [(int(i), row) for i, row in zip(idx, batch["image"])]
    by_index = {}
    for i, row in rows:
        if i in by_index:
            assert torch.equal(by_index[i], row), i
        by_index[i] = row
    assert len(by_index) == 9 and len(rows) > 9  # every index, some of them twice (index 0 pads)
    assert not torch.equal(by_index[0], by_index[1])
    alone = ds.render(ds.draws(ds.base_seed("cxr_train", 1), np.array([3]), SIZE, "cpu"), False)[0][0]
    assert torch.equal(alone, by_index[3])


@pytest.mark.parametrize("drop_last", [False, True])
def test_device_loader_batches_are_jax_s(drop_last, monkeypatch):
    n, bs, shards = 11, 3, 3
    # one jitted generator for every loader (JAX's loader makes its own)
    monkeypatch.setattr(jds, "make_generator", functools.lru_cache()(jds.make_generator))
    gen = jds.make_generator(SIZE, True)
    for shard in range(shards):
        kw = dict(labelled=True, seed=2, shuffle=True, drop_last=drop_last, shard_index=shard, shard_count=shards)
        mine = ds.DeviceSyntheticLoader("train", n, SIZE, bs, device="cpu", **kw)
        theirs = jds.DeviceSyntheticLoader("train", n, SIZE, bs, **kw)
        assert (len(mine), mine.batch_size) == (len(theirs), theirs.batch_size)
        for epoch in range(2):
            got = list(mine.index_batches())
            want = list(theirs)
            assert len(got) == len(want) == len(mine)
            for (idx, valid), batch in zip(got, want):
                np.testing.assert_array_equal(valid, batch["valid"])
                img, mask = gen(mine._base, jnp.asarray(idx, jnp.int32))
                np.testing.assert_array_equal(np.asarray(img), np.asarray(batch["image"]))
                np.testing.assert_array_equal(np.asarray(mask), np.asarray(batch["mask"]))


@pytest.mark.parametrize("drop_last", [False, True])
def test_grain_loader_batches_are_jax_s(drop_last):
    data = SyntheticCXRDataset("train", 7, SIZE, labelled=True, seed=0)
    for shard in range(3):
        kw = dict(batch_size=2, shuffle=True, seed=4, shard_index=shard, shard_count=3, drop_last=drop_last)
        mine, theirs = GrainLoader(data, **kw), JaxGrainLoader(data, **kw)
        assert (len(mine), mine.batch_size) == (len(theirs), theirs.batch_size)
        fillers = 0
        for epoch in range(2):
            got, want = list(mine), list(theirs)
            assert len(got) == len(want) == len(mine)
            for g, w in zip(got, want):
                assert g.keys() == w.keys()
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k])
                fillers += not g["valid"].any()
        if shard == 2 and not drop_last:
            assert fillers  # 7 over 3 shards: shard 2 holds 2 rows, one batch short of the others'


TINY = ["--experiment", "img_only", "--dim", "8", "--dim_mults", "1", "--img_size", str(SIZE), "--batch_size", "2",
        "--timesteps", "20", "--max_steps", "1", "--val_freq", "100", "--log_freq", "1", "--num_workers", "1"]


def test_device_backend_trains_a_backbone_step(tmp_path, monkeypatch):
    from tedm_tpu_torch.utils import logging

    monkeypatch.setitem(__import__("sys").modules, "tensorflow", None)
    logged = []
    log = logging.MetricsLogger.log
    monkeypatch.setattr(logging.MetricsLogger, "log", lambda self, m, s: logged.append(m) or log(self, m, s))
    train_main([*TINY, "--synthetic_data", "--data_backend", "device", "--log_dir", str(tmp_path / "d")],
               device="cpu")
    assert [np.isfinite(m["train/loss"]) for m in logged if "train/loss" in m] == [True]


def jax_error(fn):
    with pytest.raises(Exception) as e:
        fn()
    return e.type, str(e.value)


def port_error(argv, tmp_path):
    with pytest.raises(Exception) as e:
        train_main([*TINY, *argv, "--log_dir", str(tmp_path / "r")], device="cpu")
    return e.type, str(e.value)


def test_device_backend_needs_synthetic_data(tmp_path):
    want = jax_error(lambda: jax_build_dataloaders("JSRT", str(tmp_path), SIZE, backend="device"))
    assert port_error(["--data_dir", str(tmp_path), "--data_backend", "device"], tmp_path) == want


def test_tp_needs_a_model_axis(tmp_path):
    want = jax_error(lambda: jax_data_parallel_setup(JaxConfig(param_sharding="tp"), 8))
    assert port_error(["--synthetic_data", "--param_sharding", "tp"], tmp_path) == want


def test_grain_backend_names_the_missing_package(tmp_path, monkeypatch):
    find = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None if name == "grain" else find(name, *a))
    kind, msg = port_error(["--synthetic_data", "--data_backend", "grain"], tmp_path)
    assert kind is ModuleNotFoundError and "'grain'" in msg
    with pytest.raises(ModuleNotFoundError, match="grain"):
        build_dataloaders("CXR14", None, SIZE, backend="grain")


@pytest.mark.parametrize("argv", [["--shard_spatial", "--experiment", "global_cl"], ["--mesh_axes", "data", "spatial2"]])
def test_spatial_sharding_is_not_ported(argv, tmp_path, monkeypatch):
    """Ported now (ROADMAP A.5h): the contrastive arms under --shard_spatial
    and a mesh axis outside data, model and spatial reach their trainer."""
    from tedm_tpu_torch.trainers import contrastive, diffusion

    reached = []
    for module, name in ((contrastive, "main_global"), (diffusion, "main")):
        monkeypatch.setattr(module, name, lambda config, device: reached.append(config))
    train_main([*TINY, "--synthetic_data", *argv, "--log_dir", str(tmp_path / "r")], device="cpu")
    assert len(reached) == 1 and reached[0].experiment == (argv[2] if argv[0] == "--shard_spatial" else "img_only")
