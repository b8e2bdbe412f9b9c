"""The port's synthetic corpus, batch loader and command line against the JAX
package's, on the CPU: ``SyntheticCXRDataset`` samples bit-equal (easy and
hard), the ``Loader``'s batches (order, padding, ``valid``) equal over two
shuffled epochs, also over a CXR14 corpus of PNG files through its
whole-batch ``get_batch`` (with the native library and without), and
``config_from_args`` equal on a few argument lists."""

import numpy as np
import pytest
from PIL import Image

from tedm_tpu.config import config_from_args as jax_config_from_args
from tedm_tpu.data.datasets import CXR14Dataset as JaxCXR14
from tedm_tpu.data.datasets import SyntheticCXRDataset as JaxSynthetic
from tedm_tpu.data.pipeline import Loader as JaxLoader
from tedm_tpu.data.pipeline import build_dataloaders as jax_build_dataloaders
from tedm_tpu_torch.config import config_from_args
from tedm_tpu_torch.data.datasets import CXR14Dataset, SyntheticCXRDataset
from tedm_tpu_torch.data.pipeline import Loader, build_dataloaders


@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("labelled", [False, True])
def test_synthetic_samples_bit_equal(hard, labelled):
    args = ("train", 6, 32)
    ours = SyntheticCXRDataset(*args, labelled=labelled, seed=3, hard=hard)
    theirs = JaxSynthetic(*args, labelled=labelled, seed=3, hard=hard)
    assert len(ours) == len(theirs) and ours.has_labels == labelled
    for i in (0, 5):
        a, b = ours[i], theirs[i]
        for x, y in zip(a if labelled else (a,), b if labelled else (b,)):
            assert x.dtype == y.dtype == np.float32 and x.shape[-1] == 1
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize(
    "kw",
    [
        dict(batch_size=4, shuffle=True, seed=1),                        # a padded last batch
        dict(batch_size=4, shuffle=True, drop_last=True, subset=6),      # subset, dropped tail
        dict(batch_size=8, shuffle=True, drop_last=True, subset=5),      # clamped to the shard
        dict(batch_size=3, shuffle=True, shard_index=1, shard_count=3),  # a strided shard
    ],
)
def test_loader_batches_equal_jax(kw):
    ds = SyntheticCXRDataset("val", 10, 16, labelled=True, seed=0)
    ours, theirs = Loader(ds, num_workers=2, **kw), JaxLoader(ds, num_workers=2, **kw)
    assert (len(ours), ours.batch_size) == (len(theirs), theirs.batch_size)
    for _ in range(2):  # two epochs: the permutation is RandomState(seed + epoch)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(ours)
        for a, b in zip(got, want):
            assert sorted(a) == sorted(b) == ["image", "mask", "valid"]
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


@pytest.fixture(scope="module")
def cxr14_corpus(tmp_path_factory):
    """Five CXR14 PNGs of other sizes than the output, and their split CSV."""
    root = tmp_path_factory.mktemp("cxr14")
    rs = np.random.RandomState(4)
    names = [f"0000{i}_000.png" for i in range(5)]
    for i, name in enumerate(names):
        Image.fromarray(rs.randint(0, 256, (40 + 3 * i, 29 + 5 * i), np.uint8)).save(root / name)
    (root / "train_split.csv").write_text("Image Index\n" + "".join(n + "\n" for n in names))
    return str(root)


@pytest.mark.parametrize("route", ["native", "pil"])
@pytest.mark.parametrize("shard_count", [1, 2])
def test_cxr14_loader_through_get_batch_equals_jax(cxr14_corpus, route, shard_count, monkeypatch):
    """Five files at batch 2: one shard ends on a short batch; of two shards
    (3 and 2 files, 2 batches an epoch), the second runs out and pads a
    whole batch. Every batch is one ``get_batch`` call, handed the
    Loader's thread pool."""
    monkeypatch.setenv("TEDM_NATIVE", "1" if route == "native" else "0")
    calls = []
    get_batch = CXR14Dataset.get_batch
    monkeypatch.setattr(CXR14Dataset, "get_batch",
                        lambda self, idx, *a: calls.append((list(idx), a)) or get_batch(self, idx, *a))
    kw = dict(batch_size=2, shuffle=True, seed=3, shard_count=shard_count, num_workers=2)
    for shard in range(shard_count):
        ours = Loader(CXR14Dataset(cxr14_corpus, img_size=16, splits_dir=cxr14_corpus), shard_index=shard, **kw)
        theirs = JaxLoader(JaxCXR14(cxr14_corpus, img_size=16, splits_dir=cxr14_corpus), shard_index=shard, **kw)
        for _ in range(2):
            got, want = list(ours), list(theirs)
            assert len(got) == len(want) == (3 if shard_count == 1 else 2)
            for a, b in zip(got, want):
                assert sorted(a) == sorted(b) == ["image", "valid"]
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
        assert got[-1]["valid"].tolist() == ([1.0, 0.0] if shard == 0 else [0.0, 0.0])
    real = [len(b) for b, _ in calls]
    assert real and all(n in (1, 2) for n in real) and sum(real) == 2 * 5  # two epochs of every file
    assert all(len(a) == 1 for _, a in calls)  # the pool's map, for the rows PIL reads


def test_build_dataloaders_matches_jax_and_refuses_real_data(tmp_path):
    kw = dict(img_size=16, batch_size=4, num_workers=1, n_labelled_images=3, seed=2, synthetic=True)
    ours, theirs = build_dataloaders("JSRT", None, **kw), jax_build_dataloaders("JSRT", None, **kw)
    for split in ("train", "val", "test"):
        assert (len(ours[split]), ours[split].batch_size) == (len(theirs[split]), theirs[split].batch_size)
        np.testing.assert_array_equal(next(iter(ours[split]))["image"], next(iter(theirs[split]))["image"])
    cxr = build_dataloaders("CXR14", None, img_size=16, batch_size=4, num_workers=1)
    assert not cxr["train"].has_labels and len(cxr["val"]) == 512
    with pytest.raises(ValueError, match="requires synthetic data"):  # the device backend renders synthetic images
        build_dataloaders("JSRT", str(tmp_path), backend="device", **{**kw, "synthetic": False})
    ours, theirs = (f("JSRT", None, backend="grain", **kw) for f in (build_dataloaders, jax_build_dataloaders))
    np.testing.assert_array_equal(next(iter(ours["train"]))["image"], next(iter(theirs["train"]))["image"])


@pytest.mark.parametrize(
    "argv",
    [
        [],
        ["--experiment", "TEDM", "--n_labelled_images", "3", "--synthetic_data", "--lr", "3e-4"],
        ["--experiment", "img_only", "--dim", "32", "--dim_mults", "1", "2", "4", "--ema_decay",
         "0.999", "--grad_accum", "2", "--no_pallas", "--max_val_steps", "1"],
        ["--experiment", "LEDM", "--t_steps_to_save", "5", "6", "--weight_decay", "0.01",
         "--resume_path", "r/best", "--mesh_shape", "2", "4"],
    ],
)
def test_config_from_args_equals_jax(argv):
    argv = argv + ["--log_dir", "logs/x"]
    assert config_from_args(argv).to_dict() == jax_config_from_args(argv).to_dict()
