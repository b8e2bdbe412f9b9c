"""The port's split writer (``tedm_tpu_torch.data.make_splits``) against the
JAX package's (``tedm_tpu.data.make_splits``), on the CPU: the same metadata
CSVs (a JSRT table of 50 rows; a CXR14 pair of lists with one image on
disk) through both CLIs write byte-identical split files."""

import os

import pandas as pd
import pytest

from tedm_tpu.data import make_splits as jmake_splits
from tedm_tpu_torch.data import make_splits


@pytest.fixture
def raw(tmp_path):
    src = tmp_path / "raw"
    os.makedirs(src / "images")
    pd.DataFrame({"path": [f"im{i}.png" for i in range(50)], "id": [f"c{i}" for i in range(50)],
                  "mask": [f"m{i}.png" for i in range(50)]}).to_csv(src / "jsrt_metadata_with_masks.csv", index=False)
    names = [f"0000{i:04d}_000.png" for i in range(30)]
    pd.DataFrame({"Image Index": names[:24], "Finding Labels": ["No Finding"] * 24}).to_csv(
        src / "train_val_list.csv", index=False)
    pd.DataFrame({"Image Index": names[24:], "Finding Labels": ["Mass"] * 6}).to_csv(src / "test_list.csv", index=False)
    open(src / "images" / names[0], "w").close()
    return src


@pytest.mark.parametrize("dataset,seed", [("jsrt", 0), ("jsrt", 3), ("cxr14", 1)])
def test_split_csvs_byte_identical_to_jax(raw, tmp_path, dataset, seed):
    argv = [dataset, "--data_dir", str(raw), "--seed", str(seed)]
    make_splits.main([*argv, "--out", str(tmp_path / "port")])
    jmake_splits.main([*argv, "--out", str(tmp_path / "jax")])
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port")) and len(files) == 3
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def test_shipped_splits_are_the_jax_packages():
    """Where ``main`` writes by default: the port's own copies of the shipped
    splits, byte for byte the JAX package's."""
    ours = os.path.join(os.path.dirname(make_splits.__file__), "splits")
    theirs = os.path.join(os.path.dirname(jmake_splits.__file__), "splits")
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    for f in os.listdir(theirs):
        with open(os.path.join(ours, f), "rb") as a, open(os.path.join(theirs, f), "rb") as b:
            assert a.read() == b.read(), f
