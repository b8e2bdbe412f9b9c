"""Spatial sharding at the port's entry points, on the CPU.

* JAX's three refusals of ``--shard_spatial`` (no ``spatial`` axis; with
  ``tp`` or ``fsdp``; a second spatial axis), in JAX's words, where JAX
  raises them: past its one-device return, so on more than one rank and
  not in a world of one.
* Nothing of ROADMAP item A.5h is refused any more: the contrastive arms
  under ``--shard_spatial`` reach their trainers, and on 2 ranks the eval
  CLIs run over a run whose config shards spatially (on the first 5 images
  of each set) and write their files.
* The shape rule (``spatial.plan_for``): a batch whose H the spatial axis
  does not divide is not sharded (JAX's input rule); one that it divides
  must split evenly at every stage, else it is refused; fewer rows a rank
  than the 7x7 conv's halo of 3 run (the halo from the whole map).
* ``train.main --multihost --mesh_shape 1 2 --mesh_axes data spatial
  --shard_spatial`` on 2 gloo ranks for img_only, conditional, TEDM, LEDM,
  baseline, PDDM (standardised, its pre-pass sharded too), global_cl,
  local_cl (at 32^2: its loss draws 20 region rows), global_finetune and
  glob_loc_finetune (with ``--augment_at_finetuning``), UNet dim 16,
  mults (1, 2), 16^2, two steps and a validation: the logged train and
  validation losses equal a one-process run of the same command to 1e-4
  relative, as ``tests/test_dp_training.py::test_diffusion_spatial_loss_parity``
  holds JAX's; each of them convolved with halos. One more img_only run at
  15^2 (one stage), which the rule leaves unsharded: no halo.
"""

import os

import pytest
import torch

import torch_parallel_worker as W
import torch_sp_worker as SW
from tedm_tpu.config import Config as JaxConfig
from tedm_tpu.parallel import data_parallel_setup as jax_data_parallel_setup
from tedm_tpu_torch.config import Config
from tedm_tpu_torch.parallel import mesh, spatial
from tedm_tpu_torch.train import main as train_main

COMMON = ["--synthetic_data", "--dim", str(W.DIM), "--dim_mults", "1", "2", "--img_size", "16", "--batch_size", "2",
          "--timesteps", "20", "--num_workers", "1", "--lr", str(W.LR), "--log_freq", "1", "--max_steps", "2",
          "--val_freq", "2", "--max_val_steps", "1", "--n_sampled_imgs", "2", "--n_labelled_images", "3"]
RUNS = {e: ["--experiment", e] for e in ("img_only", "conditional", "TEDM", "LEDM", "baseline")}
RUNS["PDDM"] = ["--experiment", "PDDM", "--standardize_features"]
RUNS["global_cl"] = ["--experiment", "global_cl"]
RUNS["local_cl"] = ["--experiment", "local_cl", "--img_size", "32"]
RUNS["global_finetune"] = ["--experiment", "global_finetune"]
RUNS["glob_loc_finetune"] = ["--experiment", "glob_loc_finetune", "--augment_at_finetuning"]
RUNS["img_only 15^2"] = ["--experiment", "img_only", "--img_size", "15", "--dim_mults", "1"]
LATER = ("local_cl", "img_only 15^2")  # their own size comes after COMMON's

REFUSED = [  # (JAX's config, the port's), each refused by JAX on 8 CPU devices
    dict(shard_spatial=True),
    dict(mesh_shape=(2, 2), mesh_axes=("data", "spatial"), shard_spatial=True, param_sharding="fsdp",
         fsdp_min_size=64),
    dict(mesh_shape=(2, 2, 2), mesh_axes=("data", "model", "spatial"), shard_spatial=True, param_sharding="tp",
         tp_min_width=32),
    dict(mesh_shape=(2, 2, 2), mesh_axes=("data", "spatial", "spatial2"), shard_spatial=True),
]


def jax_error(kw):
    with pytest.raises(ValueError) as e:
        jax_data_parallel_setup(JaxConfig(**kw), 8)
    return str(e.value)


@pytest.mark.parametrize("kw", REFUSED, ids=["no spatial axis", "fsdp", "tp", "two spatial axes"])
def test_jax_spatial_refusals_in_jax_words(kw):
    want = jax_error(kw)
    assert "spatial" in want
    with W.patched(mesh, "world", lambda: 8):
        with pytest.raises(ValueError) as e:
            mesh.check_config(Config(**kw))
    assert str(e.value) == want
    mesh.check_config(Config(**kw))  # a world of one: JAX's wiring returns before its checks


@pytest.mark.parametrize("experiment", ["global_cl", "local_cl", "global_finetune", "glob_loc_finetune"])
def test_contrastive_arms_refuse_shard_spatial(experiment, tmp_path, monkeypatch):
    """No longer refused: ``--shard_spatial`` reaches the arm's trainer."""
    from tedm_tpu_torch.trainers import contrastive

    name = {"global_cl": "main_global", "local_cl": "main_local"}.get(experiment, "main_finetune")
    reached = []
    monkeypatch.setattr(contrastive, name, lambda config, device: reached.append(config.shard_spatial))
    train_main(["--synthetic_data", "--experiment", experiment, "--shard_spatial", "--log_dir",
                str(tmp_path / "r")], device="cpu")
    assert reached == [True]


def test_shape_rule():
    p = spatial.Plan(None, 2, 0)
    assert spatial.plan_for(None, 16, 1) is None
    assert spatial.plan_for(spatial.Plan(None, 1, 0), 16, 1) is None  # a spatial axis of one
    assert spatial.plan_for(p, 15, 0) is None  # H not divisible: not sharded, as JAX's input rule
    assert spatial.plan_for(p, 16, 3) is p  # 8 rows a rank, 8 / 4 / 2 / 1 a stage
    with pytest.raises(ValueError, match="split evenly"):
        spatial.plan_for(p, 16, 4)
    assert spatial.plan_for(p, 4, 0) is p  # 2 rows a rank: the 7x7's halo reaches past the neighbour
    assert spatial.plan_for(spatial.Plan(None, 4, 0), 128, 3) is not None  # full width at S = 4: 32/16/8/4


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("sp_cli"))
    runs = {name: [*argv, *COMMON, "--log_dir", os.path.join(tmp, "sp", name.replace(" ", "_"))]
            for name, argv in RUNS.items()}
    # a later argument wins: these runs' own size (and depth) come after COMMON's
    for name in LATER:
        runs[name] = [*COMMON, *RUNS[name], "--log_dir", os.path.join(tmp, "sp", name.replace(" ", "_"))]
    W.spawn(SW.cli_cases, 2, tmp, tmp, runs, "TEDM", timeout=300)
    got = torch.load(os.path.join(tmp, "cli.pt"), weights_only=False)
    one = {name: SW.cli_run([a.replace(os.path.join(tmp, "sp"), os.path.join(tmp, "one")) for a in argv])
           for name, argv in runs.items()}
    return got, one


@pytest.mark.parametrize("name", list(RUNS))
def test_shard_spatial_train_main_matches_one_process(cli, name):
    got, one = cli
    assert one[name]["sharded convs"] == 0
    assert (got[name]["sharded convs"] > 0) == (name != "img_only 15^2")  # 15 rows do not split over 2
    for key in ("train/loss", "val/loss"):
        assert len(got[name][key]) == len(one[name][key]) > 0, key
        for a, b in zip(got[name][key], one[name][key]):
            assert abs(a - b) <= 1e-4 * max(abs(b), 1.0), (key, got[name][key], one[name][key])


@pytest.mark.parametrize("name", ["run_tests", "testing_shared_weights"])
def test_eval_clis_refuse_shard_spatial(cli, name):
    """No longer refused: both CLIs run on the 2 ranks over the TEDM run and
    write their files (``test_torch_sp_eval.py`` holds them against one
    process and JAX)."""
    got, _ = cli
    files = got[f"tedm_tpu_torch.eval.{name}"]
    sets = ["JSRT_test", "JSRT_val", "Montgomery", "NIH"]
    assert [f for f in files if "timestep" not in f] == [f"{k}_predictions.npz" for k in sets]
    assert any("timestep" in f for f in files) == (name == "testing_shared_weights")
