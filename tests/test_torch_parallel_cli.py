"""The port's data-parallel entry points on 2 gloo ranks, on the CPU
(``torch_parallel_worker.cli_cases``; UNet dim 16, one stage, 16x16,
batch 2 a rank), held against one process and against the JAX package's
mesh rules.

* ``train.main(["--multihost", ...])``: the backbone under FSDP, a TEDM head
  on it, a finetune and a conditional backbone under DDP. Both ranks log the
  same global loss at every step; only rank 0 writes; the best checkpoint is
  taken on the validation loss reduced over the ranks, and a signal that
  reaches rank 1 alone stops both at the same step with a checkpoint (a
  rank that decided alone would wait in FSDP's gather until the group's
  timeout); the checkpoint's keys are one process's, it resumes under
  FSDP and in one process, loads through ``tedm_tpu/utils/torch_port.py`` and serves in
  ``Predictor``; the finetune's frozen encoder stays as initialised until its
  unfreeze and the baseline UNet's unused time MLPs stay as they were.
* PDDM's pre-pass over the shards gives the moments of one process over the
  whole set.
* ``testing_shared_weights`` and ``run_tests`` (DDIM, 2 steps) on 2 ranks
  write the npz files of one process, to 1e-6 (the first 5 images of each
  set: two batches shared by the ranks, then one that pads).
* ``make_mesh``'s errors and the FSDP size rule against
  ``tedm_tpu/parallel/mesh.py``; the weight-layout cache rebuilds a layout
  whose weight FSDP rewrote without moving its version counter once a new
  epoch starts.
"""

import glob
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from tedm_tpu.models.unet import Unet as JaxUnet
from tedm_tpu.parallel import make_mesh as jax_make_mesh
from tedm_tpu.parallel import param_shardings as jax_param_shardings
from tedm_tpu.utils.torch_port import convert_unet_state_dict
from tedm_tpu_torch.config import Config, config_from_args
from tedm_tpu_torch.eval import run_tests, testing_shared_weights
from tedm_tpu_torch.eval.harness import DATASET_KEYS, load_output
from tedm_tpu_torch.kernels import layouts
from tedm_tpu_torch.models.unet import Unet
from tedm_tpu_torch.parallel import make_mesh, param_shardings
from tedm_tpu_torch.serve.app import Predictor
from tedm_tpu_torch.train import main as train_main
from tedm_tpu_torch.trainers import baseline
from tedm_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(2)

BACKBONE = ["--experiment", "img_only", "--ema_decay", "0.9"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("parallel_cli"))
    W.spawn(W.cli_cases, 2, tmp, tmp, timeout=420)
    return tmp, [torch.load(os.path.join(tmp, f"logged{r}.pt"), weights_only=False) for r in range(2)]


def losses(logged, name):
    return [(step, m["train/loss"]) for step, m in logged[name] if "train/loss" in m]


@pytest.mark.parametrize("run", ["backbone", "backbone resumed", "TEDM", "finetune", "conditional"])
def test_both_ranks_log_the_same_global_loss(ranks, run):
    _, logged = ranks
    l0, l1 = losses(logged[0], run), losses(logged[1], run)
    assert l0 == l1 and [s for s, _ in l0] == {"backbone": [1, 2, 3], "backbone resumed": [4, 5], "TEDM": [1, 2],
                                               "finetune": [1, 2, 3], "conditional": [1]}[run]
    assert all(np.isfinite(v) for _, v in l0)


def test_rank_0_writes_and_a_signal_on_one_rank_stops_both(ranks):
    tmp, logged = ranks
    assert not os.path.exists(os.path.join(tmp, "r1", "CXR14")) and not os.path.exists(os.path.join(tmp, "r1", "logs"))
    run = os.path.join(tmp, "r0", "CXR14", "bb")
    assert os.path.isfile(os.path.join(run, "metrics.jsonl")) and os.path.isfile(os.path.join(run, "images", "val_samples_2.png"))
    for r in range(2):  # the validation loss each rank decided on: the reduced one
        vals = [m["val/loss"] for step, m in logged[r]["backbone"] if "val/loss" in m]
        assert len(vals) == 1
    assert [m["val/loss"] for _, m in logged[0]["backbone"] if "val/loss" in m] == \
           [m["val/loss"] for _, m in logged[1]["backbone"] if "val/loss" in m]
    best, _ = load_checkpoint(os.path.join(run, "best"), verbose=False)
    stopped, _ = load_checkpoint(os.path.join(run, "interrupted"), verbose=False)
    assert best["step"] == 2 and stopped["step"] == 3  # rank 1's signal at step 3 stopped both
    resumed, _ = load_checkpoint(os.path.join(tmp, "r0", "CXR14", "bb2", "step_5"), verbose=False)
    assert resumed["step"] == 5 and resumed["opt_state"]["state"][0]["step"] == 5  # Adam's count, under FSDP


def test_checkpoint_is_one_process_s_and_resumes_and_converts(ranks, tmp_path):
    tmp, _ = ranks
    dp_ckpt = os.path.join(tmp, "r0", "CXR14", "bb", "interrupted")
    train_main(BACKBONE + ["--max_steps", "1", "--val_freq", "100", "--log_freq", "1", "--ckpt_every", "1",
                               "--log_dir", str(tmp_path / "one")] + W.CLI, device="cpu")
    one, _ = load_checkpoint(str(tmp_path / "CXR14" / "one" / "step_1"), verbose=False)
    dp, cfg = load_checkpoint(dp_ckpt, verbose=False)
    assert set(dp) == set(one)
    for key in ("params", "ema_params"):
        assert {k: v.shape for k, v in dp[key].items()} == {k: v.shape for k, v in one[key].items()}
    assert dp["opt_state"]["param_groups"] == one["opt_state"]["param_groups"]
    assert {i: {k: v.shape for k, v in s.items()} for i, s in dp["opt_state"]["state"].items()} == \
           {i: {k: v.shape for k, v in s.items()} for i, s in one["opt_state"]["state"].items()}
    # resumed in one process, at another world size
    train_main(BACKBONE + ["--max_steps", "5", "--val_freq", "100", "--log_freq", "1", "--ckpt_every", "5",
                               "--resume_path", dp_ckpt, "--log_dir", str(tmp_path / "resumed")] + W.CLI, device="cpu")
    resumed, _ = load_checkpoint(str(tmp_path / "CXR14" / "resumed" / "step_5"), verbose=False)
    assert resumed["step"] == 5 and resumed["opt_state"]["state"][0]["step"] == 5
    # the JAX package's mapping of a port state_dict
    want = jax.eval_shape(lambda: JaxUnet(dim=cfg.dim, dim_mults=tuple(cfg.dim_mults), channels=1).init(
        jax.random.PRNGKey(0), np.zeros((1, 16, 16, 1), np.float32), np.zeros((1,), np.int32)))["params"]
    got = convert_unet_state_dict({k: v.numpy() for k, v in dp["params"].items()}, n_stages=len(cfg.dim_mults))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    assert jax.tree_util.tree_map(np.shape, got) == jax.tree_util.tree_map(lambda a: a.shape, want)


def test_dp_head_serves_in_one_process(ranks):
    tmp, _ = ranks
    logs = os.path.join(tmp, "r0", "logs")
    state, _ = load_checkpoint(os.path.join(logs, "TEDM", "1", "run", "best"), verbose=False)
    assert set(state) == {"backbone", "classifier", "opt_state", "step"}
    assert not any(k.startswith("module.") for k in state["classifier"])
    pred = Predictor(logs_root=logs, device="cpu")
    mask = pred.predict(np.random.RandomState(0).rand(1, 16, 16, 1).astype(np.float32), "TEDM", 1)
    assert mask.shape == (16, 16)


def test_finetune_freezes_under_ddp_and_leaves_unused_parameters(ranks):
    tmp, _ = ranks
    run = glob.glob(os.path.join(tmp, "r0", "global_finetune", "*", "ft"))[0]
    cfg = config_from_args(["--experiment", "global_finetune", "--n_labelled_images", "3", *W.CLI])
    init = baseline.build_task(cfg, "cpu").unet.state_dict()
    step1, _ = load_checkpoint(os.path.join(run, "step_1"), verbose=False)
    step3, _ = load_checkpoint(os.path.join(run, "step_3"), verbose=False)
    frozen = [k for k in init if k.startswith(("downs", "init_conv", "mid_"))]
    assert frozen and all(torch.equal(step1["unet"][k], init[k]) for k in frozen)
    assert any(not torch.equal(step3["unet"][k], init[k]) for k in frozen if "norm" not in k)  # unfrozen at step 3
    unused = [k for k in init if "time_mlp" in k]  # the baseline calls the UNet without time
    assert unused and all(torch.equal(step3["unet"][k], init[k]) for k in unused)


def test_pddm_prepass_reduces_to_the_moments_of_the_whole_set(ranks, tmp_path):
    _, logged = ranks
    one = W.pddm_moments(str(tmp_path))
    for r in range(2):
        for k in ("mean", "std"):
            np.testing.assert_allclose(logged[r]["pddm"][k], one[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("run", ["TEDM", "conditional"])
def test_eval_on_2_ranks_writes_the_npz_of_one(ranks, run, tmp_path, monkeypatch):
    tmp, _ = ranks
    for cli in (testing_shared_weights, run_tests):
        monkeypatch.setattr(cli, "build_test_loaders", W.small_sets(cli.build_test_loaders))
    exp = glob.glob(os.path.join(tmp, "r0", "logs" if run == "TEDM" else "", run, "*", "cond" if run != "TEDM" else "run"))[0]
    mine = str(tmp_path / "one")
    shutil.copytree(exp, mine)
    if run == "TEDM":
        testing_shared_weights.main(["-e", mine, "--rerun"], device="cpu")
    else:
        run_tests.main(["-e", mine, "--rerun"], device="cpu")
    names = [os.path.basename(f) for f in glob.glob(os.path.join(mine, "*_predictions.npz"))]
    assert {f"{k}_predictions.npz" for k in DATASET_KEYS} <= set(names)
    for name in names:
        two, one = load_output(os.path.join(exp, name)), load_output(os.path.join(mine, name))
        for key in ("y_hat", "y_star", "dice"):
            np.testing.assert_allclose(two[key], one[key], rtol=0, atol=1e-6, err_msg=f"{name} {key}")


def test_mesh_checks_match_jax():
    devices = jax.devices()
    for shape, n in (((2,), 1), ((4,), 2)):
        with pytest.raises(ValueError) as want:
            jax_make_mesh(shape, devices=devices[:n])
        with pytest.raises(ValueError) as got:
            make_mesh(shape, n_devices=n)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=r"uses 1 of 2 global devices; in a multi-process run"):
        make_mesh((1,), n_devices=2)
    assert make_mesh((), n_devices=2).shape == (2,) == tuple(jax_make_mesh((), devices=devices[:2]).devices.shape)


@pytest.mark.parametrize("min_size", [64, 2 ** 14])
def test_fsdp_size_rule_matches_jax(min_size):
    """The same leaves are sharded, on a dim of the same size, over 2 ranks
    (a UNet of dim 32, whose widest convolutions pass JAX's default 2^14)."""
    unet = Unet(dim=32, dim_mults=(1, 2))
    params = convert_unet_state_dict({k: v.detach().numpy() for k, v in unet.state_dict().items()}, n_stages=2)
    mesh = jax_make_mesh((2,), devices=jax.devices()[:2])
    specs = jax.tree_util.tree_leaves(jax_param_shardings(params, mesh, "fsdp", fsdp_min_size=min_size),
                                      is_leaf=lambda x: hasattr(x, "spec"))
    leaves = jax.tree_util.tree_leaves(params)
    want = sorted((int(np.prod(p.shape)), next((p.shape[i] for i, a in enumerate(s.spec) if a), 0))
                  for p, s in zip(leaves, specs))
    dims = param_shardings(dict(unet.named_parameters()), 2, min_size)
    got = sorted((p.numel(), 0 if dims[n] is None else p.shape[dims[n]]) for n, p in unet.named_parameters())
    assert got == want and any(d for _, d in got) and any(not d for _, d in got)


def test_layout_is_rebuilt_after_an_unversioned_write_in_a_new_epoch():
    """FSDP all-gathers into storage it reuses without moving the version
    counter: the cache keyed by (version, address) alone keeps the old
    layout; a new epoch (each FSDP forward starts one) rebuilds it."""
    w = torch.randn(8, 8)
    built = []
    build = lambda t: built.append(1) or t.clone()
    assert torch.equal(layouts.cached_layout(w, "test", build), w)
    with torch.no_grad(), torch.autograd._unsafe_preserve_version_counter(w):
        w.copy_(torch.randn(8, 8))
    stale = layouts.cached_layout(w, "test", build)
    assert len(built) == 1 and not torch.equal(stale, w)  # what an unchanged key gives
    layouts.new_epoch()
    assert torch.equal(layouts.cached_layout(w, "test", build), w) and len(built) == 2
