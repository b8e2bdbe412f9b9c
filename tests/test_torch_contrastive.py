"""The port's contrastive arms against ``tedm_tpu/models/contrastive.py``,
``tedm_tpu/trainers/contrastive.py`` and ``tedm_tpu/trainers/common.py``, on
the CPU (UNet dim 16, mults (1, 2), 32x32, batch 2).

* The UNet's pieces (``encode``, ``run_mid``, ``decode(n_stages=2)``) and the
  GlobalCL and LocalCL outputs (LocalCL in train and eval mode), from
  weights carried by ``utils.convert``: to 2e-4 of the largest entry; flax's
  BatchNorm statistics to 1e-5.
* ``global_nt_xent`` and ``local_region_loss`` (the same centres) to 1e-5
  relative.
* One step of ``global_cl`` and of ``local_cl`` from the same views, against
  JAX's ``_train_cl`` step (its loss, ``jax.value_and_grad``, the gradient
  mask and ``optax.adam``, rebuilt here with the views given): the loss to
  1e-5 relative, the parameters by ``test_torch_train_baseline.py``'s rule
  (1e-3 * lr where the gradient is more than 1e-4 of its tensor's largest
  entry and more than 1e-6, else 2 * lr). For ``local_cl`` only ``ups[:2]``
  move, and the BatchNorm running statistics are flax's.
* The warm-start key sets equal ``_deep_merge``'s.
* Three finetune steps with ``unfreeze_at = 2`` against JAX's
  ``make_train_step`` with a ``freeze_mask``, with and without weight
  decay: the frozen parameters keep their values through step 1, and step 2,
  the first after the unfreeze, is Adam's step bias-corrected by the global
  count, as optax's (``adam_tolerance``). A control runs the pitfall (frozen
  gradients dropped, so that Adam's count starts at the unfreeze) and must
  miss.
* ``train.main`` through global_cl -> local_cl -> glob_loc_finetune (and
  global_finetune) -> ``run_tests`` -> ``Predictor``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tedm_tpu.config import Config as JaxConfig
from tedm_tpu.models import contrastive as jc
from tedm_tpu.models.unet import Unet as JaxUnet
from tedm_tpu.ops.augment import augment_and_concat as jax_augment_and_concat
from tedm_tpu.trainers.baseline import build_task as jax_build_task
from tedm_tpu.trainers.common import make_train_step as jax_make_train_step
from tedm_tpu.trainers.contrastive import FROZEN_PREFIXES as JAX_FROZEN_PREFIXES
from tedm_tpu.trainers.contrastive import _deep_merge
from tedm_tpu_torch.config import Config
from tedm_tpu_torch.data.datasets import SyntheticCXRDataset
from tedm_tpu_torch.data.pipeline import build_dataloaders
from tedm_tpu_torch.eval import run_tests
from tedm_tpu_torch.models import contrastive as tc
from tedm_tpu_torch.models.unet import Unet
from tedm_tpu_torch.serve.app import Predictor
from tedm_tpu_torch.train import main as train_main
from tedm_tpu_torch.trainers import contrastive
from tedm_tpu_torch.trainers.baseline import BaselineTask
from tedm_tpu_torch.trainers.common import make_optimizer, make_train_step
from tedm_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from tedm_tpu_torch.utils.convert import (
    global_cl_state_dict,
    load_numpy_state_dict,
    local_cl_state_dict,
    unet_state_dict,
)

torch.set_num_threads(1)

DIM, MULTS, SIZE, TAU, LR = 16, (1, 2), 32, 0.1, 1e-3
SMALL = dict(dim=DIM, dim_mults=MULTS, img_size=SIZE, batch_size=2, num_workers=1, synthetic_data=True, lr=LR)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def as_numpy(tree):
    """Copies: a jitted step donates its inputs, and a view of a donated
    buffer changes under it."""
    return jax.tree_util.tree_map(np.array, tree)


def close(got, want, what, frac=2e-4):
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, atol=frac * np.abs(want).max(), rtol=0, err_msg=what)


def jax_centres(key, h, w, n=20):
    kx, ky = jax.random.split(key)
    return (torch.from_numpy(np.asarray(jax.random.permutation(kx, h - 2)[:n] + 1)),
            torch.from_numpy(np.asarray(jax.random.permutation(ky, w - 2)[:n] + 1)))


@pytest.fixture(scope="module")
def views():
    """Two augmented views of two synthetic CXR14 images, as JAX's
    ``_train_cl`` draws them: NHWC (4, 32, 32, 1)."""
    ds = SyntheticCXRDataset("cxr_train", 2, SIZE, labelled=False, seed=0)
    x = np.stack([ds[i] for i in range(2)])
    return np.asarray(jax_augment_and_concat(jax.random.PRNGKey(3), jnp.asarray(x)))


def test_unet_pieces_match_jax(views):
    model = JaxUnet(dim=DIM, dim_mults=MULTS, channels=1)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 1)), jnp.zeros((1,), jnp.int32))["params"]

    def pieces(m, x):
        h, r, hs = m.encode(x, None)
        mid = m.run_mid(h, None)
        dec, feats = m.decode(mid, r, hs, None, collect_features=True, n_stages=2)
        return h, r, hs, mid, dec, feats

    want = jax.jit(lambda p, x: model.apply({"params": p}, x, method=pieces))(params, jnp.asarray(views))
    unet = load_numpy_state_dict(Unet(dim=DIM, dim_mults=MULTS), unet_state_dict(as_numpy(params)))
    with torch.no_grad():
        h, r, hs = unet.encode(nchw(views), None)
        mid = unet.run_mid(h, None)
        hs_before = list(hs)
        dec, feats = unet.decode(mid, r, hs, None, collect_features=True, n_stages=2)
        assert [t is u for t, u in zip(hs, hs_before)] == [True] * len(hs) and len(hs) == 4  # left as they were
        full = unet(nchw(views))
        again = unet.final(*unet.decode(unet.run_mid(h, None), r, hs, None)[:1], r, None)
    for name, g, w in [("encode", h, want[0]), ("init residual", r, want[1]), ("mid", mid, want[3]),
                       ("decode n_stages=2", dec, want[4])] + [(f"skip {i}", a, b) for i, (a, b) in
                                                              enumerate(zip(hs, want[2]))] + [
            (f"feature {i}", a, b) for i, (a, b) in enumerate(zip(feats, want[5]))]:
        close(g.numpy(), nchw(w).numpy(), name)
    torch.testing.assert_close(full, again, atol=0, rtol=0)  # forward is the pieces in turn


@pytest.fixture(scope="module")
def cl_weights():
    """JAX GlobalCL and LocalCL variables (random init) at the small size."""
    g = jc.GlobalCL(img_size=SIZE, dim=DIM, dim_mults=MULTS)
    lo = jc.LocalCL(img_size=SIZE, dim=DIM, dim_mults=MULTS)
    zeros = jnp.zeros((2, SIZE, SIZE, 1))
    return (g, as_numpy(g.init(jax.random.PRNGKey(1), zeros)),
            lo, as_numpy(lo.init(jax.random.PRNGKey(2), zeros, train=False)))


def port_global(variables):
    m = tc.GlobalCL(img_size=SIZE, dim=DIM, dim_mults=MULTS)
    return load_numpy_state_dict(m, global_cl_state_dict(variables["params"]))


def port_local(variables):
    m = tc.LocalCL(img_size=SIZE, dim=DIM, dim_mults=MULTS)
    return load_numpy_state_dict(m, local_cl_state_dict(variables["params"], variables["batch_stats"]))


@pytest.mark.parametrize("which", ["global", "local train", "local eval"])
def test_cl_models_match_jax(cl_weights, views, which):
    g, gv, lo, lv = cl_weights
    x = jnp.asarray(views)
    if which == "global":
        want, model = g.apply(gv, x), port_global(gv)
        with torch.no_grad():
            got = model(nchw(views)).numpy()
        close(got, want, which)
        return
    model = port_local(lv)
    train = which == "local train"
    model.train(train)
    with torch.no_grad():
        got = model(nchw(views)).numpy()
    if train:
        want, upd = lo.apply(lv, x, train=True, mutable=["batch_stats"])
        for k, name in (("mean", "running_mean"), ("var", "running_var")):
            np.testing.assert_allclose(getattr(model.g2_bn, name).numpy(), upd["batch_stats"]["g2_bn"][k],
                                       rtol=1e-5, atol=1e-6)
    else:
        want = lo.apply(lv, x, train=False)
    close(got, nchw(want).numpy(), which)


def test_losses_match_jax():
    rs = np.random.RandomState(0)
    f = rs.randn(4, 128).astype(np.float32)
    want = float(jc.global_nt_xent(jnp.asarray(f), 2, TAU))
    assert abs(float(tc.global_nt_xent(torch.from_numpy(f), 2, TAU)) - want) <= 1e-5 * abs(want)
    feats = rs.randn(4, SIZE, SIZE, 16).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = float(jc.local_region_loss(key, jnp.asarray(feats), 2, TAU))
    got = float(tc.local_region_loss(nchw(feats), 2, TAU, centres=jax_centres(key, SIZE, SIZE)))
    assert abs(got - want) <= 1e-5 * abs(want)
    # the centres drawn from a generator: 20 distinct rows and columns away from the border
    cx, cy = tc.region_centres(SIZE, SIZE, torch.Generator().manual_seed(0))
    for c in (cx, cy):
        assert len(set(c.tolist())) == 20 and c.min() >= 1 and c.max() <= SIZE - 2


def test_local_masks_are_built_once_per_shape():
    tc.local_masks.cache_clear()
    for _ in range(3):
        pos, neg, rows = tc.local_masks(2, 20, torch.device("cpu"))
    assert tc.local_masks.cache_info().misses == 1 and pos.shape == (3, 80, 80) and rows.shape == (3, 80)
    assert (neg | ~pos).all()  # every positive is among the negatives, as in the reference


def jax_cl_step(model, variables, views, key, local):
    """JAX's ``_train_cl`` step (tedm_tpu/trainers/contrastive.py:89-102) on
    given views: its loss_of, the gradient mask of ``main_local`` and
    ``optax.adam``."""
    tx = optax.adam(LR)
    p, bs = variables["params"], variables.get("batch_stats", {})
    b = views.shape[0] // 2

    def loss_fn(p):
        if not local:
            return jc.global_nt_xent(model.apply({"params": p}, views), b, TAU), bs
        feats, upd = model.apply({"params": p, "batch_stats": bs}, views, train=True, mutable=["batch_stats"])
        return jc.local_region_loss(key, feats, b, TAU), upd["batch_stats"]

    (loss, new_bs), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(p)
    if local:
        keep = lambda path: path[0].key == "unet" and any(path[1].key.startswith(f"ups_{i}_") for i in range(2))
        grads = jax.tree_util.tree_map_with_path(lambda path, g: g * (1.0 if keep(path) else 0.0), grads)
    updates, _ = tx.update(grads, tx.init(p), p)
    return float(loss), as_numpy(optax.apply_updates(p, updates)), as_numpy(new_bs)


@pytest.mark.parametrize("experiment", ["global_cl", "local_cl"])
def test_cl_step_matches_jax(cl_weights, views, experiment, tmp_path):
    g, gv, lo, lv = cl_weights
    local = experiment == "local_cl"
    key = jax.random.PRNGKey(9)
    loss_j, params_j, stats_j = jax_cl_step(lo if local else g, lv if local else gv, jnp.asarray(views), key, local)

    cfg = Config(**SMALL, experiment=experiment, log_dir=str(tmp_path / "run")).apply_experiment_preset()
    model = port_local(lv) if local else port_global(gv)
    before = {n: t.clone() for n, t in model.state_dict().items()}
    optimizer = torch.optim.Adam(contrastive.trainable_parameters(model), lr=LR)
    steps = contrastive.make_steps(cfg, model, optimizer)
    loss = steps.train_step(None, views=nchw(views), centres=jax_centres(key, SIZE, SIZE) if local else None)
    assert abs(float(loss) - loss_j) <= 1e-5 * abs(loss_j)

    want = local_cl_state_dict(params_j, stats_j) if local else global_cl_state_dict(params_j)
    grads = {n: p.grad for n, p in model.named_parameters()}
    moved = set()
    for name, t in model.state_dict().items():
        got = t.numpy()
        if name.endswith("num_batches_tracked"):
            continue
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got, want[name], rtol=1e-5, atol=1e-6, err_msg=name)
            continue
        if grads[name] is None:  # frozen: unchanged on both sides
            assert local and np.array_equal(got, before[name].numpy()) and np.array_equal(want[name], got), name
            continue
        gabs = np.abs(grads[name].numpy())
        atol = np.where((gabs > 1e-4 * gabs.max()) & (gabs > 1e-6), 1e-3 * LR, 2 * LR)
        assert (np.abs(got - want[name]) <= atol).all(), name
        assert np.abs(got - before[name].numpy()).max() > 0.5 * LR, name
        moved.add(name)
    if local:  # only ups[:2] train (train_local_cl.py:183-192), every tensor of them
        assert moved == {n for n, p in model.named_parameters() if n.startswith("unet.ups.")}
        assert all(n.startswith(("unet.ups.0.", "unet.ups.1.")) for n in moved)
    else:
        assert moved == {n for n, _ in model.named_parameters()}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def test_warm_start_copies_what_deep_merge_copies(cl_weights, tmp_path):
    """A CL checkpoint warm-starts LocalCL (from GlobalCL) and the finetune's
    UNet (from LocalCL) with exactly the tensors ``_deep_merge`` copies.
    The CL weights are perturbed, so that every tensor differs from the
    destination's init."""
    g, gv, lo, lv = cl_weights
    rs = np.random.RandomState(4)
    perturb = lambda tree: jax.tree_util.tree_map(lambda a: a + rs.rand(*a.shape).astype(a.dtype) + 0.5, tree)
    gv, lv = perturb(gv), perturb(lv)
    full = as_numpy(JaxUnet(dim=DIM, dim_mults=MULTS, channels=1).init(
        jax.random.PRNGKey(3), jnp.zeros((1, SIZE, SIZE, 1)), jnp.zeros((1,), jnp.int32))["params"])
    cfg = Config(**SMALL, experiment="global_cl", log_dir=str(tmp_path / "run"))
    cases = [(gv, port_global(gv), lv["params"]["unet"], tc.LocalCL(img_size=SIZE, dim=DIM, dim_mults=MULTS).unet),
             (lv, port_local(lv), full, Unet(dim=DIM, dim_mults=MULTS))]
    for i, (src_vars, src_model, dst_tree, dst_module) in enumerate(cases):
        path = str(tmp_path / f"ckpt{i}")
        save_checkpoint(path, {"params": src_model.state_dict(), "opt_state": {}, "step": 0}, cfg)
        merged = _deep_merge(dst_tree, src_vars["params"]["unet"])
        copied_jax = {p for (p, a), (_, b) in zip(_flat(merged), _flat(dst_tree)) if not np.array_equal(a, b)}
        assert copied_jax == {p for p, _ in _flat(src_vars["params"]["unet"])}
        # the same set in the port's names: the keys of the CL model's pruned UNet
        src_keys = set(unet_state_dict(src_vars["params"]["unet"]))
        assert src_keys == set(src_model.unet.state_dict())
        before = {k: v.clone() for k, v in dst_module.state_dict().items()}
        contrastive.warm_start(dst_module, path)
        after = dst_module.state_dict()
        changed = {k for k in after if not torch.equal(after[k], before[k])}
        assert changed == src_keys
        for k in src_keys:
            torch.testing.assert_close(after[k], src_model.unet.state_dict()[k], atol=0, rtol=0)
    assert contrastive.FROZEN_PREFIXES == JAX_FROZEN_PREFIXES


@pytest.fixture(scope="module")
def finetune_batch():
    ds = SyntheticCXRDataset("train", 2, SIZE, labelled=True, seed=0)
    x, y = (np.stack(a) for a in zip(*(ds[i] for i in range(2))))
    return x, y, np.array([1, 1], np.float32)


def port_freeze_run(params0, cfg, batch, steps, drop_frozen_grads=False):
    """The port's finetune steps with ``FROZEN_PREFIXES`` frozen before step
    2; ``drop_frozen_grads`` runs the pitfall instead (frozen gradients set
    to None, the optimizer's per-parameter count starting at the unfreeze).
    Returns the state_dict and the gradients after each step, and the UNet."""
    unet = load_numpy_state_dict(Unet(dim=DIM, dim_mults=MULTS), unet_state_dict(params0))
    task = BaselineTask(unet=unet)
    frozen = [p for n, p in unet.named_parameters() if n.startswith(contrastive.FROZEN_PREFIXES)]
    optimizer = make_optimizer(cfg, unet.parameters())
    if drop_frozen_grads:
        original = optimizer.step

        def step_without_frozen(*a, **k):
            if drop_frozen_grads[0]:
                for p in frozen:
                    p.grad = None
            return original(*a, **k)

        optimizer.step = step_without_frozen
    step = make_train_step(task, optimizer, () if drop_frozen_grads else frozen)
    x, y, valid = (nchw(batch[0]), nchw(batch[1]), torch.from_numpy(batch[2]))
    out = []
    for i in range(1, steps + 1):
        if drop_frozen_grads:
            drop_frozen_grads[0] = i < 2
        step(x, y, valid, freeze=i < 2)
        out.append(({k: v.clone().numpy() for k, v in unet.state_dict().items()},
                    {n: p.grad.clone().numpy() for n, p in unet.named_parameters() if p.grad is not None}))
    return out, unet


def adam_tolerance(grads):
    """Per element, how far the port's parameter may lie from JAX's after
    Adam steps on these gradients (the port's; a frozen step's are 0 and do
    not count). One step: ``test_torch_train_baseline.py``'s rule, 1e-3 * lr
    where the gradient is more than 1e-4 of its tensor's largest entry and
    more than 1e-6. More steps: 1e-2 * lr where every step's gradient is
    more than 1e-2 of its largest entry and of one sign, so that the first
    moment does not cancel (the gradients' rounding, 5e-6 of the largest
    entry, then moves the ratio of the moments by up to 1e-3, measured
    1.05e-3 * lr); else 2 * lr a step. Adam's count restarting at the
    unfreeze moves the first step after it by 0.26 * lr."""
    live = [g for g in grads if np.any(g)]
    if len(live) == 1:
        g = np.abs(live[0])
        return np.where((g > 1e-4 * g.max()) & (g > 1e-6), 1e-3 * LR, 2 * LR * len(grads))
    sharp = np.all([np.abs(g) > 1e-2 * np.abs(g).max() for g in live], axis=0)
    sharp &= np.all([np.sign(g) == np.sign(live[0]) for g in live], axis=0)
    return np.where(sharp, 1e-2 * LR, 2 * LR * len(grads))


@pytest.mark.parametrize("weight_decay", [0.0, 1e-4])
def test_freeze_then_unfreeze_matches_optax_global_count(finetune_batch, weight_decay, tmp_path):
    kw = dict(SMALL, experiment="global_finetune", n_labelled_images=1, weight_decay=weight_decay,
              unfreeze_weights_at_step=2, log_dir=str(tmp_path / "run"))
    jcfg = JaxConfig(**kw).apply_experiment_preset()
    jtask = jax_build_task(jcfg, jax.random.PRNGKey(0))
    params0 = as_numpy(jtask.params)
    frozen_keys = {k: any(k.startswith(p) for p in JAX_FROZEN_PREFIXES) for k in params0}
    mask = {k: jax.tree_util.tree_map(lambda _: jnp.float32(0.0 if frozen_keys[k] else 1.0), v)
            for k, v in params0.items()}
    tx = optax.adamw(LR, weight_decay=weight_decay) if weight_decay else optax.adam(LR)
    jstep = jax_make_train_step(jtask, tx, mask, unfreeze_at=2)
    x, y, valid = finetune_batch
    p, opt = jtask.params, tx.init(jtask.params)
    want = []
    for i in range(1, 4):
        p, _, opt, _, _ = jstep(p, {}, opt, x, y, valid, jax.random.PRNGKey(i), jnp.int32(i))
        want.append(unet_state_dict(as_numpy(p)))

    cfg = Config(**kw).apply_experiment_preset()
    run, unet = port_freeze_run(params0, cfg, finetune_batch, 3)
    got = [sd for sd, _ in run]
    sd0 = unet_state_dict(params0)
    frozen_names = {n for n, _ in unet.named_parameters() if n.startswith(contrastive.FROZEN_PREFIXES)}
    grad_names = set(run[0][1])
    for name in frozen_names & grad_names:  # step 1: frozen, exactly, on both sides
        assert np.array_equal(got[0][name], sd0[name]) and np.array_equal(want[0][name], sd0[name]), name
    for s in (1, 2):  # step 2 (the first after the unfreeze) and step 3
        for name in grad_names:
            atol = adam_tolerance([g[name] for _, g in run[:s + 1]])
            assert (np.abs(got[s][name] - want[s][name]) <= atol).all(), (s + 1, name)
        for name in frozen_names & grad_names:
            assert np.abs(got[s][name] - got[s - 1][name]).max() > 0.5 * LR, (s + 1, name)
    # no gradient reaches the time MLPs (time=None): the port leaves them as
    # they are; optax's AdamW decays them by lr * wd a step once they are unmasked
    for name in set(sd0) - grad_names:
        assert "time_mlp" in name and np.array_equal(got[2][name], sd0[name]), name

    # the pitfall: frozen gradients dropped, so that Adam's count restarts at
    # the unfreeze; its first step after the unfreeze misses optax's
    bad, _ = port_freeze_run(params0, cfg, finetune_batch, 2, drop_frozen_grads=[True])
    misses = [n for n in frozen_names & grad_names if np.abs(bad[1][0][n] - want[1][n]).max() > 0.1 * LR]
    assert len(misses) > len(frozen_names & grad_names) // 2


def test_augmented_loader_crops_image_and_mask_alike(tmp_path):
    jsrt = lambda: build_dataloaders("JSRT", None, SIZE, 4, 1, 3, seed=0, synthetic=True)["train"]
    loader = jsrt()
    aug = contrastive.AugmentedLoader(loader, seed=0)
    assert aug.batch_size == loader.batch_size and aug.indices is loader.indices
    batches = [b for b, _ in zip(aug.repeat(), range(2))]
    again = [b for b, _ in zip(contrastive.AugmentedLoader(jsrt(), seed=0).repeat(), range(2))]
    plain = next(iter(jsrt()))
    for b, a in zip(batches, again):
        assert b["image"].shape == (3, SIZE, SIZE, 1) and b["image"].flags.c_contiguous
        assert set(np.unique(b["mask"])) <= {0.0, 1.0} and np.array_equal(b["valid"], plain["valid"])
        np.testing.assert_array_equal(b["image"], a["image"])
    assert not np.allclose(batches[0]["image"], plain["image"])


def test_contrastive_chain_through_train_main(tmp_path, capsys):
    logs = tmp_path / "logs"
    a = ["--synthetic_data", "--dim", "8", "--dim_mults", "1", "2", "--img_size", str(SIZE), "--batch_size", "4",
         "--num_workers", "1", "--log_freq", "1", "--max_steps", "2", "--val_freq", "2", "--max_val_steps", "1"]
    train_main(["--experiment", "global_cl", "--log_dir", str(logs / "g")] + a, device="cpu")
    g = logs / "global_cl" / "None" / "g" / "best"
    state, cfg = load_checkpoint(str(g), verbose=False)
    assert set(state) == {"params", "opt_state", "step"} and state["step"] == 2 and cfg.experiment == "global_cl"
    assert not any(k.startswith("unet.ups") or "time_mlp" in k for k in state["params"])

    train_main(["--experiment", "local_cl", "--global_model_path", str(g), "--log_dir", str(logs / "l")] + a,
               device="cpu")
    assert "Loaded GlobalCL backbone" in capsys.readouterr().out
    lstate, _ = load_checkpoint(str(logs / "local_cl" / "None" / "l" / "best"), verbose=False)
    for k, v in state["params"].items():  # local_cl trains ups[:2] alone
        if k.startswith("unet."):
            torch.testing.assert_close(lstate["params"][k], v, atol=0, rtol=0)
    assert any(k.startswith("unet.ups.1.") for k in lstate["params"])

    runs = {}
    for exp, flag, ckpt in (("glob_loc_finetune", "--glob_loc_model_path", logs / "local_cl" / "None" / "l"),
                            ("global_finetune", "--global_model_path", logs / "global_cl" / "None" / "g")):
        train_main(["--experiment", exp, "--n_labelled_images", "3", flag, str(ckpt / "best"),
                    "--unfreeze_weights_at_step", "2", "--augment_at_finetuning", "--max_steps", "3",
                    "--log_dir", str(logs / "f")] + a[:-6] + ["--val_freq", "3", "--max_val_steps", "1"], device="cpu")
        assert "Loaded pretrained encoder" in capsys.readouterr().out
        runs[exp] = logs / exp / "3" / "f"
        fstate, _ = load_checkpoint(str(runs[exp] / "best"), verbose=False)
        assert set(fstate) == {"unet", "opt_state", "step"} and fstate["step"] == 3
    run_tests.main(["--experiment", str(runs["glob_loc_finetune"])], device="cpu")
    names = {f"{k}_predictions.npz" for k in ("JSRT_val", "JSRT_test", "NIH", "Montgomery")}
    assert names <= set(os.listdir(runs["glob_loc_finetune"]))
    img = np.random.RandomState(0).rand(1, SIZE, SIZE, 1).astype(np.float32)
    pred = Predictor(logs_root=str(logs), device="cpu")
    for model in ("Global & Local CL", "Global CL"):
        mask = pred.predict(img, model, 3)
        assert mask.shape == (SIZE, SIZE) and set(np.unique(mask)) <= {0.0, 1.0}


def test_quality_r5_runs_its_contrastive_arm_on_the_cpu(tmp_path):
    import json
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts", "port"))
    import quality_r5

    out = tmp_path / "runs"
    quality_r5.main(["--root", str(tmp_path / "corpus"), "--out", str(out), "--img_size", str(SIZE), "--n_cxr", "16",
                     "--head_steps", "1", "--cl_steps", "1", "--sizes", "1", "--seeds", "0", "--device", "cpu",
                     "--experiments", "glob_loc_finetune", "--extra", "--dim", "8", "--dim_mults", "1", "2"])
    with open(out / "s0" / "summary.json") as f:
        summary = json.load(f)
    assert sorted(summary["experiments"]) == ["glob_loc_finetune/1"]
    assert summary["experiments"]["glob_loc_finetune/1"]["JSRT_test"]["n"] == 25
    assert {"global_cl", "local_cl"} <= set(summary["timing"]) and "backbone" not in summary["timing"]
    with open(out / "quality.json") as f:
        cells = json.load(f)["cells"]
    assert "band" not in cells["glob_loc_finetune/1|JSRT_test"]  # the JAX package has no value here
