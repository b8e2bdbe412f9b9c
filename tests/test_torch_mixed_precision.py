"""The port's bf16 (``--mixed_precision``) path against the JAX package's, on the CPU.

The JAX package runs a bf16 ``PreNormAttn`` through the fused block only
with ``use_pallas`` (on the CPU its jnp reference), while its trainers turn
``use_pallas`` off away from a TPU; so the JAX UNets here are built with
``use_pallas=True``, directly or by wrapping the trainers' ``Unet``. Both
packages round to bf16 at the same points but in differently fused
kernels, so they differ by bf16 rounding: the output and the features agree
to 3e-2 of each tensor's largest entry (measured about 1.5e-2 and 1e-2,
the size of JAX's own bf16-vs-fp32 difference). One Adam step of the
backbone: the loss to 1e-3 relative (measured 6e-6), the whole gradient
to 5e-2 in norm (measured 1.7e-2; JAX's own bf16 gradient is 2.2e-2 from
its fp32 one) and the median tensor to 1e-1 in norm (measured 6.5e-2). No
bound holds for every tensor: where a gradient is a sum that nearly
cancels (the L1 loss's signs at the output bias, the conv biases ahead of
a GroupNorm) bf16 noise is all there is, in JAX as here. One step of a TEDM head on
bf16 features to 1e-3 relative in the loss and 2e-2 of each gradient's
largest entry (the head is fp32). Then the two trainers' ``main`` with
``--mixed_precision`` on a T = 20 backbone, and ``Predictor`` serving the
bf16 head; and the schedule gathers clamp as JAX clamps them: a TEDM head
(timesteps up to 800) on a T = 20 backbone gives JAX's first-step loss.
UNet dim 16; mults (1, 2, 4, 8) at 32x32 for the forward, (1, 2) for the steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tedm_tpu.config import Config as JaxConfig
from tedm_tpu.models.diffusion import train_loss as jax_train_loss
from tedm_tpu.models.unet import Unet as JaxUnet
from tedm_tpu.ops.schedules import make_schedule as jax_make_schedule
from tedm_tpu.trainers import datasetdm as JDS
from tedm_tpu.trainers import diffusion as JD
from tedm_tpu.trainers.common import make_train_step as jax_make_train_step
from tedm_tpu_torch.config import Config
from tedm_tpu_torch.data.datasets import SyntheticCXRDataset
from tedm_tpu_torch.models.diffusion import train_loss
from tedm_tpu_torch.models.segmentation import PixelClassifier
from tedm_tpu_torch.models.unet import Unet
from tedm_tpu_torch.ops.schedules import make_schedule
from tedm_tpu_torch.serve.app import Predictor
from tedm_tpu_torch.train import main as train_main
from tedm_tpu_torch.trainers import diffusion as D
from tedm_tpu_torch.trainers.common import make_optimizer, make_train_step
from tedm_tpu_torch.trainers.datasetdm import SegTask, load_backbone
from tedm_tpu_torch.utils.checkpoint import load_checkpoint
from tedm_tpu_torch.utils.convert import classifier_state_dict, load_numpy_state_dict, unet_state_dict

torch.set_num_threads(1)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def fused_jax_unet(**kw):
    """The trainers' JAX Unet with the fused block on, as on a TPU."""
    return JaxUnet(**{**kw, "use_pallas": True})


def test_bf16_unet_and_features_match_jax():
    jmodel = JaxUnet(dim=16, dim_mults=(1, 2, 4, 8), channels=1, dtype=jnp.bfloat16, use_pallas=True)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)), jnp.zeros((1,), jnp.int32))["params"]
    rs = np.random.RandomState(0)
    params = jax.tree_util.tree_map(lambda p: np.asarray(p) + 0.1 * rs.randn(*p.shape).astype(np.float32), params)
    sd = unet_state_dict(params)
    # the bf16 model keeps fp32 parameters, and an fp32 state_dict loads into it
    unet = load_numpy_state_dict(Unet(dim=16, dim_mults=(1, 2, 4, 8), dtype=torch.bfloat16), sd).eval()
    assert all(v.dtype == torch.float32 for v in unet.state_dict().values())
    assert set(unet.state_dict()) == set(Unet(dim=16, dim_mults=(1, 2, 4, 8)).state_dict())

    x = np.random.RandomState(1).randn(2, 32, 32, 1).astype(np.float32)
    t = np.array([3, 777])
    out_j, feats_j = jax.jit(lambda p, x, t: jmodel.apply(p, x, t, extract_features=True))(
        {"params": params}, jnp.asarray(x), jnp.asarray(t, jnp.int32))
    with torch.no_grad():
        out, feats = unet(nchw(x), torch.from_numpy(t), extract_features=True)
    assert out.dtype == torch.bfloat16 and len(feats) == len(feats_j) == 4
    to_nhwc = lambda a: a.float().numpy().transpose(0, 2, 3, 1)
    assert rel(to_nhwc(out), out_j.astype(jnp.float32)) <= 3e-2
    for f, fj in zip(feats, feats_j):
        assert f.dtype == torch.bfloat16 and rel(to_nhwc(f), fj.astype(jnp.float32)) <= 3e-2


def test_img_only_adam_step_in_bf16_matches_jax(monkeypatch):
    monkeypatch.setattr(JD, "Unet", fused_jax_unet)
    kw = dict(experiment="img_only", dim=16, dim_mults=(1, 2), img_size=32, batch_size=4,
              num_workers=1, synthetic_data=True, mixed_precision=True)
    jcfg = JaxConfig(**kw)
    junet = JD.build_model(jcfg)
    jsched = jax_make_schedule(jcfg.timesteps, jcfg.beta_schedule)
    params = jax.tree_util.tree_map(np.asarray, JD.init_params(jcfg, junet, jax.random.PRNGKey(0)))
    ds = SyntheticCXRDataset("cxr_train", 16, 32, labelled=False, seed=0)
    x = np.stack([ds[i] for i in range(4)])
    valid = np.ones(4, np.float32)
    rng = jax.random.PRNGKey(7)

    def loss_fn(p):
        apply = lambda xx, tt, **k: junet.apply({"params": p}, xx, tt, **k)
        return jax_train_loss(apply, jsched, rng, jnp.asarray(x), valid=jnp.asarray(valid))

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(params)
    grads_j = unet_state_dict(grads_j)

    cfg = Config(**kw)
    unet = load_numpy_state_dict(D.build_model(cfg), unet_state_dict(params))
    assert unet.compute_dtype == torch.bfloat16
    steps = D.make_steps(cfg, unet, make_schedule(cfg.timesteps, cfg.beta_schedule),
                         make_optimizer(cfg, unet.parameters()))
    t_rng, noise_rng = jax.random.split(rng)
    t = torch.from_numpy(np.array(jax.random.randint(t_rng, (4,), 0, 1000))).long()
    noise = nchw(jax.random.normal(noise_rng, x.shape, jnp.float32))
    before = {n: p.detach().clone() for n, p in unet.named_parameters()}
    loss, _ = steps.train_step(nchw(x), torch.zeros(1), torch.from_numpy(valid), t=t, noise=noise)

    assert abs(float(loss) - float(loss_j)) <= 1e-3 * abs(float(loss_j))
    norm_err = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)
    grads = {n: p.grad.numpy() for n, p in unet.named_parameters()}
    flat = lambda d: np.concatenate([d[n].ravel() for n in grads])
    assert norm_err(flat(grads), flat(grads_j)) <= 5e-2
    assert np.median([norm_err(grads[n], grads_j[n]) for n in grads]) <= 1e-1
    for name, p in unet.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32  # fp32 master weights
        assert (p.detach() - before[name]).abs().max() > 0.5 * cfg.lr  # Adam moved it


@pytest.mark.parametrize("mixed_precision,timesteps", [(True, 1000), (False, 20)])
def test_tedm_head_step_matches_jax(mixed_precision, timesteps, monkeypatch, tmp_path):
    """One TEDM head step from the same backbone, head, batch and feature
    noise: on bf16 features of a T = 1000 backbone, and on fp32 features of
    a T = 20 backbone, whose timesteps up to 800 both packages clamp to 19."""
    monkeypatch.setattr(JDS, "Unet", fused_jax_unet)
    kw = dict(experiment="TEDM", dim=16, dim_mults=(1, 2), img_size=32, batch_size=2,
              num_workers=1, synthetic_data=True, n_labelled_images=1, lr=1e-3,
              mixed_precision=mixed_precision, timesteps=timesteps,
              saved_diffusion_model=str(tmp_path / "none"), log_dir=str(tmp_path / "run"))
    jcfg = JaxConfig(**kw).apply_experiment_preset()
    jtask = JDS.build_task(jcfg, jax.random.PRNGKey(0))
    params0 = jax.tree_util.tree_map(np.asarray, jtask.params)
    stats0 = jax.tree_util.tree_map(np.asarray, jtask.batch_stats)
    ds = SyntheticCXRDataset("train", 2, 32, labelled=True, seed=0)
    x, y = (np.stack(a) for a in zip(*(ds[i] for i in range(2))))
    valid = np.array([1, 1], np.float32)
    rng = jax.random.PRNGKey(5)
    tx = optax.adam(jcfg.lr)
    params_j, stats_j, _, loss_j, per_fold_j = jax_make_train_step(jtask, tx)(
        jtask.params, jtask.batch_stats, tx.init(jtask.params), x, y, valid, rng, jnp.int32(1))
    s = len(jcfg.t_steps_to_save)
    noise = jax.random.normal(rng, (s * 2, 32, 32, 1))  # as the JAX task draws the feature noise

    cfg = Config(**kw).apply_experiment_preset()
    dtype = torch.bfloat16 if mixed_precision else torch.float32
    unet = load_numpy_state_dict(Unet(dim=16, dim_mults=(1, 2), dtype=dtype), unet_state_dict(stats0["backbone"]))
    clf = load_numpy_state_dict(
        PixelClassifier(stage_channels=(32, 16), n_steps=1, img_size=32, shared=True),
        classifier_state_dict(params0, stats0["bn"], shared=True),
    )
    sched = make_schedule(cfg.timesteps, cfg.beta_schedule)
    assert sched.num_timesteps == timesteps
    task = SegTask(unet=unet.eval().requires_grad_(False), classifier=clf, sched=sched,
                   t_steps=tuple(cfg.t_steps_to_save), normalize=True, fold=s)
    loss, per_fold = make_train_step(task, make_optimizer(cfg, clf.parameters()))(
        nchw(x), nchw(y), torch.from_numpy(valid), noise=nchw(noise))

    tol = 1e-3 if mixed_precision else 1e-5
    assert abs(float(loss) - float(loss_j)) <= tol * abs(float(loss_j))
    np.testing.assert_allclose(per_fold.numpy(), np.asarray(per_fold_j), rtol=10 * tol, atol=0)
    # Adam's first step moves a weight by lr * g / (|g| + eps): the same
    # where the gradient is well above the features' bf16 noise
    want = classifier_state_dict(params_j, stats_j["bn"], shared=True)
    above = 5e-2 if mixed_precision else 1e-4
    for name, p in clf.named_parameters():
        g = np.abs(p.grad.numpy())
        atol = np.where(g > above * g.max(), 1e-3 * cfg.lr, 2 * cfg.lr)
        assert (np.abs(p.detach().numpy() - want[name]) <= atol).all(), name


def test_mixed_precision_mains_and_predictor(tmp_path):
    small = ["--synthetic_data", "--dim", "16", "--dim_mults", "1", "2", "--img_size", "32",
             "--num_workers", "1", "--mixed_precision", "--log_freq", "1"]
    train_main(["--experiment", "img_only", "--log_dir", str(tmp_path / "bb"), "--timesteps", "20",
                "--batch_size", "4", "--val_steps", "5", "--n_sampled_imgs", "2", "--max_steps", "2",
                "--val_freq", "2", "--max_val_steps", "1", "--ema_decay", "0.9"] + small, device="cpu")
    best = str(tmp_path / "CXR14" / "bb" / "best")
    state, cfg = load_checkpoint(best, verbose=False)
    assert cfg.mixed_precision and all(v.dtype == torch.float32 for v in state["params"].values())

    logs = tmp_path / "logs"
    train_main(["--experiment", "TEDM", "--n_labelled_images", "1", "--saved_diffusion_model", best,
                "--max_steps", "2", "--val_freq", "2", "--log_dir", str(logs / "run")] + small, device="cpu")
    with open(logs / "TEDM" / "1" / "run" / "metrics.jsonl") as f:
        assert "val/dice" in f.read()
    head_state, head_cfg = load_checkpoint(str(logs / "TEDM" / "1" / "run" / "best"), verbose=False)
    assert head_cfg.mixed_precision and all(v.dtype == torch.float32 for v in head_state["backbone"].values())

    pred = Predictor(logs_root=str(logs), device="cpu")
    img = np.random.RandomState(0).rand(1, 32, 32, 1).astype(np.float32)
    noise = np.random.RandomState(1).randn(1, 32, 32, 1).astype(np.float32)
    probs = pred._probabilities(img, "TEDM", 1, noise=noise)
    assert probs.dtype == np.float32 and probs.shape == (1, 32, 32, 1) and np.isfinite(probs).all()
    _, task = next(iter(pred._cache.values()))
    assert task.unet.compute_dtype == torch.bfloat16  # the checkpoint's config.json picks the dtype
    assert pred.predict(img, "TEDM", 1).shape == (32, 32)

    # the same fp32 weights served in fp32 differ by bf16 rounding only
    unet32, _ = load_backbone(head_cfg.replace(mixed_precision=False), device="cpu")
    unet32.load_state_dict(head_state["backbone"])
    task.unet, unet_bf16 = unet32, task.unet
    probs32 = pred._probabilities(img, "TEDM", 1, noise=noise)
    assert 0 < np.abs(probs - probs32).max() <= 5e-2
    task.unet = unet_bf16


def test_schedule_gathers_clamp_past_the_schedule():
    """t beyond T - 1 reads the schedule's last entry, as JAX's gather does,
    in ``extract`` and in the losses' p2 weight."""
    from tedm_tpu_torch.ops.schedules import extract, gather

    sched = make_schedule(20, "cosine", p2_loss_weight_gamma=1.0)
    t = torch.tensor([800, 25, 19, -3])
    want = sched.sqrt_alphas_cumprod[torch.tensor([19, 19, 19, 0])]
    torch.testing.assert_close(extract(sched.sqrt_alphas_cumprod, t, 4).reshape(-1), want, atol=0, rtol=0)
    torch.testing.assert_close(gather(sched.p2_loss_weight, t), sched.p2_loss_weight[[19, 19, 19, 0]])
    loss = train_loss(Unet(dim=16, dim_mults=(1, 2)), sched, torch.rand(4, 1, 32, 32), t=t,
                      noise=torch.randn(4, 1, 32, 32))
    assert torch.isfinite(loss)
