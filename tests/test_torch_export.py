"""The kernels as ``torch.library`` ops, and ``serve/export.py``, on the CPU.

* ``torch.library.opcheck`` on each of the five ops (``kernels/ops.py``):
  schema, fake implementation against the CPU one, autograd registration.
* ``export_predictor`` -> ``load_exported`` equals ``Predictor._probabilities``
  before its mean over timesteps to 1e-6 (the baked noise is Predictor's
  draw), and the exported graph holds the port's B.1 op, not its plain
  version; ``export.main`` writes the same artifact; ``load_exported``
  drops the dtype asserts on the graph's intermediate values.
* ``export_sampler`` for img_only (the ancestral step over a short grid,
  DDIM, DPM++), joint (two channels) and conditional (the condition as a
  second argument) equals the eager loops of ``models/diffusion.py`` on the
  same noise to 1e-5, as JAX's tests/test_export.py:16,48,69 round-trip its
  exports; and an exported DDIM (img_only) and DPM++ (conditional) program
  on weights carried from JAX by ``utils.convert`` equals
  ``tedm_tpu/models/diffusion.py``'s loops from the x_T that JAX draws from
  the same key, to 1e-4 (``tests/test_torch_samplers.py``'s gate).

Checkpoints: random weights from a seed (UNet dim 16, mults (1, 2), 32x32,
T = 50), written as the trainers write them.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tedm_tpu.config import Config as JaxConfig
from tedm_tpu.models import diffusion as jd
from tedm_tpu.ops.schedules import make_schedule as jax_make_schedule
from tedm_tpu.trainers import diffusion as jtrain

from tedm_tpu_torch.config import Config
from tedm_tpu_torch.eval.harness import load_diffusion_experiment
from tedm_tpu_torch.kernels import ops
from tedm_tpu_torch.models import diffusion as D
from tedm_tpu_torch.serve import export
from tedm_tpu_torch.serve.app import Predictor
from tedm_tpu_torch.trainers import datasetdm
from tedm_tpu_torch.trainers.diffusion import build_model
from tedm_tpu_torch.utils.checkpoint import save_checkpoint
from tedm_tpu_torch.utils.convert import load_numpy_state_dict, unet_state_dict

torch.set_num_threads(2)

SMALL = dict(dim=16, dim_mults=(1, 2), img_size=32, timesteps=50, num_workers=1, synthetic_data=True)


def _r(g, *shape):
    return torch.randn(*shape, generator=g)


def _op_cases():
    g = torch.Generator().manual_seed(0)
    q, k, v = (_r(g, 2, 4, 32, 64) for _ in range(3))
    x = _r(g, 2, 16, 8, 8)
    return {
        "B.1": (q, k, v, 32 ** -0.5),
        "B.2": (_r(g, 2, 64, 16), _r(g, 64), _r(g, 384, 64), _r(g, 64, 128), _r(g, 64), _r(g, 64)),
        "B.3": (x, _r(g, 16), _r(g, 16), _r(g, 2, 16), _r(g, 2, 16), 8, 1e-5),
        "B.4": (_r(g, 2, 8, 8, 8), _r(g, 16, 8, 3, 3), _r(g, 16), _r(g, 16), _r(g, 16), _r(g, 2, 16), _r(g, 2, 16),
                _r(g, 16, 16, 3, 3), _r(g, 16), _r(g, 16), _r(g, 16), _r(g, 16, 8, 1, 1), _r(g, 16), 8, 1e-5),
        "B.5": (q, k, v, 16.0),
    }


@pytest.mark.parametrize("kernel", ["B.1", "B.2", "B.3", "B.4", "B.5"])
def test_op_passes_opcheck(kernel):
    args = _op_cases()[kernel]
    torch.library.opcheck(ops.OPS[kernel], args)
    if kernel == "B.4":  # the saved buffer holds what saved_views reads, h1 and h2 the plain ones
        from tedm_tpu_torch.kernels import resblock

        out, saved = ops.resnet_block(*args)
        views = resblock.saved_views(saved, 2, 16, 8, 8, 8)
        h1, h2 = resblock.resnet_block_saved_reference(*args[:13])
        torch.testing.assert_close(views["h1"], h1, atol=0, rtol=0)
        torch.testing.assert_close(views["h2"], h2, atol=0, rtol=0)
        torch.testing.assert_close(out, resblock.resnet_block_reference(*args[:13]), atol=0, rtol=0)


@pytest.fixture(scope="module")
def tedm_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tedm")
    cfg = Config(**SMALL, log_dir=str(tmp / "run")).replace(  # the preset makes it TEDM/1/run
        experiment="TEDM", n_labelled_images=1, saved_diffusion_model=str(tmp / "none"),
    ).apply_experiment_preset()
    task = datasetdm.build_task(cfg, device="cpu")  # random weights from cfg.seed
    save_checkpoint(os.path.join(cfg.log_dir, "best"),
                    {"backbone": task.unet.state_dict(), "classifier": task.classifier.state_dict()}, cfg)
    return tmp, cfg


def test_exported_predictor_equals_predictor(tedm_run, tmp_path):
    tmp, cfg = tedm_run
    out = str(tmp_path / "tedm.pt2")
    assert export.export_predictor(cfg.log_dir, out, device="cpu") == os.path.getsize(out) > 10_000
    program = torch.export.load(out)
    targets = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count(torch.ops.tedm_tpu_torch.linear_attention.default) == 4  # 2 down + 2 up stages
    predict = export.load_exported(out, device="cpu")
    img = np.random.RandomState(2).rand(1, 32, 32, 1).astype(np.float32)
    got = predict(img.transpose(0, 3, 1, 2))
    want = Predictor(logs_root=str(tmp), device="cpu")._probabilities(img, "TEDM", 1, mean=False)
    assert got.shape == (8, 1, 32, 32) and want.shape == (8, 32, 32, 1)
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, atol=1e-6, rtol=0)
    # the CLI writes the same program
    cli = str(tmp_path / "cli.pt2")
    export.main(["predictor", "-e", cfg.log_dir, "--out", cli, "--device", "cpu"])
    np.testing.assert_array_equal(export.load_exported(cli, device="cpu")(img.transpose(0, 3, 1, 2)), got)


def test_loaded_program_drops_the_metadata_asserts(tedm_run, tmp_path):
    """``load_exported`` runs the program without the dtype asserts that
    export writes before each cast of an intermediate value, with the same
    output; those on the program's arguments stay."""
    _, cfg = tedm_run
    out = str(tmp_path / "tedm.pt2")
    export.export_predictor(cfg.log_dir, out, device="cpu")
    assert_op = torch.ops.aten._assert_tensor_metadata.default
    raw = torch.export.load(out).module()
    dropped = export._drop_metadata_asserts(torch.export.load(out).module())
    asserts = lambda m: [n for n in m.graph.nodes if n.target is assert_op]
    on_args = [n for n in asserts(raw) if n.args[0].op == "placeholder"]
    assert len(asserts(raw)) > 100 and len(on_args) < 5
    assert [n.args[0].name for n in asserts(dropped)] == [n.args[0].name for n in on_args]
    x = torch.from_numpy(np.random.RandomState(4).rand(1, 1, 32, 32).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(dropped(x), raw(x), atol=0, rtol=0)


def _diffusion_run(tmp, experiment):
    cfg = Config(**SMALL, experiment=experiment, log_dir=str(tmp / experiment))
    save_checkpoint(os.path.join(cfg.log_dir, "best"), {"params": build_model(cfg).state_dict()}, cfg)
    return cfg.log_dir


def _eager(run, sampler, x_T, cond=None, noises=None, grid=None, num_steps=3):
    """The eager loop of models/diffusion.py from the same x_T (and noise)."""
    config, unet, sched = load_diffusion_experiment(run, "cpu")
    apply = unet if cond is None else (lambda x, t: unet(torch.cat([x, cond], dim=1), t))
    kw = dict(objective=config.objective, dynamic_threshold_percentile=config.dynamic_threshold_percentile)
    with torch.no_grad():
        if sampler == "ancestral":
            x = x_T
            for i, t in enumerate(grid):
                tb = torch.full((x.shape[0],), t, dtype=torch.long)
                x = D.sample_step(apply, sched, x, tb, noise=noises[i], **kw)
        elif sampler == "ddim":
            x = D.ddim_sample_loop(apply, sched, x_T.shape, num_steps=num_steps, x_T=x_T, **kw)
        else:
            x = D.dpmpp2m_sample_loop(apply, sched, x_T.shape, num_steps=num_steps, x_T=x_T, **kw)
    return D.unnormalize_to_zero_to_one(x.clamp(-1.0, 1.0)).numpy()


@pytest.mark.parametrize("experiment,sampler", [
    ("img_only", "ancestral"), ("img_only", "ddim"), ("img_only", "dpmpp"),
    ("joint", "ddim"), ("conditional", "dpmpp"),
])
def test_exported_sampler_equals_eager_loop(experiment, sampler, tmp_path):
    run = _diffusion_run(tmp_path, experiment)
    out = str(tmp_path / "sampler.pt2")
    assert export.export_sampler(run, out, batch_size=2, sampler=sampler, num_steps=3, device="cpu") > 10_000
    call = export.load_exported(out, device="cpu")
    channels = 2 if experiment == "joint" else 1
    g = torch.Generator().manual_seed(3)
    x_T = torch.randn(2, channels, 32, 32, generator=g)
    cond = torch.rand(2, 1, 32, 32, generator=g) * 2 - 1 if experiment == "conditional" else None
    extra = () if cond is None else (cond,)
    if sampler == "ancestral":
        assert call.meta["grid"] == list(range(49, -1, -1)) and call.meta["steps"] == 50
        grid = [4, 3, 2, 1, 0]  # the trajectory's last steps, through t = 0 where no noise is added
        noises = torch.randn(len(grid), *x_T.shape, generator=g)
        got = call(x_T, noises, *extra, grid=grid)
        want = _eager(run, sampler, x_T, cond, noises, grid)
    else:
        got = call(x_T, *extra)
        want = _eager(run, sampler, x_T, cond)
    assert got.shape == (2, channels, 32, 32) and np.isfinite(got).all() and 0 <= got.min() and got.max() <= 1
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("experiment,sampler", [("img_only", "ddim"), ("conditional", "dpmpp")])
def test_exported_sampler_matches_jax(experiment, sampler, tmp_path):
    """The port's exported program against the JAX package's loop, on the
    same weights (perturbed, so that samples spread) and the x_T that JAX's
    loop draws from its key (tedm_tpu/models/diffusion.py:260, :312); DDIM at
    eta 0, as both packages export it."""
    jcfg = JaxConfig(**SMALL, experiment=experiment, log_dir=str(tmp_path / experiment)).apply_experiment_preset()
    junet = jtrain.build_model(jcfg)
    rs = np.random.RandomState(0)
    params = jax.tree_util.tree_map(lambda p: np.array(p) + 0.05 * rs.randn(*np.shape(p)).astype(np.float32),
                                    jtrain.init_params(jcfg, junet, jax.random.PRNGKey(0)))
    cfg = Config(**SMALL, experiment=experiment, log_dir=jcfg.log_dir).apply_experiment_preset()
    unet = load_numpy_state_dict(build_model(cfg), unet_state_dict(params))
    save_checkpoint(os.path.join(cfg.log_dir, "best"), {"params": unet.state_dict()}, cfg)
    out = str(tmp_path / "sampler.pt2")
    export.export_sampler(cfg.log_dir, out, batch_size=2, sampler=sampler, num_steps=3, device="cpu")

    shape = (2, 32, 32, 1)
    key = jax.random.PRNGKey(11)
    x_T = np.array(jax.random.normal(jax.random.split(key)[1], shape))  # the loops' init draw
    cond = None
    japply = lambda x, t: junet.apply({"params": params}, x, t)
    if experiment == "conditional":
        cond = np.random.RandomState(1).rand(*shape).astype(np.float32) * 2 - 1
        japply = lambda x, t: junet.apply({"params": params}, jnp.concatenate([x, cond], -1), t)
    jsched = jax_make_schedule(cfg.timesteps, cfg.beta_schedule)
    loop = jd.ddim_sample_loop if sampler == "ddim" else jd.dpmpp2m_sample_loop
    sample = lambda k: jnp.clip(loop(japply, jsched, k, shape, 3, objective=jcfg.objective), -1.0, 1.0)
    want = np.asarray(jd.unnormalize_to_zero_to_one(jax.jit(sample)(key))).transpose(0, 3, 1, 2)
    extra = () if cond is None else (cond.transpose(0, 3, 1, 2),)
    got = export.load_exported(out, device="cpu")(x_T.transpose(0, 3, 1, 2), *extra)
    assert got.shape == want.shape and want.std() > 0.05
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
