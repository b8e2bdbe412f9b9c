"""Feature extraction and the pixel-classifier heads of the port against the
JAX package, on the CPU.

One small UNet (dim 16, mults (1, 2), 32x32) and one head per experiment,
with the same JAX parameters and batch statistics carried across by
``tedm_tpu_torch.utils.convert``; the same image and noise (numpy, seeded)
go through ``extract_features(noise=...)``, the ``PixelClassifier`` and,
for TEDM, the ensemble of sigmoids over timesteps. Tolerance: 1e-4 on the
probabilities in fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tedm_tpu.models.segmentation import PixelClassifier as JaxPixelClassifier
from tedm_tpu.models.segmentation import extract_features as jax_extract_features
from tedm_tpu.models.unet import Unet as JaxUnet
from tedm_tpu.ops.schedules import make_schedule as jax_make_schedule
from tedm_tpu_torch.models.segmentation import PixelClassifier, extract_features
from tedm_tpu_torch.models.unet import Unet
from tedm_tpu_torch.ops.schedules import make_schedule
from tedm_tpu_torch.utils.convert import classifier_state_dict, load_numpy_state_dict, unet_state_dict

torch.set_num_threads(1)

DIM, MULTS, SIZE, B = 16, (1, 2), 32, 2
STAGES = tuple(DIM * m for m in reversed(MULTS))
HEADS = {
    # experiment: (t_steps, shared)
    "TEDM": ((1, 10, 25, 50, 200, 400, 600, 800), True),
    "LEDM": ((50, 150, 250), False),
}


def _perturb(tree, rs, scale=0.1):
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + scale * rs.randn(*p.shape).astype(np.float32), tree
    )


@pytest.fixture(scope="module")
def backbone():
    jmodel = JaxUnet(dim=DIM, dim_mults=MULTS, channels=1, use_pallas=True)
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 1)), jnp.zeros((1,), jnp.int32)
    )["params"]
    params = _perturb(params, np.random.RandomState(0))
    tmodel = load_numpy_state_dict(
        Unet(dim=DIM, dim_mults=MULTS, channels=1), unet_state_dict(params)
    ).eval()
    return jmodel, params, tmodel


@pytest.mark.parametrize("experiment", sorted(HEADS))
def test_head_probabilities_match_jax(backbone, experiment):
    jmodel, uparams, tmodel = backbone
    t_steps, shared = HEADS[experiment]
    s = len(t_steps)
    rs = np.random.RandomState(1)
    x = rs.rand(B, SIZE, SIZE, 1).astype(np.float32)
    noise = rs.randn(B, SIZE, SIZE, 1).astype(np.float32)

    jsched = jax_make_schedule(1000, "cosine")
    feats_j = jax.jit(lambda p, x, n: jax_extract_features(
        lambda xx, tt, **kw: jmodel.apply({"params": p}, xx, tt, **kw),
        jsched, x, t_steps, noise=n,
    ))(uparams, jnp.asarray(x), jnp.asarray(noise))
    jclf = JaxPixelClassifier(stage_channels=STAGES, n_steps=1 if shared else s, img_size=SIZE)
    cvars = jclf.init(jax.random.PRNGKey(1), feats_j, train=False)
    cparams = _perturb(cvars["params"], rs)
    stats = {name: {"mean": 0.1 * rs.randn(*v["mean"].shape).astype(np.float32),
                    "var": (0.5 + rs.rand(*v["var"].shape)).astype(np.float32)}
             for name, v in cvars["batch_stats"].items()}
    logits_j = jclf.apply({"params": cparams, "batch_stats": stats}, feats_j, train=False)
    probs_j = np.asarray(jax.nn.sigmoid(logits_j))
    if shared:
        probs_j = probs_j.reshape(s, B, *probs_j.shape[1:]).mean(axis=0)

    tclf = load_numpy_state_dict(
        PixelClassifier(stage_channels=STAGES, n_steps=1 if shared else s, img_size=SIZE, shared=shared),
        classifier_state_dict(cparams, stats, shared=shared),
    ).eval()
    with torch.no_grad():
        feats_t = extract_features(
            tmodel, make_schedule(1000, "cosine"),
            torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), t_steps,
            noise=torch.from_numpy(noise.transpose(0, 3, 1, 2).copy()),
        )
        probs_t = torch.sigmoid(tclf(feats_t))
    if shared:
        probs_t = probs_t.reshape(s, B, *probs_t.shape[1:]).mean(dim=0)
    for ft, fj in zip(feats_t, feats_j):  # step-major fold, every stage
        assert ft.shape[0] == fj.shape[0] == (s * B)
    probs_t = probs_t.numpy().transpose(0, 2, 3, 1)
    assert probs_t.shape == probs_j.shape == (B, SIZE, SIZE, 1)
    np.testing.assert_allclose(probs_t, probs_j, atol=1e-4, rtol=0)


def test_fresh_noise_per_timestep_from_generator(backbone):
    """Without ``noise``, each timestep of the fold gets its own draw from the
    generator, and the same seed gives the same features."""
    _, _, tmodel = backbone
    sched = make_schedule(1000, "cosine")
    x = torch.rand(1, 1, SIZE, SIZE)
    with torch.no_grad():
        a = extract_features(tmodel, sched, x, (10, 10), generator=torch.Generator().manual_seed(3))
        b = extract_features(tmodel, sched, x, (10, 10), generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a[-1], b[-1], atol=0, rtol=0)
    assert not torch.allclose(a[-1][0], a[-1][1])  # same t, different noise
    with pytest.raises(ValueError):
        extract_features(tmodel, sched, x, (10,))
