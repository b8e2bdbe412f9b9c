"""The port's UNet and its plain ops against the JAX package, on the CPU.

The same JAX parameters (a seeded init, perturbed so that no bias or gain
keeps its trivial init value) drive ``tedm_tpu.models.unet.Unet`` and, carried
across by ``tedm_tpu_torch.utils.convert``, the port's ``Unet``. Inputs are
made with numpy and given to both. Tolerance: 2e-4 in fp32 (the two
frameworks sum the convolutions and norms in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tedm_tpu.models.unet import Unet as JaxUnet
from tedm_tpu.ops.pallas.groupnorm import group_norm_film_silu_reference as jax_gn
from tedm_tpu.ops.resize import nearest_resize as jax_nearest_resize
from tedm_tpu.ops.resize import nearest_upsample_2x as jax_up2x
from tedm_tpu.ops.schedules import make_schedule as jax_make_schedule
from tedm_tpu_torch.kernels.groupnorm import group_norm_film_silu_reference
from tedm_tpu_torch.models.segmentation import PixelClassifier
from tedm_tpu_torch.models.unet import Unet, count_params
from tedm_tpu_torch.ops.resize import nearest_resize, nearest_upsample_2x
from tedm_tpu_torch.ops.schedules import make_schedule
from tedm_tpu_torch.utils.convert import load_numpy_state_dict, unet_state_dict

torch.set_num_threads(1)

DIM, MULTS, SIZE = 16, (1, 2), 32


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.fixture(scope="module")
def models():
    jmodel = JaxUnet(dim=DIM, dim_mults=MULTS, channels=1, use_pallas=True)
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 1)), jnp.zeros((1,), jnp.int32)
    )["params"]
    rs = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rs.randn(*p.shape).astype(np.float32), params
    )
    tmodel = load_numpy_state_dict(
        Unet(dim=DIM, dim_mults=MULTS, channels=1), unet_state_dict(params)
    ).eval()
    return jmodel, params, tmodel


@pytest.mark.parametrize("with_time", [True, False])
def test_forward_and_features_match_jax(models, with_time):
    jmodel, params, tmodel = models
    x = np.random.RandomState(1).randn(2, SIZE, SIZE, 1).astype(np.float32)
    t = np.array([3, 777], np.int64)
    out_j, feats_j = jax.jit(lambda p, x, t: jmodel.apply(p, x, t, extract_features=True))(
        {"params": params}, jnp.asarray(x), jnp.asarray(t, jnp.int32) if with_time else None
    )
    with torch.no_grad():
        out_t, feats_t = tmodel(_nchw(x), torch.from_numpy(t) if with_time else None,
                                extract_features=True)
    np.testing.assert_allclose(_nhwc(out_t), np.asarray(out_j), atol=2e-4, rtol=0)
    assert len(feats_t) == len(feats_j) == len(MULTS)
    for ft, fj in zip(feats_t, feats_j):
        assert _nhwc(ft).shape == fj.shape
        np.testing.assert_allclose(_nhwc(ft), np.asarray(fj), atol=2e-4, rtol=0)


def test_param_counts_full_width():
    assert count_params(Unet(dim=64, dim_mults=(1, 2, 4, 8), channels=1)) == 36_245_377
    assert count_params(PixelClassifier(n_steps=1, shared=True)) == 127_489
    assert count_params(PixelClassifier(n_steps=3)) == 373_249


@pytest.mark.parametrize("film", [True, False])
def test_group_norm_matches_jax(film):
    rs = np.random.RandomState(2)
    x = (rs.randn(2, 8, 8, 32) * 3 + 1).astype(np.float32)
    gamma, beta = rs.randn(32).astype(np.float32), rs.randn(32).astype(np.float32)
    scale = rs.randn(2, 32).astype(np.float32) if film else None
    shift = rs.randn(2, 32).astype(np.float32) if film else None
    ref = jax_gn(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                 None if scale is None else jnp.asarray(scale),
                 None if shift is None else jnp.asarray(shift), groups=8, eps=1e-5)
    out = group_norm_film_silu_reference(
        _nchw(x), torch.from_numpy(gamma), torch.from_numpy(beta),
        None if scale is None else torch.from_numpy(scale),
        None if shift is None else torch.from_numpy(shift), groups=8, eps=1e-5,
    )
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=2e-5, rtol=0)


@pytest.mark.parametrize("beta_schedule", ["cosine", "linear"])
def test_schedule_tables_equal_jax(beta_schedule):
    ref = jax_make_schedule(1000, beta_schedule, 0.5, 1.0)
    got = make_schedule(1000, beta_schedule, 0.5, 1.0)
    assert got._fields == ref._fields
    for name in ref._fields:
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("src,dst", [(4, 8), (16, 128), (5, 7), (6, 4)])
def test_nearest_resize_matches_jax(src, dst):
    x = np.random.RandomState(3).randn(2, src, src, 3).astype(np.float32)
    np.testing.assert_array_equal(
        _nhwc(nearest_resize(_nchw(x), dst, dst)), np.asarray(jax_nearest_resize(jnp.asarray(x), dst, dst))
    )
    np.testing.assert_array_equal(
        _nhwc(nearest_upsample_2x(_nchw(x))), np.asarray(jax_up2x(jnp.asarray(x)))
    )
