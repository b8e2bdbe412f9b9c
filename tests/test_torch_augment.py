"""The port's augmentations (``tedm_tpu_torch/ops/augment.py``) against
``tedm_tpu/ops/augment.py``, on the CPU.

``crop_batch`` with JAX's own draws, rebuilt from the same key, on unit
normal images (batch 2): the images to 1e-4 absolute; the labels, rounded
after the resample, identical except where JAX's resampled value lies
within 1e-4 of 0.5. Three regimes: the 128^2 default (box in [96, 128 -
origin), scale >= 1), a 32^2 image with a box of 16 and origins below 8,
and a 32^2 image under the defaults, where the box exceeds the image and
part of the output reads 0. ``brightness_contrast`` to 1e-6 with JAX's
draws. Also: the draws' ranges, and the views of ``augment_and_concat``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tedm_tpu.ops import augment as ja
from tedm_tpu_torch.ops import augment as ta

torch.set_num_threads(1)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def jax_crop_draws(key, b, h, box_min, origin_max):
    """JAX's crop_batch draws (tedm_tpu/ops/augment.py:60-67) as the port's
    (origin, box)."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    ox = jax.random.randint(k1, (b,), 0, origin_max).astype(jnp.float32)
    oy = jax.random.randint(k2, (b,), 0, origin_max).astype(jnp.float32)
    ux, uy = jax.random.uniform(k3, (b,)), jax.random.uniform(k4, (b,))
    bx = box_min + ux * (h - ox - box_min)
    by = box_min + uy * (h - oy - box_min)
    return torch.from_numpy(np.stack([ox, oy], 1)), torch.from_numpy(np.stack([bx, by], 1))


@pytest.mark.parametrize("size,box_min,origin_max", [(128, 96, 32), (32, 16, 8), (32, 96, 32)])
@pytest.mark.parametrize("seed", [0, 1])
def test_crop_batch_matches_jax(size, box_min, origin_max, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(2, size, size, 1).astype(np.float32)
    lab = (rs.rand(2, size, size, 1) > 0.5).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want_x, want_lab = ja.crop_batch(key, jnp.asarray(x), jnp.asarray(lab), box_min=box_min, origin_max=origin_max)
    unrounded = ja.crop_batch(key, jnp.asarray(lab), box_min=box_min, origin_max=origin_max)
    origin, box = jax_crop_draws(key, 2, size, box_min, origin_max)
    got_x, got_lab = ta.crop_batch(nchw(x), nchw(lab), origin=origin, box=box)
    assert got_x.shape == (2, 1, size, size)
    np.testing.assert_allclose(got_x.numpy(), nchw(want_x).numpy(), atol=1e-4, rtol=0)
    ties = np.abs(nchw(unrounded).numpy() - 0.5) <= 1e-4
    differ = got_lab.numpy() != nchw(want_lab).numpy()
    assert not (differ & ~ties).any()
    assert set(np.unique(got_lab.numpy())) <= {0.0, 1.0}
    # the image moved: a crop of a random image is not the image
    assert np.abs(got_x.numpy() - nchw(x).numpy()).max() > 0.5
    if box_min > size:  # the box outruns the image: JAX reads 0 there, and so must the port
        assert (nchw(want_x).numpy() == 0).any() and (got_x.numpy() == 0).any()


def test_brightness_contrast_matches_jax():
    x = np.random.RandomState(2).randn(3, 8, 8, 1).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(ja.brightness_contrast(key, jnp.asarray(x)))
    k1, k2 = jax.random.split(key)
    brightness = np.asarray(jax.random.uniform(k1, (3, 1, 1, 1))) * 0.6 - 0.3
    contrast = np.asarray(jax.random.uniform(k2, (3, 1, 1, 1))) * 0.6 + 0.7
    got = ta.brightness_contrast(nchw(x), brightness=torch.from_numpy(brightness),
                                 contrast=torch.from_numpy(contrast))
    np.testing.assert_allclose(got.numpy(), nchw(want).numpy(), atol=1e-6, rtol=0)


def test_draws_and_views_from_a_generator():
    g = torch.Generator().manual_seed(0)
    origin, box = ta.crop_draws(64, 128, 128, g)
    assert origin.dtype == torch.float32 and (origin == origin.round()).all()
    assert origin.min() >= 0 and origin.max() <= 31
    assert (box >= 96 - 1e-4).all() and (box <= 128 - origin + 1e-4).all()
    x = torch.randn(4, 1, 32, 32, generator=g)
    views = ta.augment_and_concat(x, torch.Generator().manual_seed(1))
    again = ta.augment_and_concat(x, torch.Generator().manual_seed(1))
    assert views.shape == (8, 1, 32, 32) and torch.equal(views, again)
    assert not torch.allclose(views[:4], views[4:])  # two independent views
    b = ta.brightness_contrast(torch.zeros(256, 1, 1, 1), torch.Generator().manual_seed(2))
    # (0 + U[-.3, .3]) * U[.7, 1.3]
    assert b.abs().max() <= 0.39 and b.std() > 0.05
