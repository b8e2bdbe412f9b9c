"""SimCLR-style augmentations on NCHW tensors (port of ``tedm_tpu/ops/augment.py``).

Reference semantics (trainers/train_global_cl.py:23-33 and
trainers/utils.py:179-228 ``crop_batch``): a random crop per sample, its
origin in [0, 32)^2 and its box in [96, img - origin), resized back to the
image size (bilinear), labels rounded after the resize; a brightness shift
in [-0.3, 0.3] and a contrast scale in [0.7, 1.3], as
``(x + brightness) * contrast``.

The crop-and-resize is the JAX package's affine resample,
``jax.image.scale_and_translate(..., "bilinear", antialias=False)`` with
scale s = img / box and translation -origin * s: output pixel i reads the
source coordinate (i + 0.5) / s + origin - 0.5 with two linear taps, each
index clamped to the edge, and reads 0 where the coordinate lies outside
[-0.5, img - 0.5] (only a box wider than the image reaches there). Box
sizes are continuous, as JAX draws them (its documented deviation from the
reference's integer boxes, tedm_tpu/ops/augment.py:52-59).

The draws are arguments (``crop_draws`` and the brightness and contrast
rows), or come from a ``torch.Generator`` on the images' device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def crop_draws(
    b: int, h: int, w: int, generator: torch.Generator, box_min: int = 96, origin_max: int = 32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(origin, box), each (B, 2) fp32 rows of (H axis, W axis): integer
    origins in [0, origin_max), boxes box_min + u * (size - origin - box_min)
    with u uniform in [0, 1), as JAX draws them (tedm_tpu/ops/augment.py:60-67)."""
    dev = generator.device
    ox, oy = (torch.randint(0, origin_max, (b,), generator=generator, device=dev).float() for _ in range(2))
    ux, uy = (torch.rand(b, generator=generator, device=dev) for _ in range(2))
    bx = box_min + ux * (h - ox - box_min)
    by = box_min + uy * (w - oy - box_min)
    return torch.stack([ox, oy], dim=1), torch.stack([bx, by], dim=1)


def _resample_axis(x: torch.Tensor, dim: int, origin: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Bilinear resample of ``x`` along ``dim`` (2 or 3) to the same size:
    per sample, the crop [origin, origin + box) stretched over the axis, in
    the fp32 order of JAX's ``compute_weight_mat``."""
    n = x.shape[dim]
    scale = n / box  # (B,)
    inv = 1.0 / scale
    i = torch.arange(n, device=x.device, dtype=torch.float32)
    f = (i[None] + 0.5) * inv[:, None] - (-origin * scale)[:, None] * inv[:, None] - 0.5  # (B, n)
    lo = torch.floor(f)
    frac = f - lo
    inside = ((f >= -0.5) & (f <= n - 0.5)).float()
    lo = lo.long()
    shape = [x.shape[0], 1, 1, 1]
    shape[dim] = n
    idx0, idx1 = (t.clamp(0, n - 1).reshape(shape).expand_as(x) for t in (lo, lo + 1))
    w1 = (frac * inside).reshape(shape)
    w0 = ((1.0 - frac) * inside).reshape(shape)
    return w0 * x.gather(dim, idx0) + w1 * x.gather(dim, idx1)


def crop_batch(
    imgs: torch.Tensor,
    labels: Optional[torch.Tensor] = None,
    origin: Optional[torch.Tensor] = None,
    box: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    box_min: int = 96,
    origin_max: int = 32,
):
    """A random crop resized back to full size, per sample, of (B, C, H, W)
    ``imgs``; with ``labels``, the same geometry on them, rounded (half to
    even, as ``jnp.round``), and returns (imgs, labels). ``origin`` and
    ``box`` are ``crop_draws``'s, drawn from ``generator`` when not given."""
    b, _, h, w = imgs.shape
    if origin is None:
        origin, box = crop_draws(b, h, w, generator, box_min, origin_max)

    def crop(x):
        x = _resample_axis(x.float(), 2, origin[:, 0], box[:, 0])
        return _resample_axis(x, 3, origin[:, 1], box[:, 1])

    out = crop(imgs)
    if labels is None:
        return out
    return out, torch.round(crop(labels))


def brightness_contrast(
    x: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    brightness: Optional[torch.Tensor] = None,
    contrast: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(x + U[-0.3, 0.3]) * U[0.7, 1.3], per sample (reference:
    train_global_cl.py:25-28); the (B, 1, 1, 1) rows drawn from
    ``generator`` when not given."""
    b = x.shape[0]
    if brightness is None:
        brightness = torch.rand(b, 1, 1, 1, generator=generator, device=x.device) * 0.6 - 0.3
        contrast = torch.rand(b, 1, 1, 1, generator=generator, device=x.device) * 0.6 + 0.7
    return (x + brightness) * contrast


def augment(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    return brightness_contrast(crop_batch(x, generator=generator), generator)


def augment_and_concat(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Two independent views stacked on the batch axis: (2B, C, H, W)
    (reference: train_global_cl.py:30-33)."""
    return torch.cat([augment(x, generator), augment(x, generator)], dim=0)
