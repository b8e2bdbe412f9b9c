"""Contrastive pretraining models and losses (port of
``tedm_tpu/models/contrastive.py``; the Chaitanya et al. baselines).

Reference: models/global_local_cl.py and the losses of
trainers/train_global_cl.py:36-44 and trainers/train_local_cl.py:36-77.

``GlobalCL`` and ``LocalCL`` hold the port's ``Unet`` as ``unet``, pruned to
the modules they run, which are the parameters the JAX models initialise
(flax initialises lazily): no time MLP, no ResnetBlock ``time_mlp``, no
decoder stage past the ones run, no final block. A CL checkpoint's ``unet.*``
keys are therefore exactly what a finetune copies into a full ``Unet``
(``tedm_tpu/trainers/contrastive.py`` ``_deep_merge``), by
``load_state_dict(strict=False)``. Both compute in fp32, as the JAX
trainers build them (no ``dtype``). The heads' convs and denses are the
UNet's ``Conv2d`` and ``Linear``, which take a TP plan as the UNet's do.

Under spatial parallelism (``parallel/spatial.py``) the input is this
rank's rows of the views and the UNet runs on them; both models return
whole maps, gathered along H (``spatial.gather_h``): GlobalCL's head
flattens the whole mid map, and LocalCL's 3x3 boxes, which can lie on any
rank or straddle two, are cut from the whole decoder map. LocalCL's g2 runs
on this rank's rows before the gather, its BatchNorm summing over the data
x spatial ranks (``flax_batch_norm``).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tedm_tpu_torch.models.segmentation import flax_batch_norm
from tedm_tpu_torch.models.unet import Conv2d, Linear, ResnetBlock, Unet
from tedm_tpu_torch.parallel import spatial


def pruned_unet(n_up_stages: int, **unet_kw) -> Unet:
    """A ``Unet`` without the modules a CL model never runs: its time MLPs,
    the decoder past ``ups[:n_up_stages]`` and the final block."""
    unet = Unet(**unet_kw)
    unet.time_mlp = None
    for m in unet.modules():
        if isinstance(m, ResnetBlock):
            m.time_mlp = None
    unet.ups = unet.ups[:n_up_stages]
    unet.final_res_block = unet.final_conv = None
    return unet


class GlobalCL(nn.Module):
    """UNet encoder + mid + the global head g1: flatten -> Linear(1024, no
    bias) -> ReLU -> Linear(128, no bias) (reference:
    models/global_local_cl.py:8-50). The flatten is NCHW's, (C, H, W);
    ``utils.convert`` permutes the JAX kernel's NHWC rows to it. Under a
    spatial plan the head takes the mid map gathered along H."""

    def __init__(
        self,
        img_size: int = 128,
        dim: int = 64,
        dim_mults: Sequence[int] = (1, 2, 4, 8),
        channels: int = 1,
        g_emb: int = 1024,
        g_out: int = 128,
        **kernels,
    ):
        super().__init__()
        self.unet = pruned_unet(0, dim=dim, dim_mults=dim_mults, channels=channels, **kernels)
        side = img_size // 2 ** (len(dim_mults) - 1)
        self.g1_fc1 = Linear(dim * dim_mults[-1] * side * side, g_emb, bias=False)
        self.g1_fc2 = Linear(g_emb, g_out, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, _, _ = self.unet.encode(x, None)
        x = spatial.gather_h(self.unet.run_mid(x, None))
        return self.g1_fc2(F.relu(self.g1_fc1(x.reshape(x.shape[0], -1))))


class LocalCL(nn.Module):
    """UNet encoder + mid + the first ``l`` decoder stages + the local head
    g2: Conv1x1(no bias) -> ReLU -> BatchNorm -> Conv1x1(no bias) (reference:
    models/global_local_cl.py:53-107). The BatchNorm runs as flax's
    (``flax_batch_norm``: momentum 0.9, the biased batch variance) in train
    mode, on its running statistics in eval mode. The output is the whole
    map: under a spatial plan g2 runs on this rank's rows, then the map is
    gathered along H."""

    def __init__(
        self,
        img_size: int = 128,
        dim: int = 64,
        dim_mults: Sequence[int] = (1, 2, 4, 8),
        channels: int = 1,
        l: int = 2,
        **kernels,
    ):
        super().__init__()
        self.l = l
        self.unet = pruned_unet(l, dim=dim, dim_mults=dim_mults, channels=channels, **kernels)
        dims = [dim] + [dim * m for m in dim_mults]
        mid_dim = dims[-l - 1]
        self.g2_conv1 = Conv2d(mid_dim, mid_dim, 1, bias=False)
        self.g2_bn = nn.BatchNorm2d(mid_dim, eps=1e-5)
        self.g2_conv2 = Conv2d(mid_dim, mid_dim, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, r, hs = self.unet.encode(x, None)
        x = self.unet.run_mid(x, None)
        x, _ = self.unet.decode(x, r, hs, None, n_stages=self.l)
        return spatial.gather_h(self.g2_conv2(flax_batch_norm(self.g2_bn, F.relu(self.g2_conv1(x)))))


def global_nt_xent(features: torch.Tensor, batch_size: int, tau: float) -> torch.Tensor:
    """SimCLR NT-Xent as the reference computes it
    (trainers/train_global_cl.py:36-44): features (2B, D), the first B view 1."""
    f = features.float()
    f = f / f.norm(dim=1, keepdim=True)
    sim = torch.exp(f @ f.T / tau)
    b = batch_size
    pos1 = torch.diagonal(sim[:b, b:])
    neg1 = sim[:b].sum(-1) - torch.diagonal(sim[:b, :b])
    pos2 = torch.diagonal(sim[b:, :b])
    neg2 = sim[b:].sum(-1) - torch.diagonal(sim[b:, b:])
    return (-torch.log(pos1 / neg1).mean() - torch.log(pos2 / neg2).mean()) / 2


def _local_masks_np(batch_size: int, n_regions: int, diag_offset: int):
    """The positive and negative diagonal masks and the rows with a positive
    of one diagonal offset (reference: trainers/train_local_cl.py:37-57)."""
    n = batch_size * n_regions * 2
    half = batch_size * n_regions

    def diag_ones(k):
        return np.eye(n, k=k, dtype=bool)

    pos = diag_ones(-half + diag_offset) | diag_ones(half + diag_offset)
    pos[:half, :half] = False
    pos[half:, half:] = False
    neg = np.zeros((n, n), bool)
    for region in range(-2 * n_regions + 1, 2 * n_regions):
        neg |= diag_ones(region * batch_size + diag_offset)
    neg[:half, :half] = False
    neg[half:, half:] = False
    return pos, neg, pos.any(axis=1)


@functools.lru_cache(maxsize=4)
def local_masks(batch_size: int, n_regions: int, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """The masks of all 2B - 1 diagonal offsets -B+1 .. B-1, stacked, as
    bool tensors on ``device``: pos and neg (2B-1, n, n), rows (2B-1, n),
    n = 2 * B * n_regions. Built once per (batch, regions, device)."""
    masks = [_local_masks_np(batch_size, n_regions, d) for d in range(-batch_size + 1, batch_size)]
    return tuple(torch.from_numpy(np.stack(m)).to(device) for m in zip(*masks))


def region_centres(
    h: int, w: int, generator: torch.Generator, n_regions: int = 20
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_regions`` distinct centres on each axis, away from the border, as
    JAX draws them (a permutation's head, +1; contrastive.py:163-166)."""
    cx = torch.randperm(h - 2, generator=generator, device=generator.device)[:n_regions] + 1
    cy = torch.randperm(w - 2, generator=generator, device=generator.device)[:n_regions] + 1
    return cx, cy


def region_rows(
    features: torch.Tensor, batch_size: int, centres: Tuple[torch.Tensor, torch.Tensor], n_regions: int = 20
) -> torch.Tensor:
    """The unit-norm 3x3 patch of each region centre of each image, laid out
    (aug, region, image, C*9): the rows of ``local_region_loss`` before its
    '(aug r b)' flatten. ``features`` is NCHW (2B, C, H, W), view 1 first."""
    f = features.float()
    cx, cy = centres
    offs = torch.arange(-1, 2, device=f.device)
    rows, cols = (cx.to(f.device)[:, None] + offs), (cy.to(f.device)[:, None] + offs)  # (R, 3)
    # (2B, C, R, 3, 3): region r is rows[r] x cols[r]
    regions = f[:, :, rows[:, :, None], cols[:, None, :]]
    # '(aug b) c r h w -> aug r b (c h w)'
    regions = regions.permute(0, 2, 1, 3, 4).reshape(2, batch_size, n_regions, -1).transpose(1, 2)
    return regions / regions.norm(dim=3, keepdim=True)


def region_loss(regions: torch.Tensor, batch_size: int, tau: float, n_regions: int = 20) -> torch.Tensor:
    """The region-contrastive InfoNCE of the (2 * n_regions * batch_size, D)
    unit rows laid out '(aug r b)' (reference: trainers/train_local_cl.py:60-77),
    the reference's masked-exp quirk (a masked-out logit adds exp(0) = 1 to
    the negative sum) kept."""
    logits = regions @ regions.T / tau
    pos, neg, has_pos = local_masks(batch_size, n_regions, regions.device)
    pos_logits = (logits * pos).sum(-1)  # (2B-1, n)
    neg_logits = torch.log(torch.exp(logits * neg).sum(-1))
    per_offset = ((neg_logits - pos_logits) * has_pos).sum(-1) / has_pos.sum(-1)
    return per_offset.sum()


def local_region_loss(
    features: torch.Tensor,
    batch_size: int,
    tau: float,
    n_regions: int = 20,
    centres: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Region-contrastive InfoNCE over ``n_regions`` 3x3 patches (reference:
    trainers/train_local_cl.py:60-77). ``features`` is NCHW (2B, C, H, W);
    the same centres ``(cx, cy)`` serve every image, drawn from
    ``generator`` when not given."""
    _, _, hh, ww = features.shape
    centres = centres if centres is not None else region_centres(hh, ww, generator, n_regions)
    rows = region_rows(features, batch_size, centres, n_regions)
    return region_loss(rows.reshape(2 * n_regions * batch_size, -1), batch_size, tau, n_regions)
