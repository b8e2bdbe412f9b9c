"""The frozen counts: the whole model's operations against torch's FLOP
counter on the plain UNet and head, and the kernels' bounds at the default
shapes as they stood when the benchmark was defined."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.counts import kernels as K
from portbench.counts import model as M
from portbench.reference.unet import Unet


def flops(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("dim,mults,size", [(16, (1, 2), 16), (16, (1, 2, 4, 8), 32), (8, (1, 2, 4), 32)])
def test_unet_operations_equal_torchs_flop_counter(dim, mults, size):
    torch.manual_seed(0)
    unet = Unet(dim, mults)
    x, t = torch.randn(2, 1, size, size), torch.tensor([3, 700])
    assert flops(lambda: unet(x, t)) == 2 * M.unet_forward(dim, mults, size)
    assert flops(lambda: unet(x, t).sum().backward()) == 2 * M.unet_train(dim, mults, size)


def test_the_ports_plain_unet_and_head_count_alike():
    from tedm_tpu_torch.models.segmentation import PixelClassifier
    from tedm_tpu_torch.models.unet import Unet as PortUnet

    dim, mults, size = 16, (1, 2, 4, 8), 32
    unet = PortUnet(dim=dim, dim_mults=mults, use_pallas=False)
    x, t = torch.randn(1, 1, size, size), torch.tensor([5])
    assert flops(lambda: unet(x, t)) == M.unet_forward(dim, mults, size)
    stages = [dim * m for m in reversed(mults)]
    sides = [size >> i for i in reversed(range(len(mults)))]
    head = PixelClassifier(stage_channels=stages, img_size=size, shared=True).eval()
    feats = [torch.randn(1, c, s, s) for c, s in zip(stages, sides)]
    assert flops(lambda: head(feats)) == M.head_forward(stages, sides, size)


def test_published_sizes():
    assert sum(p.numel() for p in Unet().parameters()) == 36_245_377
    assert M.unet_forward(64, (1, 2, 4, 8), 128) == 58_972_012_544
    assert M.unet_train(64, (1, 2, 4, 8), 128) == 176_813_244_416


@pytest.mark.parametrize("bf16,flags,backward,batch,want", [
    (False, {}, True, 16, {"linear_attention": 0.4257, "linear_attention_backward": 0.7450}),
    (False, {}, False, 8, {"linear_attention": 0.2128}),
    (True, {"use_pallas_resblock": True, "use_pallas_flash": True}, False, 8,
     {"prenorm_linear_attention": 0.0355, "fused_resnet_block": 0.3583, "flash_cosine_attention": 0.0006}),
    (False, {"use_pallas_groupnorm": True}, False, 8, {"linear_attention": 0.2128, "fused_group_norm_film_silu": 0.3155}),
])
def test_kernel_bounds_at_the_default_shapes(bf16, flags, backward, batch, want):
    got = K.unit_bounds(64, (1, 2, 4, 8), 128, batch, bf16, flags, backward)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=5e-5)
