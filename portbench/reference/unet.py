"""The plain reference of the DDPM UNet: fp32 PyTorch, no kernels.

The lucidrains-style UNet of mmr12/TEDM (models/unet_model.py): init 7x7
conv; down stages of [ResnetBlock, ResnetBlock, Residual(PreNorm(
LinearAttention)), Downsample]; mid ResnetBlock, Residual(PreNorm(cosine
Attention at scale 16)), ResnetBlock; up stages on the skips; a final
ResnetBlock over cat(x, the init conv's output) and a 1x1 conv. Module names
are the reference torch code's, so the same ``state_dict`` loads here and
into the program. ``forward(x, t, features=True)`` also returns the four
up-stage attention outputs, the features of the segmentation heads.

Every product (convolution, linear layer, attention contraction) takes its
operands through the model's ``rounding`` (``precision.py``), none by
default: the control sets one.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import precision


class Rounded:
    """A module whose products round their operands by ``rounding``."""

    rounding: precision.Rounding = None


class Conv2d(nn.Conv2d, Rounded):
    def forward(self, x):
        x, w = precision.apply(self.rounding, x, self.weight)
        return F.conv2d(x, w, self.bias, self.stride, self.padding)


class Linear(nn.Linear, Rounded):
    def forward(self, x):
        x, w = precision.apply(self.rounding, x, self.weight)
        return F.linear(x, w, self.bias)


class ChanLayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(1, dim, 1, 1))

    def forward(self, x):
        var = x.var(dim=1, unbiased=False, keepdim=True)
        return (x - x.mean(dim=1, keepdim=True)) / torch.sqrt(var + 1e-5) * self.g


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t):
        half = self.dim // 2
        freq = torch.exp(torch.arange(half, device=t.device) * -(math.log(10000.0) / (half - 1)))
        emb = t.float()[:, None] * freq[None, :]
        return torch.cat([emb.sin(), emb.cos()], dim=-1)


class GroupNorm(nn.Module):
    """GroupNorm(groups) with its affine, then FiLM x * (scale + 1) + shift,
    then SiLU (keys ``weight``, ``bias``)."""

    def __init__(self, dim: int, groups: int):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x, scale_shift=None):
        x = F.group_norm(x, self.groups, self.weight, self.bias, eps=1e-5)
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale[:, :, None, None] + 1) + shift[:, :, None, None]
        return F.silu(x)


class Block(nn.Module):
    def __init__(self, dim: int, dim_out: int, groups: int):
        super().__init__()
        self.proj = Conv2d(dim, dim_out, 3, padding=1)
        self.norm = GroupNorm(dim_out, groups)

    def forward(self, x, scale_shift=None):
        return self.norm(self.proj(x), scale_shift)


class ResnetBlock(nn.Module):
    def __init__(self, dim: int, dim_out: int, time_dim: int, groups: int):
        super().__init__()
        self.time_mlp = nn.Sequential(nn.SiLU(), Linear(time_dim, dim_out * 2))
        self.block1 = Block(dim, dim_out, groups)
        self.block2 = Block(dim_out, dim_out, groups)
        self.res_conv = Conv2d(dim, dim_out, 1) if dim != dim_out else nn.Identity()

    def forward(self, x, temb):
        scale_shift = self.time_mlp(temb).chunk(2, dim=1)
        return self.block2(self.block1(x, scale_shift)) + self.res_conv(x)


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, c, h, w = t.shape
    return t.reshape(b, heads, c // heads, h * w)


class LinearAttention(nn.Module, Rounded):
    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.scale = heads, dim_head ** -0.5
        hidden = heads * dim_head
        self.to_qkv = Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Sequential(Conv2d(hidden, dim, 1), ChanLayerNorm(dim))

    def forward(self, x):
        b, _, h, w = x.shape
        q, k, v = (_heads(t, self.heads) for t in self.to_qkv(x).chunk(3, dim=1))
        q = q.softmax(dim=2) * self.scale
        k = k.softmax(dim=3)
        v = v / (h * w)
        k, v = precision.apply(self.rounding, k, v)
        context = torch.einsum("bhdn,bhen->bhde", k, v)
        context, q = precision.apply(self.rounding, context, q)
        out = torch.einsum("bhde,bhdn->bhen", context, q)
        return self.to_out(out.reshape(b, -1, h, w))


class Attention(nn.Module, Rounded):
    """Attention on q and k l2-normalised over the pixels, logits at scale 16."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, scale: float = 16.0):
        super().__init__()
        self.heads, self.scale = heads, scale
        hidden = heads * dim_head
        self.to_qkv = Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = Conv2d(hidden, dim, 1)

    def forward(self, x):
        b, _, h, w = x.shape
        q, k, v = (_heads(t, self.heads) for t in self.to_qkv(x).chunk(3, dim=1))
        q, k = F.normalize(q, dim=-1), F.normalize(k, dim=-1)
        q, k = precision.apply(self.rounding, q, k)
        attn = (torch.einsum("bhdi,bhdj->bhij", q, k) * self.scale).softmax(dim=-1)
        attn, v = precision.apply(self.rounding, attn, v)
        out = torch.einsum("bhij,bhdj->bhdi", attn, v)
        return self.to_out(out.reshape(b, -1, h, w))


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = ChanLayerNorm(dim)
        self.fn = fn

    def forward(self, x):
        return self.fn(self.norm(x))


class Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x) + x


class Upsample(nn.Sequential):
    def __init__(self, dim: int, dim_out: int):
        super().__init__(nn.Upsample(scale_factor=2, mode="nearest"), Conv2d(dim, dim_out, 3, padding=1))


class Unet(nn.Module):
    def __init__(self, dim: int = 64, dim_mults: Sequence[int] = (1, 2, 4, 8), channels: int = 1,
                 groups: int = 8):
        super().__init__()
        dims = [dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        time_dim = dim * 4
        self.init_conv = Conv2d(channels, dim, 7, padding=3)
        self.time_mlp = nn.Sequential(SinusoidalPosEmb(dim), Linear(dim, time_dim), nn.GELU(),
                                      Linear(time_dim, time_dim))
        self.downs = nn.ModuleList()
        for i, (d_in, d_out) in enumerate(in_out):
            last = i == len(in_out) - 1
            self.downs.append(nn.ModuleList([
                ResnetBlock(d_in, d_in, time_dim, groups),
                ResnetBlock(d_in, d_in, time_dim, groups),
                Residual(PreNorm(d_in, LinearAttention(d_in))),
                Conv2d(d_in, d_out, 3, padding=1) if last else Conv2d(d_in, d_out, 4, stride=2, padding=1),
            ]))
        mid = dims[-1]
        self.mid_block1 = ResnetBlock(mid, mid, time_dim, groups)
        self.mid_attn = Residual(PreNorm(mid, Attention(mid)))
        self.mid_block2 = ResnetBlock(mid, mid, time_dim, groups)
        self.ups = nn.ModuleList()
        for i, (d_in, d_out) in enumerate(reversed(in_out)):
            last = i == len(in_out) - 1
            self.ups.append(nn.ModuleList([
                ResnetBlock(d_out + d_in, d_out, time_dim, groups),
                ResnetBlock(d_out + d_in, d_out, time_dim, groups),
                Residual(PreNorm(d_out, LinearAttention(d_out))),
                Conv2d(d_out, d_in, 3, padding=1) if last else Upsample(d_out, d_in),
            ]))
        self.final_res_block = ResnetBlock(dim * 2, dim, time_dim, groups)
        self.final_conv = Conv2d(dim, channels, 1)

    def forward(self, x, t, features: bool = False):
        temb = self.time_mlp(t)
        x = self.init_conv(x)
        r = x
        hs: List[torch.Tensor] = []
        for block1, block2, attn, down in self.downs:
            x = block1(x, temb)
            hs.append(x)
            x = attn(block2(x, temb))
            hs.append(x)
            x = down(x)
        x = self.mid_block2(self.mid_attn(self.mid_block1(x, temb)), temb)
        feats: List[torch.Tensor] = []
        for block1, block2, attn, up in self.ups:
            x = block1(torch.cat([x, hs.pop()], dim=1), temb)
            x = attn(block2(torch.cat([x, hs.pop()], dim=1), temb))
            feats.append(x)
            x = up(x)
        out = self.final_conv(self.final_res_block(torch.cat([x, r], dim=1), temb))
        return (out, feats) if features else out


def set_rounding(model: nn.Module, rounding: precision.Rounding) -> nn.Module:
    """Every product of ``model`` on operands rounded by ``rounding``."""
    for m in model.modules():
        if isinstance(m, Rounded):
            m.rounding = rounding
    return model
