"""The DDPM UNet backbone in PyTorch, NCHW (port of ``tedm_tpu/models/unet.py``).

Same architecture as the JAX package and the reference lucidrains-style
UNet (models/unet_model.py:246-368): init 7x7 conv; down stages of
[ResnetBlock, ResnetBlock, Residual(PreNorm(LinearAttention)), Downsample];
mid ResnetBlock + full Attention + ResnetBlock; up stages with skip-concat;
final ResnetBlock over cat(x, init residual) + 1x1 conv. 36,245,377
parameters at dim=64, mults (1,2,4,8), channels=1.

Module names follow the reference torch code, so ``state_dict`` keys are
the ones ``tedm_tpu/utils/torch_port.py`` reads (``downs.0.2.fn.fn.to_qkv.weight``,
``ups.0.3.1.weight``, ``mid_attn.fn.norm.g``, ...) and a reference
``best_model.pt`` loads as it is. ``extract_features=True`` also returns the
four up-stage attention outputs, the features of the segmentation heads.

``dtype`` is the compute dtype, with flax's ``dtype=`` semantics module by
module (tedm_tpu/models/unet.py): the parameters stay fp32; every conv and
linear layer casts its input, weight and bias to the compute dtype and
returns it; GroupNorm+FiLM+SiLU and ChanLayerNorm keep fp32 statistics and
return the compute dtype; the mid Attention computes in fp32 and casts
before ``to_out``. The casts are explicit: ``torch.autocast`` keeps norms
and softmax in fp32 and picks its own cast points, which the JAX package
does not.

In fp32 every LinearAttention runs ``kernels.linear_attention`` on the
device its input lies on (the CUDA kernel on the card). In bf16 every
Residual(PreNorm(LinearAttention)) runs as one block,
``kernels.attn_block.prenorm_linear_attention`` (the fused CUDA kernel on
the card), as the JAX package fuses it in bf16. The mid Attention stays
plain PyTorch, as the JAX default runs it outside Pallas.

Three opt-in kernels follow the JAX package's ``use_pallas_*`` switches
(tedm_tpu/models/unet.py:520-537), with the same parameters, so a
``state_dict`` loads either way: ``fused_groupnorm`` runs every
GroupNorm+FiLM+SiLU through ``kernels.groupnorm.fused_group_norm_film_silu``;
``fused_resblock`` runs every ResnetBlock as one call of
``kernels.resblock.fused_resnet_block`` (and then no GroupNorm kernel, as
JAX's ResnetBlock returns before its Blocks); ``flash_attention`` runs the
mid Attention through ``kernels.flash_attention.flash_cosine_attention``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tedm_tpu_torch.kernels.attn_block import prenorm_linear_attention
from tedm_tpu_torch.kernels.flash_attention import flash_cosine_attention
from tedm_tpu_torch.kernels.groupnorm import fused_group_norm_film_silu, group_norm_film_silu_reference
from tedm_tpu_torch.kernels.linear_attention import linear_attention
from tedm_tpu_torch.kernels.resblock import fused_resnet_block
from tedm_tpu_torch.ops.resize import nearest_upsample_2x


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in ``compute_dtype``: input, weight and bias are cast to
    it, and so is the output. The parameters stay fp32."""

    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class Linear(nn.Linear):
    """``nn.Linear`` in ``compute_dtype``, as ``Conv2d``."""

    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class ChanLayerNorm(nn.Module):
    """Channel-wise LayerNorm with gain only, biased variance, eps 1e-5,
    fp32 statistics, output in ``compute_dtype``
    (reference: models/unet_model.py:52-61)."""

    compute_dtype = torch.float32

    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(1, dim, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var, mean = torch.var_mean(xf, dim=1, correction=0, keepdim=True)
        return ((xf - mean) * torch.rsqrt(var + 1e-5) * self.g).to(self.compute_dtype)


class SinusoidalPosEmb(nn.Module):
    """Sinusoidal timestep embedding (reference: models/unet_model.py:76-93)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        freq = torch.exp(
            torch.arange(half, device=t.device, dtype=torch.float32)
            * -(math.log(10000.0) / (half - 1))
        )
        emb = t.float()[:, None] * freq[None, :]
        return torch.cat([emb.sin(), emb.cos()], dim=-1)


class TimeMLP(nn.Sequential):
    """SinusoidalPosEmb -> Linear(4*dim) -> exact GELU -> Linear(4*dim)
    (reference: models/unet_model.py:287-292); keys ``time_mlp.{1,3}``."""

    def __init__(self, dim: int, time_dim: int):
        super().__init__(
            SinusoidalPosEmb(dim), Linear(dim, time_dim), nn.GELU(), Linear(time_dim, time_dim)
        )


class GroupNormFilmSiLU(nn.Module):
    """GroupNorm(groups) with affine ``weight``/``bias`` -> optional FiLM -> SiLU;
    through the GroupNorm kernel when ``fused``."""

    def __init__(self, dim: int, groups: int = 8, fused: bool = False):
        super().__init__()
        self.groups = groups
        self.fused = fused
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x, scale_shift: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        scale = shift = None
        if scale_shift is not None:
            scale, shift = scale_shift
        fn = fused_group_norm_film_silu if self.fused else group_norm_film_silu_reference
        return fn(x, self.weight, self.bias, scale, shift, groups=self.groups, eps=1e-5)


class Block(nn.Module):
    """Conv3x3 -> GroupNorm(8) -> optional FiLM x*(scale+1)+shift -> SiLU
    (reference: models/unet_model.py:119-135)."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8, fused_groupnorm: bool = False):
        super().__init__()
        self.proj = Conv2d(dim, dim_out, 3, padding=1)
        self.norm = GroupNormFilmSiLU(dim_out, groups, fused_groupnorm)

    def forward(self, x, scale_shift=None):
        return self.norm(self.proj(x), scale_shift)


class ResnetBlock(nn.Module):
    """Two Blocks, the first FiLM-conditioned on the time embedding, plus a
    residual 1x1 projection when the width changes
    (reference: models/unet_model.py:138-175). With ``fused_resblock`` the
    whole block is one call of the ResnetBlock kernel on the same
    parameters, its sum in fp32 cast once (tedm_tpu/models/unet.py:207-227)."""

    compute_dtype = torch.float32

    def __init__(
        self, dim: int, dim_out: int, time_emb_dim: Optional[int] = None, groups: int = 8,
        fused_groupnorm: bool = False, fused_resblock: bool = False,
    ):
        super().__init__()
        self.groups = groups
        self.fused = fused_resblock
        self.time_mlp = (
            nn.Sequential(nn.SiLU(), Linear(time_emb_dim, dim_out * 2))
            if time_emb_dim is not None
            else None
        )
        self.block1 = Block(dim, dim_out, groups, fused_groupnorm)
        self.block2 = Block(dim_out, dim_out, groups, fused_groupnorm)
        self.res_conv = Conv2d(dim, dim_out, 1) if dim != dim_out else nn.Identity()

    def forward(self, x, time_emb: Optional[torch.Tensor] = None):
        scale_shift = None
        if self.time_mlp is not None and time_emb is not None:
            scale_shift = self.time_mlp(time_emb).chunk(2, dim=1)  # two (B, C)
        if self.fused:
            (p1, n1), (p2, n2), res = (self.block1.proj, self.block1.norm), (self.block2.proj, self.block2.norm), self.res_conv
            scale, shift = scale_shift if scale_shift is not None else (None, None)
            wres, bres = (res.weight, res.bias) if isinstance(res, Conv2d) else (None, None)
            return fused_resnet_block(
                x.to(self.compute_dtype), p1.weight, p1.bias, n1.weight, n1.bias, scale, shift,
                p2.weight, p2.bias, n2.weight, n2.bias, wres, bres, groups=self.groups,
            )
        h = self.block1(x, scale_shift)
        h = self.block2(h)
        return h + self.res_conv(x)


class LinearAttention(nn.Module):
    """O(N) linear attention over spatial positions, q softmaxed over its
    head dim, k over positions (reference: models/unet_model.py:178-210),
    then to_out = Conv1x1 + ChanLayerNorm."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Sequential(Conv2d(hidden, dim, 1), ChanLayerNorm(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        # 'b (h c) x y -> b h c (x y)': each chunk is a view that is
        # contiguous within a batch element, as the kernel takes it
        q, k, v = (
            t.reshape(b, self.heads, self.dim_head, h * w)
            for t in self.to_qkv(x).chunk(3, dim=1)
        )
        out = linear_attention(q, k, v, self.dim_head ** -0.5)
        return self.to_out(out.reshape(b, -1, h, w).to(x.dtype))


class Attention(nn.Module):
    """Full attention with cosine-similarity logits at fixed scale 16
    (reference: models/unet_model.py:213-241). q and k are l2-normalised over
    the SPATIAL axis, the last axis of the (B, heads, d, N) layout
    (tedm_tpu/models/unet.py:430-435). fp32 math; with ``flash`` through the
    flash kernel on the qkv conv's chunks (output in their dtype)."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, scale: float = 16.0, flash: bool = False):
        super().__init__()
        self.heads, self.dim_head, self.scale = heads, dim_head, scale
        self.flash = flash
        hidden = heads * dim_head
        self.to_qkv = Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = Conv2d(hidden, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        # 'b (h c) x y -> b h c (x y)': views, contiguous within a batch element
        q, k, v = (t.reshape(b, self.heads, self.dim_head, h * w) for t in self.to_qkv(x).chunk(3, dim=1))
        if self.flash:
            out = flash_cosine_attention(q, k, v, self.scale)
        else:
            q = F.normalize(q.float(), dim=-1, eps=1e-12)
            k = F.normalize(k.float(), dim=-1, eps=1e-12)
            attn = (torch.einsum("bhdi,bhdj->bhij", q, k) * self.scale).softmax(dim=-1)
            out = torch.einsum("bhij,bhdj->bhdi", attn, v.float())
        return self.to_out(out.reshape(b, -1, h, w).to(x.dtype))


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = ChanLayerNorm(dim)
        self.fn = fn

    def forward(self, x):
        return self.fn(self.norm(x))


class PreNormAttn(nn.Module):
    """Residual(PreNorm(attn)) as used in every stage
    (reference: models/unet_model.py:29-36, 64-73); keys ``fn.norm.g``, ``fn.fn.*``.

    With a LinearAttention in bf16 the whole block is one call of the fused
    block on x, the (B, C, H*W) view (tedm_tpu/models/unet.py:460-475), with
    the same parameters."""

    compute_dtype = torch.float32

    def __init__(self, dim: int, attn: nn.Module):
        super().__init__()
        self.fn = PreNorm(dim, attn)

    def forward(self, x):
        attn = self.fn.fn
        if isinstance(attn, LinearAttention) and self.compute_dtype == torch.bfloat16:
            b, c, h, w = x.shape
            to_out, out_norm = attn.to_out
            y = prenorm_linear_attention(
                x.reshape(b, c, h * w), self.fn.norm.g, attn.to_qkv.weight,
                to_out.weight, to_out.bias, out_norm.g,
            )
            return y.reshape(b, c, h, w)
        return self.fn(x) + x


def Downsample(dim: int, dim_out: int) -> nn.Conv2d:
    """Conv 4x4, stride 2, pad 1 (reference: models/unet_model.py:47-49)."""
    return Conv2d(dim, dim_out, 4, stride=2, padding=1)


class NearestUpsample2x(nn.Module):
    def forward(self, x):
        return nearest_upsample_2x(x)


class Upsample(nn.Sequential):
    """Nearest 2x + conv 3x3 (reference: models/unet_model.py:39-44); key ``.1``."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__(NearestUpsample2x(), Conv2d(dim, dim_out, 3, padding=1))


class Unet(nn.Module):
    """The full backbone, NCHW. See the module docstring."""

    def __init__(
        self,
        dim: int = 64,
        dim_mults: Sequence[int] = (1, 2, 4, 8),
        channels: int = 1,
        resnet_block_groups: int = 8,
        in_channels: Optional[int] = None,
        dtype: torch.dtype = torch.float32,
        fused_groupnorm: bool = False,
        fused_resblock: bool = False,
        flash_attention: bool = False,
    ):
        """``channels`` is the width of the output (and by default of the
        input); ``in_channels`` widens the input for the conditional modes,
        whose input is the noised x concatenated with the condition.
        ``dtype`` is the compute dtype (bf16 under ``--mixed_precision``).
        The last three switch on the opt-in kernels (module docstring)."""
        super().__init__()
        dims = [dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        time_dim = dim * 4
        g = resnet_block_groups
        kernels = dict(fused_groupnorm=fused_groupnorm, fused_resblock=fused_resblock)

        self.init_conv = Conv2d(in_channels or channels, dim, 7, padding=3)
        self.time_mlp = TimeMLP(dim, time_dim)

        self.downs = nn.ModuleList()
        for ind, (dim_in, dim_out) in enumerate(in_out):
            is_last = ind == len(in_out) - 1
            self.downs.append(nn.ModuleList([
                ResnetBlock(dim_in, dim_in, time_dim, g, **kernels),
                ResnetBlock(dim_in, dim_in, time_dim, g, **kernels),
                PreNormAttn(dim_in, LinearAttention(dim_in)),
                Downsample(dim_in, dim_out) if not is_last else Conv2d(dim_in, dim_out, 3, padding=1),
            ]))

        mid_dim = dims[-1]
        self.mid_block1 = ResnetBlock(mid_dim, mid_dim, time_dim, g, **kernels)
        self.mid_attn = PreNormAttn(mid_dim, Attention(mid_dim, flash=flash_attention))
        self.mid_block2 = ResnetBlock(mid_dim, mid_dim, time_dim, g, **kernels)

        self.ups = nn.ModuleList()
        for ind, (dim_in, dim_out) in enumerate(reversed(in_out)):
            is_last = ind == len(in_out) - 1
            self.ups.append(nn.ModuleList([
                ResnetBlock(dim_out + dim_in, dim_out, time_dim, g, **kernels),
                ResnetBlock(dim_out + dim_in, dim_out, time_dim, g, **kernels),
                PreNormAttn(dim_out, LinearAttention(dim_out)),
                Upsample(dim_out, dim_in) if not is_last else Conv2d(dim_out, dim_in, 3, padding=1),
            ]))

        self.final_res_block = ResnetBlock(dim * 2, dim, time_dim, g, **kernels)
        self.final_conv = Conv2d(dim, channels, 1)

        self.compute_dtype = dtype
        for m in self.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = dtype

    def forward(
        self,
        x: torch.Tensor,
        time: Optional[torch.Tensor] = None,
        *,
        extract_features: bool = False,
    ):
        """x (B, C, H, W), time (B,) integer steps or None. With
        ``extract_features`` returns (out, [the 4 up-stage attention outputs]),
        all in the compute dtype."""
        temb = self.time_mlp(time) if time is not None else None
        x = self.init_conv(x)
        r = x
        hs: List[torch.Tensor] = []
        for block1, block2, attn, downsample in self.downs:
            x = block1(x, temb)
            hs.append(x)
            x = attn(block2(x, temb))
            hs.append(x)
            x = downsample(x)

        x = self.mid_block2(self.mid_attn(self.mid_block1(x, temb)), temb)

        feats: List[torch.Tensor] = []
        for block1, block2, attn, upsample in self.ups:
            x = block1(torch.cat([x, hs.pop()], dim=1), temb)
            x = block2(torch.cat([x, hs.pop()], dim=1), temb)
            x = attn(x)
            feats.append(x)
            x = upsample(x)

        out = self.final_conv(self.final_res_block(torch.cat([x, r], dim=1), temb))
        if extract_features:
            return out, feats
        return out


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
