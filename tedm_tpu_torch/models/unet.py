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
``forward`` is ``encode``, ``run_mid``, ``decode`` and ``final`` in turn
(tedm_tpu/models/unet.py:630-681); the contrastive models run the first
three alone, ``decode`` over its first stages.

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
plain PyTorch, as the JAX default runs it outside Pallas. ``use_pallas=False``
(``--no_pallas``, JAX's ``Unet.use_pallas``) takes both kernels off the path
on every device: LinearAttention then runs
``kernels.linear_attention.linear_attention_reference`` and the bf16 block
runs unfused, as JAX's plain branches do (tedm_tpu/models/unet.py:370,462).

Three opt-in kernels follow the JAX package's ``use_pallas_*`` switches
(tedm_tpu/models/unet.py:520-537), with the same parameters, so a
``state_dict`` loads either way: ``fused_groupnorm`` runs every
GroupNorm+FiLM+SiLU through ``kernels.groupnorm.fused_group_norm_film_silu``;
``fused_resblock`` runs every ResnetBlock as one call of
``kernels.resblock.fused_resnet_block`` (and then no GroupNorm kernel, as
JAX's ResnetBlock returns before its Blocks); ``flash_attention`` runs the
mid Attention through ``kernels.flash_attention.flash_cosine_attention``.
They are switches apart from ``use_pallas``, as in JAX.

Under tensor parallelism (``parallel/tensor_parallel.py``) a ``Conv2d`` or
``Linear`` whose weight the ``tp`` rule shards holds its out-channel rows of
this rank of the model group and computes column-parallel: its own
out-channels with their entries of the replicated bias, gathered. The kernels that take
weights (the fused ResnetBlock, the fused PreNorm block) get them gathered
whole, as GSPMD gathers a Pallas call's weights and runs it whole.

Under spatial parallelism (``parallel/spatial.py``) the maps are this
rank's rows of the whole ones while ``spatial.sharded`` holds a plan, read
at call time as ``Conv2d`` reads its ``tp``: every convolution of more than
one row exchanges a halo first, GroupNorm's statistics add over the row
shards, and the attentions and the kernels that take a whole map (B.1,
B.2, B.3, B.4, B.5) run on the gathered map and keep this rank's rows of
their output; 1x1 convolutions, the upsample and ChanLayerNorm stay local.
Without a plan (a spatial axis of one) every module runs as in one process.

``remat`` (``--remat``) checkpoints each ResnetBlock's and each attention
block's call (``torch.utils.checkpoint``, non-reentrant) when autograd
records, as JAX wraps those modules in ``nn.remat``
(tedm_tpu/models/unet.py:538-560): the backward recomputes one block at a
time, and the kernels of a recomputed block launch again. The call is
wrapped, not the module, so the ``state_dict`` keys stay the same.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tedm_tpu_torch.kernels.attn_block import prenorm_linear_attention
from tedm_tpu_torch.kernels.flash_attention import flash_cosine_attention
from tedm_tpu_torch.kernels.groupnorm import fused_group_norm_film_silu, group_norm_film_silu_reference
from tedm_tpu_torch.kernels.linear_attention import linear_attention, linear_attention_reference
from tedm_tpu_torch.kernels.resblock import fused_resnet_block
from tedm_tpu_torch.ops.resize import nearest_upsample_2x
from tedm_tpu_torch.parallel import spatial, tensor_parallel
from tedm_tpu_torch.parallel.tensor_parallel import full_weight


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in ``compute_dtype``: input, weight and bias are cast to
    it, and so is the output. The parameters stay fp32. Under a TP ``Plan``
    (``tp``) column-parallel; under a spatial plan a kernel of more than one
    row takes its halo (module docstring)."""

    compute_dtype = torch.float32
    tp: Optional[tensor_parallel.Plan] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        if self.tp is None:
            if spatial.plan() is not None and self.kernel_size[0] > 1:
                return spatial.conv2d(self, x.to(dt), self.weight.to(dt), bias)
            return self._conv_forward(x.to(dt), self.weight.to(dt), bias)
        bias = tensor_parallel.local_rows(bias, self.tp)
        return tensor_parallel.column(self.tp, x, lambda v: self._conv_forward(v.to(dt), self.weight.to(dt), bias))


class Linear(nn.Linear):
    """``nn.Linear`` in ``compute_dtype``, as ``Conv2d``."""

    compute_dtype = torch.float32
    tp: Optional[tensor_parallel.Plan] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        if self.tp is None:
            return F.linear(x.to(dt), self.weight.to(dt), bias)
        bias = tensor_parallel.local_rows(bias, self.tp)
        return tensor_parallel.column(self.tp, x, lambda v: F.linear(v.to(dt), self.weight.to(dt), bias), dim=-1)


class ChanLayerNorm(nn.Module):
    """Channel-wise LayerNorm with gain only, biased variance, eps 1e-5,
    fp32 statistics, output in ``compute_dtype``
    (reference: models/unet_model.py:52-61). Its gain is 1-D in JAX, so the
    ``tp`` rule leaves it replicated (``jax_vectors``)."""

    compute_dtype = torch.float32
    jax_vectors = ("g",)

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
    through the GroupNorm kernel when ``fused``. Under a spatial plan the
    plain path sums its statistics over the row shards, the kernel runs on
    the gathered map."""

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
        if spatial.plan() is not None:
            if self.fused:
                return spatial.local_rows(fused_group_norm_film_silu(
                    spatial.gather_h(x), self.weight, self.bias, scale, shift, groups=self.groups, eps=1e-5))
            return group_norm_film_silu_reference(x, self.weight, self.bias, scale, shift, groups=self.groups,
                                                  eps=1e-5, stats=spatial.group_stats(x, self.groups, 1e-5))
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
            wres = None if wres is None else full_weight(res)
            return spatial.local_rows(fused_resnet_block(
                spatial.gather_h(x.to(self.compute_dtype)), full_weight(p1), p1.bias, n1.weight, n1.bias, scale,
                shift, full_weight(p2), p2.bias, n2.weight, n2.bias, wres, bres, groups=self.groups,
            ))
        h = self.block1(x, scale_shift)
        h = self.block2(h)
        return h + self.res_conv(x)


class LinearAttention(nn.Module):
    """O(N) linear attention over spatial positions, q softmaxed over its
    head dim, k over positions (reference: models/unet_model.py:178-210),
    then to_out = Conv1x1 + ChanLayerNorm. ``use_pallas``: through the
    kernel, else through its plain version on every device. Under a spatial
    plan q, k and v are gathered (k's softmax and the context sum over all
    of N) and this rank's rows of the output kept."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, use_pallas: bool = True):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.use_pallas = use_pallas
        hidden = heads * dim_head
        self.to_qkv = Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Sequential(Conv2d(hidden, dim, 1), ChanLayerNorm(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = spatial.gather_h(self.to_qkv(x))
        b, _, h, w = qkv.shape
        # 'b (h c) x y -> b h c (x y)': each chunk is a view that is
        # contiguous within a batch element, as the kernel takes it
        q, k, v = (t.reshape(b, self.heads, self.dim_head, h * w) for t in qkv.chunk(3, dim=1))
        attend = linear_attention if self.use_pallas else linear_attention_reference
        out = attend(q, k, v, self.dim_head ** -0.5)
        return self.to_out(spatial.local_rows(out.reshape(b, -1, h, w)).to(x.dtype))


class Attention(nn.Module):
    """Full attention with cosine-similarity logits at fixed scale 16
    (reference: models/unet_model.py:213-241). q and k are l2-normalised over
    the SPATIAL axis, the last axis of the (B, heads, d, N) layout
    (tedm_tpu/models/unet.py:430-435). fp32 math; with ``flash`` through the
    flash kernel on the qkv conv's chunks (output in their dtype). Under a
    spatial plan on the gathered q, k and v, this rank's rows kept."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, scale: float = 16.0, flash: bool = False):
        super().__init__()
        self.heads, self.dim_head, self.scale = heads, dim_head, scale
        self.flash = flash
        hidden = heads * dim_head
        self.to_qkv = Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = Conv2d(hidden, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = spatial.gather_h(self.to_qkv(x))
        b, _, h, w = qkv.shape
        # 'b (h c) x y -> b h c (x y)': views, contiguous within a batch element
        q, k, v = (t.reshape(b, self.heads, self.dim_head, h * w) for t in qkv.chunk(3, dim=1))
        if self.flash:
            out = flash_cosine_attention(q, k, v, self.scale)
        else:
            q = F.normalize(q.float(), dim=-1, eps=1e-12)
            k = F.normalize(k.float(), dim=-1, eps=1e-12)
            attn = (torch.einsum("bhdi,bhdj->bhij", q, k) * self.scale).softmax(dim=-1)
            out = torch.einsum("bhij,bhdj->bhdi", attn, v.float())
        return self.to_out(spatial.local_rows(out.reshape(b, -1, h, w)).to(x.dtype))


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
    the same parameters, unless the attention's ``use_pallas`` is off; under
    a spatial plan on the gathered x, this rank's rows of the output kept."""

    compute_dtype = torch.float32

    def __init__(self, dim: int, attn: nn.Module):
        super().__init__()
        self.fn = PreNorm(dim, attn)

    def forward(self, x):
        attn = self.fn.fn
        if isinstance(attn, LinearAttention) and attn.use_pallas and self.compute_dtype == torch.bfloat16:
            xg = spatial.gather_h(x)
            b, c, h, w = xg.shape
            to_out, out_norm = attn.to_out
            y = prenorm_linear_attention(
                xg.reshape(b, c, h * w), self.fn.norm.g, full_weight(attn.to_qkv),
                full_weight(to_out), to_out.bias, out_norm.g,
            )
            return spatial.local_rows(y.reshape(b, c, h, w))
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
        use_pallas: bool = True,
        remat: bool = False,
    ):
        """``channels`` is the width of the output (and by default of the
        input); ``in_channels`` widens the input for the conditional modes,
        whose input is the noised x concatenated with the condition.
        ``dtype`` is the compute dtype (bf16 under ``--mixed_precision``).
        ``fused_groupnorm``, ``fused_resblock`` and ``flash_attention``
        switch on the opt-in kernels, ``use_pallas`` (off under
        ``--no_pallas``) the linear-attention kernels, ``remat`` the block
        checkpointing (module docstring)."""
        super().__init__()
        dims = [dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        time_dim = dim * 4
        g = resnet_block_groups
        kernels = dict(fused_groupnorm=fused_groupnorm, fused_resblock=fused_resblock)
        self.remat = remat

        self.init_conv = Conv2d(in_channels or channels, dim, 7, padding=3)
        self.time_mlp = TimeMLP(dim, time_dim)

        self.downs = nn.ModuleList()
        for ind, (dim_in, dim_out) in enumerate(in_out):
            is_last = ind == len(in_out) - 1
            self.downs.append(nn.ModuleList([
                ResnetBlock(dim_in, dim_in, time_dim, g, **kernels),
                ResnetBlock(dim_in, dim_in, time_dim, g, **kernels),
                PreNormAttn(dim_in, LinearAttention(dim_in, use_pallas=use_pallas)),
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
                PreNormAttn(dim_out, LinearAttention(dim_out, use_pallas=use_pallas)),
                Upsample(dim_out, dim_in) if not is_last else Conv2d(dim_out, dim_in, 3, padding=1),
            ]))

        self.final_res_block = ResnetBlock(dim * 2, dim, time_dim, g, **kernels)
        self.final_conv = Conv2d(dim, channels, 1)

        self.compute_dtype = dtype
        for m in self.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = dtype

    def block(self, module: nn.Module, *args) -> torch.Tensor:
        """``module(*args)`` for a ResnetBlock or an attention block,
        checkpointed under ``remat`` while autograd records."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(module, *args, use_reentrant=False, preserve_rng_state=False)
        return module(*args)

    def encode(
        self, x: torch.Tensor, temb: Optional[torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
        """init_conv and the down path: (bottleneck, init residual, skips)."""
        x = self.init_conv(x)
        r = x
        hs: List[torch.Tensor] = []
        for block1, block2, attn, downsample in self.downs:
            x = self.block(block1, x, temb)
            hs.append(x)
            x = self.block(attn, self.block(block2, x, temb))
            hs.append(x)
            x = downsample(x)
        return x, r, hs

    def run_mid(self, x: torch.Tensor, temb: Optional[torch.Tensor]) -> torch.Tensor:
        x = self.block(self.mid_block1, x, temb)
        return self.block(self.mid_block2, self.block(self.mid_attn, x), temb)

    def decode(
        self,
        x: torch.Tensor,
        r: torch.Tensor,
        hs: Sequence[torch.Tensor],
        temb: Optional[torch.Tensor],
        collect_features: bool = False,
        n_stages: Optional[int] = None,
    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The up path, or its first ``n_stages`` stages (each with its
        upsample), on the skips ``hs`` (left as they are). With
        ``collect_features`` also the post-attention map of every stage run."""
        hs = list(hs)
        feats: List[torch.Tensor] = []
        stages = self.ups if n_stages is None else self.ups[:n_stages]
        for block1, block2, attn, upsample in stages:
            x = self.block(block1, torch.cat([x, hs.pop()], dim=1), temb)
            x = self.block(block2, torch.cat([x, hs.pop()], dim=1), temb)
            x = self.block(attn, x)
            if collect_features:
                feats.append(x)
            x = upsample(x)
        return x, feats

    def final(self, x: torch.Tensor, r: torch.Tensor, temb: Optional[torch.Tensor]) -> torch.Tensor:
        return self.final_conv(self.block(self.final_res_block, torch.cat([x, r], dim=1), temb))

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
        x, r, hs = self.encode(x, temb)
        x = self.run_mid(x, temb)
        x, feats = self.decode(x, r, hs, temb, collect_features=extract_features)
        out = self.final(x, r, temb)
        if extract_features:
            return out, feats
        return out


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
