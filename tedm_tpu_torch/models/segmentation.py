"""Diffusion-feature segmentation: feature extraction and the pixel
classifier (port of ``tedm_tpu/models/segmentation.py``).

Per timestep t in ``t_steps``, the image is q-sampled to x_t, the frozen
UNet runs once, and its 4 up-stage attention outputs are the features
(512@16², 256@32², 128@64², 64@128² at default widths). The S timesteps fold
into the batch, step-major, so one UNet call serves them all. The classifier
is the datasetDM 1x1-conv MLP [->128, ReLU, BN, ->32, ReLU, BN, ->1] whose
layer 1 runs per stage at native resolution and is then nearest-upsampled and
summed, which equals the conv over the upsampled concatenation and never
builds that (B, S*960, 128, 128) tensor. ``LinearProbe`` is PDDM's head, one
1x1 conv over the same S*960 channels, computed the same way.

Under tensor parallelism the heads' 1x1 convs take the ``tp`` rule as the
UNet's do (``parallel/tensor_parallel.py``): layer 1 sums its stages over
this rank's out-channels and gathers them before the bias, so BatchNorm's
statistics are taken over the gathered channels.

Under spatial parallelism (``parallel/spatial.py``) the features are this
rank's rows of each stage: the noise is drawn for the whole map and cut to
them, layer 1's nearest resize of a stage to this rank's rows of the
output is local at the integer ratios of the stages, and BatchNorm's sums
and the probe's pre-pass sums add over the data x spatial ranks.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tedm_tpu_torch.models.diffusion import normalize_to_neg_one_to_one, q_sample
from tedm_tpu_torch.models.unet import Conv2d, Unet
from tedm_tpu_torch.ops.resize import nearest_resize
from tedm_tpu_torch.ops.schedules import DiffusionSchedule
from tedm_tpu_torch.parallel import spatial, tensor_parallel
from tedm_tpu_torch.parallel.mesh import all_reduce_sum


_step_rows: Dict[Tuple[Tuple[int, ...], int, torch.device], torch.Tensor] = {}


def step_rows(t_steps: Tuple[int, ...], b: int, device: torch.device) -> torch.Tensor:
    """The (S*B,) timesteps of a folded batch, step-major, made once per
    (steps, batch, device) and only read after: a CUDA graph of a request
    then copies nothing from the host. A plain tensor even under inference
    mode, so that training may use it too; a tracer's tensor (under
    ``torch.export``) is not kept."""
    key = (t_steps, b, device)
    rows = _step_rows.get(key)
    if rows is None:
        with torch.inference_mode(False):
            rows = torch.tensor(t_steps, dtype=torch.long, device=device).repeat_interleave(b)
        if type(rows) is torch.Tensor:
            _step_rows[key] = rows
    return rows


def extract_features(
    unet: Unet,
    sched: DiffusionSchedule,
    x_0: torch.Tensor,
    t_steps: Sequence[int],
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    normalize: bool = True,
) -> List[torch.Tensor]:
    """Decoder features for every timestep in one batched UNet call.

    x_0 (B, C, H, W) in [0, 1]; ``sched`` on x_0's device. Returns the 4
    up-stage maps, each (S*B, c_s, h_s, w_s), step-major (step s occupies rows
    [s*B, (s+1)*B)). RNG semantics of the reference
    (models/datasetDM_model.py:67-83): ``noise`` (B, C, H, W) given -> the same
    noise for every timestep; otherwise fresh noise per timestep drawn from
    ``generator``. ``noise`` of (S*B, C, H, W), step-major, gives each
    timestep its own rows (the training draw of the JAX package). Under a
    spatial plan x_0 and a given ``noise`` are this rank's rows, and drawn
    noise is drawn for the whole map and cut to them.
    """
    b = x_0.shape[0]
    s = len(t_steps)
    if normalize:
        x_0 = normalize_to_neg_one_to_one(x_0)
    t_rep = step_rows(tuple(t_steps), b, x_0.device)
    x_rep = x_0.repeat(s, 1, 1, 1)
    if noise is not None:
        noise = noise.to(x_0.device, x_0.dtype)
        noise_rep = noise if noise.shape[0] == s * b else noise.repeat(s, 1, 1, 1)
    else:
        if generator is None:
            raise ValueError("need generator or noise")
        noise_rep = spatial.randn(x_rep.shape, generator, x_0.device, x_0.dtype)
    x_t = q_sample(sched, x_rep, t_rep, noise_rep)
    _, feats = unet(x_t, t_rep, extract_features=True)
    return feats


class PixelClassifier(nn.Sequential):
    """The datasetDM head with the fused multi-scale layer 1.

    An ``nn.Sequential`` laid out as the reference's (models/datasetDM_model.py:
    57-64), so its ``state_dict`` keys are those
    ``tedm_tpu/utils/torch_port.py:158-196`` reads: Conv, ReLU, BN, Conv,
    ReLU, BN, Conv, behind a parameter-free stand-in for the Rearrange layer
    that leads the shared-weights head (trainers/train_datasetDM.py:30-42).

    ``shared=True``, ``n_steps=1`` with folded (S*B) input is the TEDM head
    (127,489 parameters); ``n_steps=S`` with B-batch input is the LEDM/LEDMe
    head (373,249 for S=3). Layer-1 input channels are ordered
    [step-major x stage-major x channel] as the reference concatenates them.
    """

    def __init__(
        self,
        stage_channels: Sequence[int] = (512, 256, 128, 64),
        n_steps: int = 1,
        out_channels: int = 1,
        img_size: int = 128,
        shared: bool = False,
    ):
        c_in = sum(stage_channels) * n_steps
        hidden = (128, 32)
        layers = [
            Conv2d(c_in, hidden[0], 1), nn.ReLU(), nn.BatchNorm2d(hidden[0], eps=1e-5),
            Conv2d(hidden[0], hidden[1], 1), nn.ReLU(), nn.BatchNorm2d(hidden[1], eps=1e-5),
            Conv2d(hidden[1], out_channels, 1),
        ]
        super().__init__(*([nn.Identity()] if shared else []), *layers)
        self.stage_channels = tuple(stage_channels)
        self.n_steps = n_steps
        self.img_size = img_size
        self.offset = 1 if shared else 0

    def forward(self, feats: List[torch.Tensor]) -> torch.Tensor:
        """feats: the 4 stage maps, each (n_steps*B, c_s, h_s, w_s), fp32 or
        the bf16 of a mixed-precision backbone -> fp32 logits
        (B, out_channels, img_size, img_size). BatchNorm as flax's
        (``flax_batch_norm``): running statistics in eval mode, batch
        statistics in train mode."""
        conv1, relu1, bn1, conv2, relu2, bn2, conv3 = list(self)[self.offset:]
        # fp32 head on features of any dtype (tedm_tpu/models/segmentation.py:126-129)
        acc = stage_sum(conv1, conv1.weight, (f_s for _, f_s in _step_stage(feats, self.n_steps)),
                        self.stage_channels * self.n_steps, self.img_size)  # weight (h1, c_in, 1, 1)
        x = flax_batch_norm(bn1, relu1(acc + conv1.bias[None, :, None, None]))
        x = flax_batch_norm(bn2, relu2(conv2(x)))
        return conv3(x)


def flax_batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """``bn`` applied as flax's ``nn.BatchNorm(momentum=0.9)`` applies it
    (tedm_tpu/models/segmentation.py:136-145), keeping ``bn``'s parameters
    and buffers. In eval mode it is ``bn`` itself. In train mode it
    normalises by the batch mean and the biased variance E[x^2] - mean^2
    (clamped at 0) over (B, H, W), every row counting, padding included, and
    moves the running statistics by 0.1 of the way to them, the running
    variance to the *biased* batch variance (``nn.BatchNorm2d`` takes the
    unbiased one). Under data parallelism the batch is the global one, as in
    JAX's program over the sharded batch: the sums, sums of squares and
    counts of every rank, of every row shard under spatial parallelism, are
    added (``parallel.mesh.all_reduce_sum``, with their gradient), and every
    rank moves its running statistics alike."""
    if not bn.training:
        return bn(x)
    xf = x.float()
    n = torch.full((1,), float(xf.shape[0] * xf.shape[2] * xf.shape[3]), device=xf.device)
    c = xf.shape[1]
    sums = all_reduce_sum(torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)), n]))
    mean = sums[:c] / sums[-1]
    var = (sums[c:2 * c] / sums[-1] - mean * mean).clamp(min=0.0)
    with torch.no_grad():
        bn.running_mean.mul_(0.9).add_(0.1 * mean)
        bn.running_var.mul_(0.9).add_(0.1 * var)
        bn.num_batches_tracked += 1
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return ((xf - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]).to(x.dtype)


def stage_sum(module: nn.Module, weight: torch.Tensor, stages, channels: Sequence[int], size: int) -> torch.Tensor:
    """The sum over ``stages`` (each (B, c, h, w)) of the 1x1 conv with its
    columns of ``weight`` (off, c), nearest-resized to ``size``: a 1x1 conv
    over the upsampled concatenation, without building it. Under
    ``module``'s TP plan over this rank's out-channels, then gathered; under
    a spatial plan resized to this rank's rows of ``size``."""
    plan = module.tp
    acc, off = None, 0
    for f_s, c in zip(stages, channels):
        if plan is not None:
            f_s = tensor_parallel.enter(f_s, plan)
        y = nearest_resize(F.conv2d(f_s, weight[:, off:off + c]), spatial.local_size(size), size)
        acc = y if acc is None else acc + y
        off += c
    return acc if plan is None else tensor_parallel.gather(acc, plan, 1)


def _step_stage(feats: List[torch.Tensor], n_steps: int):
    """(stage index, the stage's fp32 rows of one step) in [step x stage]
    order, the order of the heads' input channels."""
    b = feats[0].shape[0] // n_steps
    for s in range(n_steps):
        for i, f in enumerate(feats):
            yield i, f[s * b:(s + 1) * b].float()


class LinearProbe(nn.Module):
    """PDDM's probe: one 1x1 conv over all S*960 feature channels, with
    optional standardisation (f - mean) / std by the ``mean`` and ``std``
    buffers, which the trainer's pre-pass fills (the port of
    ``LinearProbe`` in ``tedm_tpu/models/segmentation.py``; reference:
    trainers/datasetDM_per_step.py:17-32, which computed the standardised
    features and then discarded them). ``weight`` is (out, S*960, 1, 1) with
    torch's Conv2d init (uniform, variance 1/(3 fan_in)), ``bias`` zeros, as
    the JAX package initialises them. In fp32 on features of any dtype."""

    tp: Optional[tensor_parallel.Plan] = None

    def __init__(
        self,
        stage_channels: Sequence[int] = (512, 256, 128, 64),
        n_steps: int = 1,
        out_channels: int = 1,
        img_size: int = 128,
        standardize: bool = False,
    ):
        super().__init__()
        c_in = sum(stage_channels) * n_steps
        self.weight = nn.Parameter(torch.empty(out_channels, c_in, 1, 1))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.register_buffer("mean", torch.zeros(c_in))
        self.register_buffer("std", torch.ones(c_in))
        self.stage_channels = tuple(stage_channels)
        self.n_steps = n_steps
        self.img_size = img_size
        self.standardize = standardize

    def forward(self, feats: List[torch.Tensor]) -> torch.Tensor:
        """feats: the 4 stage maps, each (n_steps*B, c_s, h_s, w_s) -> fp32
        logits (B, out_channels, img_size, img_size)."""
        channels = self.stage_channels * self.n_steps
        stages = (f_s for _, f_s in _step_stage(feats, self.n_steps))
        if self.standardize:
            offs = [sum(channels[:i]) for i in range(len(channels))]
            stages = ((f_s - self.mean[o:o + c, None, None]) / self.std[o:o + c, None, None]
                      for f_s, o, c in zip(stages, offs, channels))
        return stage_sum(self, self.weight, stages, channels, self.img_size) + self.bias[None, :, None, None]


def masked_feature_sums(
    feats: List[torch.Tensor], n_steps: int, valid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-channel (sum, sum of squares, count) over the valid rows and
    space, in the [step x stage x channel] order: the pieces of the probe's
    standardisation pre-pass that leave out the loader's padding rows
    (port of ``masked_feature_sums``; reference pre-pass:
    datasetDM_per_step.py:104-113). Over this rank's rows under a spatial
    plan: the caller adds them over the data x spatial ranks."""
    w = valid.float().reshape(-1, 1, 1, 1)
    sums, sqs, cnts = [], [], []
    for _, f_s in _step_stage(feats, n_steps):
        sums.append((f_s * w).sum(dim=(0, 2, 3)))
        sqs.append((f_s.square() * w).sum(dim=(0, 2, 3)))
        cnt = valid.float().sum() * f_s.shape[2] * f_s.shape[3]
        cnts.append(cnt.expand(f_s.shape[1]))
    return torch.cat(sums), torch.cat(sqs), torch.cat(cnts)


def feature_moments(feats: List[torch.Tensor], n_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel mean and (biased) std over (batch, space), in the [step x
    stage x channel] order (port of ``feature_moments``)."""
    means, stds = [], []
    for _, f_s in _step_stage(feats, n_steps):
        var, mean = torch.var_mean(f_s, dim=(0, 2, 3), correction=0)
        means.append(mean)
        stds.append(var.sqrt())
    return torch.cat(means), torch.cat(stds)
