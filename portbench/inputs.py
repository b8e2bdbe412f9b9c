"""What a run is fed, made from its seed on the device in a few large calls:
the weights, the images, the timesteps and the noise. Both the program and
the reference take them from here.

Weights follow torch's default initialisation of each layer, drawn at once:
a conv or linear weight, and its bias, uniform in +-1/sqrt(fan_in); a norm's
gain 1 and its bias 0; BatchNorm's running statistics 0 and 1. A leaf is
told apart by its name and shape alone, so one rule serves any model whose
names follow the reference torch code.

Images are synthetic chest X-rays, a copy of the port's device generator
(``tedm_tpu_torch/data/device_synthetic.py`` ``render``): a body, two dark
elliptical lungs, rib bands and speckle. All images of a pool come from one
normal draw.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Sequence, Tuple

import torch

N_SCALARS = 13  # 6 a lung, then the rib frequency


def stream(seed: int, tag: str) -> int:
    """A 63-bit seed for the named stream of a run's ``seed``."""
    return int.from_bytes(hashlib.sha256(f"{seed}:{tag}".encode()).digest()[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream(seed, tag))


def _leaf_rule(name: str, shape: Sequence[int], shapes: Dict[str, Sequence[int]]) -> Tuple[float, float]:
    """(bound, offset) of a leaf: uniform in offset +- bound."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "running_var" or leaf == "g" or (leaf == "weight" and len(shape) == 1):
        return 0.0, 1.0
    if leaf == "bias":
        sibling = shapes.get(name[: -len("bias")] + "weight")
        if sibling is not None and len(sibling) > 1:
            return 1.0 / math.sqrt(math.prod(sibling[1:])), 0.0
        return 0.0, 0.0
    if leaf == "weight":
        return 1.0 / math.sqrt(math.prod(shape[1:])), 0.0
    return 0.0, 0.0  # running_mean, num_batches_tracked


def weights(spec: Dict[str, torch.Tensor], seed: int, tag: str, device) -> Dict[str, torch.Tensor]:
    """A state_dict for ``spec`` (name -> tensor of the model's state_dict,
    on any device, e.g. ``meta``), drawn from ``seed``'s ``tag`` stream on
    ``device``: fp32 for floating leaves, the leaf's dtype otherwise."""
    shapes = {k: tuple(v.shape) for k, v in spec.items()}
    floats = [k for k, v in spec.items() if v.is_floating_point()]
    sizes = [math.prod(shapes[k]) for k in floats]
    rules = torch.tensor([_leaf_rule(k, shapes[k], shapes) for k in floats], dtype=torch.float32, device=device)
    counts = torch.tensor(sizes, device=device)
    total = sum(sizes)
    flat = torch.rand(total, generator=generator(seed, tag, device), device=device).mul_(2).sub_(1)
    flat.mul_(torch.repeat_interleave(rules[:, 0], counts, output_size=total))
    flat.add_(torch.repeat_interleave(rules[:, 1], counts, output_size=total))
    out = {k: t.view(shapes[k]) for k, t in zip(floats, torch.split(flat, sizes))}
    for k, v in spec.items():
        if k not in out:
            out[k] = torch.zeros(shapes[k], dtype=v.dtype, device=device)
    return {k: out[k] for k in spec}


def render(z: torch.Tensor, size: int) -> torch.Tensor:
    """Images (B, 1, size, size) in [0, 1] from normal draws z (B,
    N_SCALARS + size**2): per lung the centre's normal offsets, the radii's
    and the darkening's uniforms (a uniform is its normal's CDF) and the
    tilt's normal, the rib frequency's uniform, the speckle."""
    dev = z.device
    scalars = z[:, :N_SCALARS]
    uniform = 0.5 * (1.0 + torch.erf(scalars / math.sqrt(2.0)))
    is_uniform = torch.tensor([0, 0, 1, 1, 0, 1] * 2 + [1], dtype=torch.bool, device=dev)
    scalars = torch.where(is_uniform, uniform, scalars)
    lungs, rib = scalars[:, :12].reshape(-1, 2, 6), scalars[:, 12]
    speckle = z[:, N_SCALARS:].reshape(-1, size, size)
    grid = torch.arange(size, dtype=torch.float32, device=dev) / size
    yy, xx = grid[:, None], grid[None, :]
    img = (0.25 + 0.35 * torch.exp(-(((yy - 0.5) ** 2) / 0.5 + ((xx - 0.5) ** 2) / 0.25))).expand(speckle.shape)
    col = lambda v: v[:, None, None]
    for i, side in enumerate((-1.0, 1.0)):
        cxn, cyn, rxu, ryu, thn, dark = lungs[:, i].unbind(1)
        cx = 0.5 + side * (0.21 + 0.03 * col(cxn))
        cy = 0.48 + 0.03 * col(cyn)
        rx, ry = 0.13 + 0.02 * col(rxu), 0.26 + 0.03 * col(ryu)
        theta = 0.12 * side + 0.05 * col(thn)
        xr = (xx - cx) * torch.cos(theta) - (yy - cy) * torch.sin(theta)
        yr = (xx - cx) * torch.sin(theta) + (yy - cy) * torch.cos(theta)
        lung = (xr / rx) ** 2 + (yr / ry) ** 2 < 1.0
        img = torch.where(lung, img - 0.18 - 0.04 * col(dark), img)
    img = img + 0.03 * torch.sin(yy * (40 + 5 * col(rib)) + xx * 3) + 0.02 * speckle
    return img.clamp(0.0, 1.0)[:, None]


def images(seed: int, n: int, size: int, device) -> torch.Tensor:
    """A pool of ``n`` images (n, 1, size, size), fp32, from ``seed``."""
    z = torch.randn((n, N_SCALARS + size * size), generator=generator(seed, "images", device), device=device)
    return render(z, size)


class StepFeed:
    """The batches of a training window: step k takes the k-th block of
    ``batch`` rows of the pool (cycling), timesteps uniform in [0, T) and
    normal noise, drawn from ``seed`` on the device step by step."""

    def __init__(self, seed: int, pool: torch.Tensor, batch: int, timesteps: int):
        self.pool, self.batch, self.timesteps = pool, batch, timesteps
        self.blocks = pool.shape[0] // batch
        self.gen = generator(seed, "steps", pool.device)

    def __call__(self, k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        i = k % self.blocks
        x = self.pool[i * self.batch:(i + 1) * self.batch]
        t = torch.randint(0, self.timesteps, (self.batch,), generator=self.gen, device=x.device)
        noise = torch.randn(x.shape, generator=self.gen, device=x.device)
        return x, t, noise


def serving_noise(rows: Tuple[int, ...], noise_seed: int, device) -> torch.Tensor:
    """The q_sample noise a served TEDM request uses: a normal draw of every
    folded row from a generator seeded with the served model's fixed
    noise seed."""
    return torch.randn(rows, generator=torch.Generator(device=device).manual_seed(noise_seed), device=device)

