"""Export of serving functions as ``torch.export`` programs (port of
``tedm_tpu/serve/export.py``).

A trained experiment's predictor, or a diffusion checkpoint's sampler, is
exported once to a self-contained ``.pt2`` file with the weights in it; a
serving process loads and calls it without the model code, the checkpoint
or a trace. The hand-written kernels are ``torch.library`` ops
(``kernels/ops.py``), so the program holds each kernel call as one node
and launches the kernel on the card; ``load_exported`` imports the ops.

    # producer
    export_predictor(exp_dir, "/models/tedm197.pt2")

    # consumer (a process with torch and this package, on the same kind of device)
    predict = load_exported("/models/tedm197.pt2")
    probs = predict(images_nchw)        # (fold*B, C, H, W) sigmoids

An export is tied to the device it was made on (``device``, the card by
default), as a JAX export is tied to its platform.

Noise. JAX bakes ``PRNGKey(seed)`` into its programs. The predictor's q_sample
noise is drawn here once, at export time, from a ``torch.Generator`` seeded
with ``seed`` on the device (the draw ``Predictor`` makes with its
``NOISE_SEED``), and baked in, so the program's output is
``Predictor._probabilities`` before its mean over timesteps. The samplers take
their noise as arguments (ROADMAP's noise rule): x_T, and for the ancestral
sampler each step's noise.

The samplers. DDIM (at eta 0, as JAX exports it) and DPM-Solver++(2M) are one
program each, the loop unrolled over ``num_steps`` on ``step_grid``. The
ancestral sampler's T = 1000 steps cannot be unrolled into one graph: its
artifact is ONE reverse step, x_t -> x_{t-1} with t a (B,) tensor argument and
the schedule baked in, and ``load_exported``'s callable runs that step over
the grid that the artifact records. This is the one place where an artifact's
structure differs from JAX's (one ``fori_loop`` program); the map from noise
to image is the same.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

META = "tedm_tpu_torch.json"  # the artifact's record, an extra file of the .pt2
SAMPLERS = ("ancestral", "ddim", "dpmpp")


class _Predictor(nn.Module):
    """x (B, C, H, W) -> sigmoid probabilities (fold*B, C, H, W), with the
    q_sample noise fixed."""

    def __init__(self, task, noise: Optional[torch.Tensor]):
        super().__init__()
        self.parts = nn.ModuleDict(task.modules)
        self.task = task
        self.noise = noise

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.task.apply(x, noise=self.noise).float())


class _Sampler(nn.Module):
    """A diffusion UNet's sampler: the unrolled DDIM / DPM++ loop from x_T,
    or one ancestral step. Conditional modes take the condition too."""

    def __init__(self, unet, sched, config, sampler: str, num_steps: int, x_ch: int):
        from tedm_tpu_torch.models.diffusion import ddim_coefficients, dpmpp2m_coefficients

        super().__init__()
        self.unet, self.sched, self.config, self.sampler = unet, sched, config, sampler
        self.shape = (x_ch, config.img_size, config.img_size)
        # the host-side coefficients, computed here: a traced loop cannot read them
        self.coefficients = (ddim_coefficients(sched, num_steps) if sampler == "ddim"
                             else dpmpp2m_coefficients(sched, num_steps) if sampler == "dpmpp" else None)

    def apply_fn(self, cond: Optional[torch.Tensor]):
        if cond is None:
            return self.unet
        return lambda x, t: self.unet(torch.cat([x, cond.repeat(x.shape[0] // cond.shape[0], 1, 1, 1)], dim=1), t)

    def forward(self, x: torch.Tensor, *rest: torch.Tensor) -> torch.Tensor:
        from tedm_tpu_torch.models import diffusion as D

        cfg = self.config
        kw = dict(objective=cfg.objective, dynamic_threshold_percentile=cfg.dynamic_threshold_percentile)
        if self.sampler == "ancestral":  # (x_t, t, noise[, cond]) -> x_{t-1}
            t, noise, *cond = rest
            return D.sample_step(self.apply_fn(cond[0] if cond else None), self.sched, x, t, noise=noise, **kw)
        apply = self.apply_fn(rest[0] if rest else None)
        shape = (x.shape[0], *self.shape)
        if self.sampler == "ddim":
            x = D.ddim_sample_loop(apply, self.sched, shape, x_T=x, coefficients=self.coefficients, **kw)
        else:
            x = D.dpmpp2m_sample_loop(apply, self.sched, shape, x_T=x, coefficients=self.coefficients, **kw)
        return D.unnormalize_to_zero_to_one(x.clamp(-1.0, 1.0))


def _save(module: nn.Module, args: tuple, out_path: str, meta: dict) -> int:
    module.eval().requires_grad_(False)
    with torch.no_grad():
        program = torch.export.export(module, args)
    torch.export.save(program, out_path, extra_files={META: json.dumps(meta)})
    return os.path.getsize(out_path)


def export_predictor(
    exp_dir: str,
    out_path: str,
    batch_size: int = 1,
    seed: int = 0,
    device: Union[str, torch.device] = "cuda",
) -> int:
    """Export an experiment's sigmoid predictor (weights and noise baked in)
    to ``out_path``. Returns the artifact's size in bytes."""
    from tedm_tpu_torch.eval.harness import load_experiment
    from tedm_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    config, task = load_experiment(exp_dir, dev)
    shape = (batch_size, config.channels, config.img_size, config.img_size)
    noise = None
    if task.t_steps:  # the diffusion-feature heads' q_sample draw, as Predictor's
        gen = torch.Generator(device=dev).manual_seed(seed)
        noise = torch.randn((len(task.t_steps) * batch_size, *shape[1:]), generator=gen, device=dev)
    meta = {"kind": "predictor", "device": dev.type, "input": list(shape), "fold": task.fold,
            "experiment": config.experiment, "seed": seed}
    return _save(_Predictor(task, noise), (torch.zeros(shape, device=dev),), out_path, meta)


def export_sampler(
    exp_dir: str,
    out_path: str,
    batch_size: int = 1,
    sampler: str = "dpmpp",
    num_steps: int = 20,
    device: Union[str, torch.device] = "cuda",
) -> int:
    """Export a diffusion checkpoint's sampler (weights baked in): ``sampler``
    'ancestral' (one reverse step, run over the T-step grid by
    ``load_exported``), 'ddim' or 'dpmpp' (``num_steps`` steps, one
    program). The program takes x_T (B, C, H, W), C the mode's width
    (``mode_channels``), then for the ancestral step t (B,) and the step's
    noise, and in the conditional modes the condition (B, 1, H, W) last;
    DDIM and DPM++ return images in [0, 1]. Returns the size in bytes."""
    from tedm_tpu_torch.eval.harness import load_diffusion_experiment
    from tedm_tpu_torch.trainers.diffusion import CONDITIONAL, mode_channels
    from tedm_tpu_torch.utils.device import resolve_device

    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler}")
    dev = resolve_device(device)
    config, unet, sched = load_diffusion_experiment(exp_dir, dev)
    x_ch, _ = mode_channels(config)
    conditional = config.experiment in CONDITIONAL
    size = config.img_size
    x = torch.zeros((batch_size, x_ch, size, size), device=dev)
    args = (x,)
    T = sched.num_timesteps
    if sampler == "ancestral":
        args += (torch.full((batch_size,), T - 1, dtype=torch.long, device=dev), torch.zeros_like(x))
        num_steps, grid = T, list(range(T - 1, -1, -1))
    else:
        from tedm_tpu_torch.models.diffusion import step_grid

        grid = step_grid(T, num_steps if sampler == "ddim" else num_steps + 1)
    if conditional:
        args += (torch.zeros((batch_size, 1, size, size), device=dev),)
    meta = {"kind": "sampler", "device": dev.type, "sampler": sampler, "steps": num_steps, "grid": grid,
            "input": list(x.shape), "conditional": conditional, "experiment": config.experiment}
    return _save(_Sampler(unet, sched, config, sampler, num_steps, x_ch), args, out_path, meta)


def _tensor(a, dev: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _drop_metadata_asserts(module: torch.fx.GraphModule) -> torch.fx.GraphModule:
    """``module`` without the ``aten._assert_tensor_metadata`` nodes that
    ``torch.export`` writes before each dtype cast of an intermediate value:
    about 500 a UNet call, each an op call on the host that checks a dtype
    the traced program fixes. Those on the program's arguments stay. A bf16
    sampling step at batch 8 is bound by the host, and dropping them takes
    it from 44.7 to 38.7 ms on an H100 80GB HBM3 at 700 W (eager: 30.8;
    PERF.md, PR 11, ``scripts/port/bench_sampling.py``'s split of one
    step)."""
    op = getattr(getattr(torch.ops.aten, "_assert_tensor_metadata", None), "default", None)
    asserts = [n for n in module.graph.nodes
               if n.op == "call_function" and n.target is op and n.args[0].op != "placeholder"]
    for node in asserts:
        module.graph.erase_node(node)
    if asserts:
        module.recompile()
    return module


def load_exported(path: str, device: Union[str, torch.device] = "cuda") -> Callable[..., np.ndarray]:
    """Load an exported predictor or sampler into a callable over numpy
    arrays or tensors that returns numpy. A predictor's callable takes x;
    DDIM's and DPM++'s take x_T (and the condition); the ancestral
    sampler's takes x_T and the steps' noise (steps, B, C, H, W), noise[i]
    that of the step at grid[i] (and the condition), and runs the exported
    step over the recorded grid, or over ``grid=`` (its last steps, say),
    then maps the sample to [0, 1]. Like the other entry points it turns
    TF32 off (``utils.device.strict_fp32``). The program runs without the
    dtype asserts on its intermediate values (``_drop_metadata_asserts``)."""
    from tedm_tpu_torch.kernels import ops  # noqa: F401  (registers the ops the program calls)
    from tedm_tpu_torch.utils.device import resolve_device, strict_fp32

    dev = resolve_device(device)
    strict_fp32()  # the program's fp32 convolutions in fp32, as the port's eager path runs them
    extra = {META: ""}
    program = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[META])
    if meta["device"] != dev.type:
        raise ValueError(f"{path} was exported on {meta['device']}, not {dev.type}")
    module = _drop_metadata_asserts(program.module())

    if meta.get("sampler") != "ancestral":
        def call(*args):
            with torch.no_grad():
                return module(*(_tensor(a, dev) for a in args)).cpu().numpy()
        return call

    def run_grid(x_T, noises, cond=None, grid: Optional[Sequence[int]] = None):
        from tedm_tpu_torch.models.diffusion import unnormalize_to_zero_to_one

        grid = meta["grid"] if grid is None else list(grid)
        x, noises = _tensor(x_T, dev), _tensor(noises, dev)
        extra_args = () if cond is None else (_tensor(cond, dev),)
        with torch.no_grad():
            for i, t in enumerate(grid):
                tb = torch.full((x.shape[0],), t, dtype=torch.long, device=dev)
                x = module(x, tb, noises[i], *extra_args)
            return unnormalize_to_zero_to_one(x.clamp(-1.0, 1.0)).cpu().numpy()

    run_grid.meta = meta
    return run_grid


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="Export a trained experiment's predictor or sampler (torch.export)")
    p.add_argument("kind", choices=["predictor", "sampler"])
    p.add_argument("--experiment", "-e", required=True, help="experiment dir")
    p.add_argument("--out", required=True)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--sampler", type=str, default="dpmpp", choices=list(SAMPLERS))
    p.add_argument("--num_steps", type=int, default=20)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    if args.kind == "predictor":
        n = export_predictor(args.experiment, args.out, args.batch_size, device=args.device)
    else:
        n = export_sampler(args.experiment, args.out, args.batch_size, args.sampler, args.num_steps,
                           device=args.device)
    print(f"wrote {args.out} ({n} bytes)")


if __name__ == "__main__":
    main()
