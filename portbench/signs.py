"""The look behind ``ddpm_train.fp32``'s swinging numbers: the L1 loss's
gradient is the sign of out - noise, and where that difference is near 0 the
program and the reference, each exact to fp32's rounding, can give a pixel
opposite signs. The benchmark's own runs never run this.

    python3 portbench/signs.py scan --workload ddpm_train.fp32 --seed <first> --count <n>
    python3 portbench/signs.py plant --workload ddpm_train.fp32 --seed <first> --count <n>

``scan``: for each seed, the pixels of the first checked step where the
program's UNet output and the reference's, on the same inputs and weights,
put out - noise on opposite sides of 0 (as one JSON line). ``plant``: the
reference against itself with one sign turned at step k (the target of the
pixel nearest the output mirrored across it, so the loss is unchanged): the
compared numbers each such run reads, for k = 0, 1, 2, and those of a
second plain run.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(cell, seed, dev):
    from portbench import inputs

    cfg, mix = cell["model"], cell["mix"]
    pool = inputs.images(seed, mix["pool"], cfg["img_size"], dev)
    feed = inputs.StepFeed(seed, pool, mix["batch"], cfg["timesteps"])
    return [feed(k) for k in range(3)]


def scan(cell, seeds, dev):
    import torch
    from tedm_tpu_torch.models.diffusion import q_sample
    from tedm_tpu_torch.ops.schedules import make_schedule
    from tedm_tpu_torch.trainers import diffusion
    from tedm_tpu_torch.utils.device import strict_fp32

    from portbench import inputs
    from portbench.drivers import train_step
    from portbench.reference.diffusion import Schedule
    from portbench.reference.unet import Unet

    cfg, mix = cell["model"], cell["mix"]
    strict_fp32()
    config, spec = train_step._config(cfg, mix), train_step._spec(cfg)
    program = diffusion.build_model(config).to(dev)
    sched = make_schedule(config.timesteps, config.beta_schedule).to(dev)
    with dev:
        reference = Unet(cfg["dim"], cfg["dim_mults"], cfg["channels"])
    ref_sched = Schedule(cfg["timesteps"], cfg["beta_schedule"], device=dev)
    for seed in seeds:
        x, t, noise = _inputs(cell, seed, dev)[0]
        start = inputs.weights(spec, seed, "unet", dev)
        program.load_state_dict(start)
        reference.load_state_dict(start)
        with torch.no_grad():
            d_prog = program(q_sample(sched, x * 2 - 1, t, noise), t).float() - noise
            d_ref = reference(ref_sched.q_sample(x * 2 - 1, t, noise), t) - noise
        turned = torch.sign(d_prog) != torch.sign(d_ref)
        yield {"seed": seed, "turned": int(turned.sum()), "d_ref": d_ref[turned].tolist()[:8],
               "d_prog": d_prog[turned].tolist()[:8], "max_out_gap": (d_prog - d_ref).abs().max().item()}


def plant(cell, seeds, dev):
    from portbench import compare, inputs
    from portbench.drivers import train_step
    from portbench.reference import strict_fp32
    from portbench.reference import train as ref_train
    from portbench.reference.diffusion import Schedule
    from portbench.reference.unet import Unet

    cfg = cell["model"]
    strict_fp32()
    spec = train_step._spec(cfg)

    class Turned(Schedule):
        """The loss with the sign of one pixel's difference turned at the
        ``at``-th call."""

        at, calls = -1, 0

        def loss_sum(self, out, noise, t):
            if self.calls == self.at:
                d = (out - noise).detach().flatten()
                i = d.abs().argmin()
                noise = noise.clone()
                noise.view(-1)[i] += 2 * d[i]
            self.calls += 1
            return super().loss_sum(out, noise, t)

    def run(seed, checked, at):
        sched = Turned(cfg["timesteps"], cfg["beta_schedule"], device=dev)
        sched.at = at
        with dev:
            model = Unet(cfg["dim"], cfg["dim_mults"], cfg["channels"])
        model.load_state_dict(inputs.weights(spec, seed, "unet", dev))
        batch = checked[0][0].shape[0]
        return ref_train.run(model, sched, checked, cfg["lr"], cfg["ema_decay"], batch)

    for seed in seeds:
        checked = _inputs(cell, seed, dev)
        plain = run(seed, checked, -1)
        yield {"seed": seed, "turned_at": None, "numbers": compare.training(run(seed, checked, -1), plain)[0]}
        for k in range(len(checked)):
            numbers, detail = compare.training(run(seed, checked, k), plain)
            worst = {g: max(v, key=v.get) for g, v in detail["leaf_gaps"].items()}
            yield {"seed": seed, "turned_at": k, "numbers": numbers, "worst": worst}


def main(argv=None, device: str = "cuda") -> int:
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=("scan", "plant"))
    p.add_argument("--workload", default="ddpm_train.fp32")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--count", type=int, default=1)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    cell = harness.cell(args.workload)
    seeds = range(args.seed, args.seed + args.count)
    for line in (scan if args.mode == "scan" else plant)(cell, seeds, torch.device(device)):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
