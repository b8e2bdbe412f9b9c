"""The TEDM head's weight gradients under spatial sharding against fp64.

One TEDM head step (the shared-weights head on a frozen backbone under
``--use_pallas_groupnorm``, one labelled image, its 8 timesteps folded:
8 x H^2 pixels) three ways from the same seeded weights, image and feature
noise:

* fp64: the backbone (its kernels' plain versions), the head, its
  BatchNorms and the loss in fp64 (the port's modules with every cast to
  fp32 made a cast to fp64) and autograd;
* fp32, one row shard: ``trainers.common.make_train_step`` in one process;
* fp32, two row shards: the same step on 2 gloo ranks over a (1, 2) data x
  spatial mesh with ``--shard_spatial`` (each rank's features over its half
  of the rows, BatchNorm's sums over both), rank 0's gradients.

For each fp32 way it prints the largest difference of each gradient from
fp64, relative to the fp64 tensor's largest entry, at ``1.weight`` (the
first 1x1 conv's) and at the worst tensor, and writes them to ``--out``.
If both land at the same size, the two ways differ by rounding alone. To
split each way's error between the features and the head, also: each way's
fp32 features against the fp64 ones, the fp64 head on each way's fp32
features against the fp64 step, and each fp32 head against the fp64 head
on the same features. The head's ReLUs make its gradient jump where a
unit's input sits within rounding of 0: each fp32 way's ReLU decisions
are counted where they differ from the fp64 head's on the same features,
and each fp32 head is also held against the fp64 head on its features
with its own ReLU decisions (the head's rounding with the jumps taken out);
likewise the fp64 head's decisions on each way's fp32 features against its
decisions on the fp64 features.

    python scripts/port/sp_head_fp64.py --out sp_head_fp64.json
        # the CPU at dim 16 (the head's 240 channels), 128^2
    python scripts/port/sp_head_fp64.py --device cuda --dim 64 --out ...
        # the card at the default widths (960 channels), phase 20's step
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

SEED = 0


def config(dim: int, size: int):
    from tedm_tpu_torch.config import config_from_args

    return config_from_args(["--experiment", "TEDM", "--dim", str(dim), "--img_size", str(size), "--seed", str(SEED),
                             "--log_dir", tempfile.gettempdir()])


def inputs(cfg) -> dict:
    """Seeded backbone and head weights, a labelled image and its feature
    noise (one row a timestep)."""
    from tedm_tpu_torch.data.datasets import SyntheticCXRDataset
    from tedm_tpu_torch.models.unet import Unet
    from tedm_tpu_torch.trainers.common import init_seeded, to_nchw

    img, mask = SyntheticCXRDataset("train", 1, cfg.img_size, labelled=True, seed=SEED)[0]
    s = len(cfg.t_steps_to_save)
    rs = np.random.RandomState(SEED + 19)
    return {
        "backbone": init_seeded(SEED, lambda: Unet(dim=cfg.dim, dim_mults=tuple(cfg.dim_mults))).state_dict(),
        "classifier": init_seeded(SEED + 1, lambda: head(cfg)).state_dict(),
        "img": to_nchw(img[None], "cpu"), "mask": to_nchw(mask[None], "cpu"),
        "noise": torch.from_numpy(rs.standard_normal((s, 1, cfg.img_size, cfg.img_size)).astype(np.float32)),
    }


def head(cfg):
    from tedm_tpu_torch.models.segmentation import PixelClassifier

    return PixelClassifier(stage_channels=tuple(cfg.dim * m for m in reversed(cfg.dim_mults)), img_size=cfg.img_size,
                           shared=True)


def task_of(cfg, d, device, dp=None, plain=False):
    """The head's task; ``plain``: the backbone through the kernels' plain
    versions (no kernel takes fp64)."""
    from tedm_tpu_torch.models.unet import Unet
    from tedm_tpu_torch.ops.schedules import make_schedule
    from tedm_tpu_torch.trainers.datasetdm import SegTask

    unet = Unet(dim=cfg.dim, dim_mults=tuple(cfg.dim_mults), fused_groupnorm=not plain, use_pallas=not plain)
    unet.load_state_dict(d["backbone"])
    unet = unet.to(device).eval().requires_grad_(False)
    clf = head(cfg)
    clf.load_state_dict(d["classifier"])
    clf.to(device)
    task = SegTask(unet=unet, classifier=clf if dp is None else dp.wrap(clf, find_unused=True),
                   sched=make_schedule(cfg.timesteps, cfg.beta_schedule).to(device), t_steps=tuple(cfg.t_steps_to_save),
                   normalize=True, fold=len(cfg.t_steps_to_save))
    return task, clf


@contextlib.contextmanager
def relus(clf, masks=None):
    """Record the head's ReLU decisions (input > 0, this rank's rows) into
    the list it yields; with ``masks`` (one a ReLU, whole maps) each ReLU
    takes its decisions from them instead of from its input."""
    seen, mods = [], [m for m in clf.modules() if isinstance(m, torch.nn.ReLU)]
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append((i[0] > 0).cpu())) for m in mods]
    if masks is not None:
        for m, k in zip(mods, masks):
            m.forward = lambda x, k=k: x * k.to(x.device, x.dtype)
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()
        for m in mods:
            m.__dict__.pop("forward", None)


def fp32_step(cfg, d, device, dp=None) -> tuple:
    """The head's gradients after one fp32 step (one process, or this rank's
    under ``dp``'s spatial plan), and its ReLU decisions."""
    from tedm_tpu_torch.trainers.common import make_train_step

    task, clf = task_of(cfg, d, device, dp)
    step = make_train_step(task, torch.optim.Adam(clf.parameters(), lr=1e-4), (), dp)
    with relus(clf) as seen:
        step(d["img"].to(device), d["mask"].to(device), torch.ones(1, device=device), noise=d["noise"].to(device))
    return {n: p.grad.double().cpu() for n, p in clf.named_parameters()}, seen


@contextlib.contextmanager
def in_fp64(module):
    """Every ``Tensor.float()`` a cast to fp64, and ``module``'s convs
    computing in fp64."""
    cast = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: self.double()
    old = {m: m.compute_dtype for m in module.modules() if hasattr(m, "compute_dtype")}
    for m in old:
        m.compute_dtype = torch.float64
    try:
        yield
    finally:
        torch.Tensor.float = cast
        for m, dt in old.items():
            m.compute_dtype = dt


def features(cfg, d, device, fp64=False) -> list:
    """The backbone's fp32 features of the image (whole maps: under a
    spatial plan each rank's rows, gathered along H), or with ``fp64`` its
    fp64 features in one process."""
    from tedm_tpu_torch.models.segmentation import extract_features
    from tedm_tpu_torch.parallel import mesh, spatial

    task, _ = task_of(cfg, d, device, plain=fp64)
    if fp64:
        task.unet.double()
        with torch.no_grad(), in_fp64(task.unet):
            return extract_features(task.unet, task.sched, d["img"].to(device).double(), task.t_steps,
                                    noise=d["noise"].to(device).double())
    plan = spatial.plan_for(mesh.spatial_plan(), cfg.img_size, len(cfg.dim_mults) - 1)
    with torch.no_grad(), spatial.sharded(plan):
        feats = extract_features(task.unet, task.sched, spatial.local_rows(d["img"].to(device)), task.t_steps,
                                 noise=spatial.local_rows(d["noise"].to(device)))
        return [spatial.gather_h(f) for f in feats]


def fp64_step(cfg, d, device, feats, masks=None) -> tuple:
    """The head's gradients in fp64 on ``feats`` (its ReLUs' decisions
    ``masks`` where given), and its ReLU decisions."""
    from tedm_tpu_torch.parallel import mesh
    from tedm_tpu_torch.trainers.common import masked_bce_per_image

    task, clf = task_of(cfg, d, device)
    clf.double().train()
    with in_fp64(clf), relus(clf, masks) as seen:
        logits = clf([f.double() for f in feats])
        y, valid = d["mask"].to(device).double().repeat(task.fold, 1, 1, 1), torch.ones(task.fold, device=device)
        per_img, _ = masked_bce_per_image(logits, y, valid)
        mesh.global_share(per_img, valid.double()).backward()
    return {n: p.grad.cpu() for n, p in clf.named_parameters()}, seen


def _rank(rank, cfg, path, device, out):
    import torch.distributed as dist

    from tedm_tpu_torch.parallel import mesh

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out, "store"), 2), rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=600))
    mesh.make_mesh((1, 2), ("data", "spatial"))
    d = torch.load(path, weights_only=False)
    grads, seen = fp32_step(cfg, d, device, mesh.DataParallel("replicated", shard_spatial=True))
    feats = features(cfg, d, device)
    torch.save({"grads": grads, "feats": [f.cpu() for f in feats], "relus": seen}, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def errors(got: dict, want: dict) -> dict:
    rel = {n: ((got[n] - w).abs().max() / w.abs().max().clamp(min=1e-300)).item() for n, w in want.items()}
    worst = max(rel, key=rel.get)
    return {"1.weight": rel["1.weight"], "worst": worst, "worst_err": rel[worst]}


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cpu")
    p.add_argument("--dim", type=int, default=16)
    p.add_argument("--img_size", type=int, default=128)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg = config(args.dim, args.img_size)
    d = inputs(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "inputs.pt")
        torch.save(d, path)
        ctx = torch.multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_rank, args=(r, cfg, path, args.device, tmp)) for r in range(2)]
        for proc in procs:
            proc.start()
        for proc in procs:
            proc.join(1200)
        if any(proc.exitcode for proc in procs):
            raise SystemExit(f"the 2-rank step failed: exit codes {[proc.exitcode for proc in procs]}")
        two, two_1 = (torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(2))
    two_relus = [torch.cat(halves, dim=2) for halves in zip(two["relus"], two_1["relus"])]  # whole maps
    one, one_relus = fp32_step(cfg, d, args.device)
    feats = features(cfg, d, args.device)
    feats64 = features(cfg, d, args.device, fp64=True)
    two_feats = [f.to(args.device) for f in two["feats"]]
    ref64, ref64_relus = fp64_step(cfg, d, args.device, feats64)
    ref, ref_relus = fp64_step(cfg, d, args.device, feats)
    ref_two, ref_two_relus = fp64_step(cfg, d, args.device, two_feats)
    ref_same, _ = fp64_step(cfg, d, args.device, feats, one_relus)
    ref_two_same, _ = fp64_step(cfg, d, args.device, two_feats, two_relus)
    ref_on_64, _ = fp64_step(cfg, d, args.device, feats, ref64_relus)
    ref_two_on_64, _ = fp64_step(cfg, d, args.device, two_feats, ref64_relus)
    flips = lambda a, b: [int((x != y).sum()) for x, y in zip(a, b)]
    rel = lambda a, b: max(((x.cpu().double() - y.cpu().double()).abs().max() / y.abs().max()).item()
                           for x, y in zip(a, b))
    res = {"device": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu", "dim": cfg.dim,
           "img_size": cfg.img_size, "pixels": len(cfg.t_steps_to_save) * cfg.img_size ** 2,
           "head_channels": sum(cfg.dim * m for m in cfg.dim_mults),
           # against the step all in fp64 (the backbone's features too)
           "one_shard_vs_fp64": errors(one, ref64), "two_shards_vs_fp64": errors(two["grads"], ref64),
           "two_shards_vs_one_shard": errors(two["grads"], one),
           # the split: each way's fp32 features against fp64 ones, the fp64 head on each way's fp32
           # features against the fp64 step, and each fp32 head against the fp64 head on its own features
           "features_one_vs_fp64": rel(feats, feats64), "features_two_vs_fp64": rel(two["feats"], feats64),
           "fp64_head_on_one_shard_features": errors(ref, ref64),
           "fp64_head_on_two_shard_features": errors(ref_two, ref64),
           "one_shard_head_rounding": errors(one, ref), "two_shard_head_rounding": errors(two["grads"], ref_two),
           # the ReLU units (of each ReLU) whose fp32 decision differs from the fp64 head's on the same
           # features, and each fp32 head against the fp64 head on its features with its own decisions
           "relu_units": [int(k.numel()) for k in one_relus],
           "relu_flips_one_shard": flips(one_relus, ref_relus), "relu_flips_two_shards": flips(two_relus, ref_two_relus),
           "one_shard_head_rounding_same_relus": errors(one, ref_same),
           "two_shard_head_rounding_same_relus": errors(two["grads"], ref_two_same),
           # the same split for the features: the fp64 head's ReLU decisions on each way's fp32 features
           # against its decisions on the fp64 features, and the fp64 head on each way's fp32 features
           # with the decisions it takes on the fp64 ones, against the fp64 step
           "relu_flips_one_shard_features": flips(ref_relus, ref64_relus),
           "relu_flips_two_shard_features": flips(ref_two_relus, ref64_relus),
           "fp64_head_on_one_shard_features_fp64_relus": errors(ref_on_64, ref64),
           "fp64_head_on_two_shard_features_fp64_relus": errors(ref_two_on_64, ref64)}
    print(json.dumps(res, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
