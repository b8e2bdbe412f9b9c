"""Typed experiment configuration: the port's own copy of ``tedm_tpu.config``.

The fields, defaults, JSON form and presets are identical to the JAX
package's, so a ``config.json`` written by either package loads unchanged in
the other. Fields that only the JAX package reads (mesh, sharding,
``attn_layout``) are kept as plain keys for that reason; the port ignores
them. The kernel switches map to the port's kernels: ``use_pallas`` (off
under ``--no_pallas``) to the linear-attention kernels B.1 and B.2,
``use_pallas_{groupnorm,resblock,flash}`` to the opt-in B.3, B.4 and B.5.

It mirrors the reference's global argparse parser (reference:
config.py:13-84) and the post-parse experiment presets applied by its
dispatcher (reference: train.py:23-48), as a frozen dataclass that is:

* JSON-serializable (embedded beside every checkpoint);
* diffable (``diff_configs`` reports changed/new/removed keys on checkpoint
  load, like ``compare_configs`` — reference: trainers/utils.py:154-174);
* parsed from the same command line (``build_parser``, ``config_from_args``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Dict, Optional, Sequence, Tuple

EXPERIMENTS = (
    "img_only",       # DDPM backbone training (CXR14)  (reference: train.py:35-36)
    "joint",          # joint img+seg DDPM on JSRT       (reference: trainers/train_base_diffusion.py:26)
    "conditional",    # seg DDPM conditioned on img      (reference: trainers/train_base_diffusion.py:27-30;
                      #   the reference UNet silently ignored cond — here conditioning
                      #   is real, via channel concat)
    "joint_and_cond", # img DDPM conditioned on seg      (reference: trainers/train_base_diffusion.py:31-32
                      #   — broken there: reads config.joint_training which no config
                      #   defines, and its cond was ignored by the UNet. Implemented
                      #   here as the clearly-intended p(img | seg) mirror of
                      #   "conditional", with real channel-concat conditioning)
    "baseline",       # supervised UNet on JSRT          (reference: train.py:37-38)
    "LEDM",           # datasetDM, t=[50,150,250]        (reference: train.py:39-41)
    "LEDMe",          # datasetDM, 8 timesteps           (reference: train.py:42-44)
    "TEDM",           # shared-weights-over-timesteps    (reference: train.py:45-48)
    "PDDM",           # per-step linear probe            (reference: trainers/datasetDM_per_step.py)
    "global_cl",      # SimCLR pretraining on CXR14      (reference: train.py:49-50)
    "local_cl",       # local region-contrastive         (reference: train.py:51-52)
    "global_finetune",    # finetune GlobalCL encoder    (reference: train.py:53-54)
    "glob_loc_finetune",  # finetune Global+Local CL     (reference: train.py:55-56)
)

DATASETS = ("JSRT", "CXR14")
N_LABELLED_CHOICES = (197, 98, 49, 24, 12, 6, 3, 1)  # reference: config.py:79-80


def _default_logdir() -> str:
    return os.path.join(os.getcwd(), "logs", datetime.now().strftime("%Y%m%d_%H%M%S"))


@dataclass(frozen=True)
class Config:
    """All experiment hyperparameters. Defaults mirror reference config.py:13-84."""

    # Run control
    debug: bool = False
    mixed_precision: bool = False   # bf16 compute on TPU when True (reference AMP was broken; see SURVEY §2.2)
    resume_path: Optional[str] = None

    # Experiment
    experiment: str = "img_only"
    dataset: str = "JSRT"

    # Data
    img_size: int = 128
    data_dir: Optional[str] = None
    splits_dir: Optional[str] = None  # dir holding the split CSVs; None = the
                                      # verbatim reference CSVs shipped in
                                      # tedm_tpu/data/splits (reference reads
                                      # PROJECT_DIR/data, dataloaders/JSRT.py:29)
    num_workers: int = 4            # prefetch threads in the input pipeline

    # Model
    dim: int = 64
    dim_mults: Tuple[int, ...] = (1, 2, 4, 8)
    channels: int = 1
    out_channels: int = 1

    # Diffusion
    timesteps: int = 1000
    beta_schedule: str = "cosine"           # 'linear' | 'cosine'
    objective: str = "pred_noise"           # 'pred_noise' | 'pred_x_0'
    dynamic_threshold_percentile: float = 0.995
    ddim_steps: int = 0                     # >0: DDIM fast sampling with this many
                                            # steps wherever full trajectories are
                                            # sampled (val grids, conditional eval);
                                            # 0 = reference-faithful ancestral T steps

    # Contrastive learning
    tau: float = 0.1
    global_model_path: Optional[str] = None
    glob_loc_model_path: Optional[str] = None
    unfreeze_weights_at_step: int = 0
    augment_at_finetuning: bool = False

    # Training
    batch_size: int = 16
    lr: float = 1e-4
    weight_decay: float = 0.0
    ema_decay: float = 0.0         # >0: keep an EMA of the diffusion backbone
                                   # params (updated inside the jitted step);
                                   # validation/sampling and downstream
                                   # feature extraction use the EMA weights.
                                   # 0 = reference-faithful (no averaging)
    serve_raw_params: bool = False # load the RAW (non-EMA) weights from an
                                   # --ema_decay checkpoint in downstream
                                   # loaders — the controlled EMA-vs-raw A/B
                                   # on one backbone (both weight sets live
                                   # in the same checkpoint)
    max_steps: int = 500_000
    p2_loss_weight_gamma: float = 0.0
    p2_loss_weight_k: float = 1.0
    seed: int = 0

    # Logging / validation
    log_freq: int = 100
    val_freq: int = 100
    val_steps: int = 250           # timesteps used in diffusion val_step
    log_dir: str = field(default_factory=_default_logdir)
    n_sampled_imgs: int = 8
    max_val_steps: int = -1
    ckpt_every: int = 0            # periodic checkpointing (0 = best-val only, as reference)

    # datasetDM / TEDM
    saved_diffusion_model: str = "logs/CXR14/best"
    t_steps_to_save: Tuple[int, ...] = (50, 200, 400, 600, 800)
    n_labelled_images: Optional[int] = None
    shared_weights_over_timesteps: bool = False
    early_stop: bool = False
    standardize_features: bool = False  # PDDM probe: actually standardize (ref computed then discarded, datasetDM_per_step.py:30-31)

    # Input normalization to [-1, 1] before diffusion (reference: train.py:23)
    normalize: bool = True
    # Reproduce the reference's UNNORMALIZED feature extraction: its
    # DatasetDM.extract_features calls forward_diffusion_model directly
    # (reference: models/datasetDM_model.py:77), bypassing the [0,1]->[-1,1]
    # normalize that only lives in DiffusionModel.forward
    # (diffusion_model.py:169) — so the frozen backbone receives
    # feature-extraction inputs at half the dynamic range it was trained on.
    # tedm_tpu normalizes by default (the fix); this switch restores the
    # reference behavior for parity experiments (see RESULTS_parity.md).
    extract_unnormalized: bool = False

    # TPU-native extensions (no reference equivalent; SURVEY §2.3)
    mesh_shape: Tuple[int, ...] = ()      # () = all local devices on one 'data' axis
    mesh_axes: Tuple[str, ...] = ("data",)
    param_sharding: str = "replicated"    # 'replicated' | 'tp' (wide convs over 'model')
                                          # | 'fsdp' (params+Adam state over 'data', ZeRO-3)
    tp_min_width: int = 256               # TP: only shard kernels with out-channels >= this
    fsdp_min_size: int = 2 ** 14          # FSDP: only shard leaves with >= this many elements
    shard_spatial: bool = False           # SP: shard the batch H axis over a 'spatial'
                                          # mesh axis (conv halo exchange by GSPMD;
                                          # activation-memory lever for 512²+)
    use_pallas: bool = True               # fused Pallas kernels where available (TPU only)
    use_pallas_groupnorm: bool = False    # fused GroupNorm+FiLM+SiLU kernel (opt-in:
                                          # measured slower at 128² — see docs/DESIGN.md)
    use_pallas_resblock: bool = False     # fused whole-ResnetBlock kernel
                                          # (conv3x3+GN+FiLM+SiLU ×2 + residual
                                          # in one kernel; see docs/DESIGN.md)
    use_pallas_flash: bool = False        # flash-cosine mid attention (opt-in:
                                          # loses to XLA einsum for N<=4096,
                                          # i.e. every img_size <= 512)
    attn_layout: str = "heads_major"      # linear-attention einsum layout of JAX's plain
                                          # path ('heads_major' | 'nhwc'; measured equal on
                                          # v5e); the port reads it nowhere: both orders
                                          # compute the same values, and its plain path
                                          # (--no_pallas) has one einsum order
    synthetic_data: bool = False          # deterministic synthetic CXR data (no image files needed)
    data_backend: str = "threads"         # input pipeline: 'threads' | 'grain'
                                          # | 'device' (synthetic generated
                                          # on-accelerator; host ships indices)
                                          # (same batch contract; grain adds
                                          # checkpointable deterministic iterators)
    profile_dir: Optional[str] = None     # jax.profiler trace output (steps ~10-15)
    multihost: bool = False               # call jax.distributed.initialize() at startup
    remat: bool = False                   # block-level activation remat
                                          # (nn.remat per ResnetBlock/attn;
                                          # required to train 512²+)
                                          # (trade ~1 extra fwd for O(1) activation memory;
                                          # enables larger batch/resolution)
    grad_accum: int = 1                   # gradient accumulation: split the
                                          # global batch into N microbatches
                                          # scanned inside the ONE jitted
                                          # step (activation memory ~1/N).
                                          # Loss/grads equal the GLOBAL
                                          # masked mean over the same
                                          # per-microbatch t/noise draws (up
                                          # to float reassociation) — NOT
                                          # bit-identical to a grad_accum=1
                                          # run at the same seed, since RNG
                                          # is folded per microbatch.

    # ---------------------------------------------------------------- helpers

    def __post_init__(self) -> None:
        # ema_decay >= 1.0 would make the EMA lerp a no-op: ema_params would
        # silently stay at the init weights and every downstream loader
        # (validation, datasetdm.load_backbone, serving) would serve
        # untrained weights with no error. Fail fast instead.
        if not (0.0 <= self.ema_decay < 1.0):
            raise ValueError(
                f"ema_decay must be in [0, 1), got {self.ema_decay} "
                "(>= 1.0 would freeze the EMA at the init weights)"
            )
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {self.grad_accum}")
        if self.grad_accum > 1 and self.batch_size % self.grad_accum != 0:
            raise ValueError(
                f"batch_size ({self.batch_size}) must be divisible by "
                f"grad_accum ({self.grad_accum}) — microbatches are a "
                "static reshape of the global batch"
            )

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        for k, v in d.items():
            if isinstance(v, tuple):
                d[k] = list(v)
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        names = {f.name: f for f in dataclasses.fields(cls)}
        kw = {}
        for k, v in d.items():
            if k not in names:
                continue  # forward-compat: ignore unknown keys
            if isinstance(v, list):
                v = tuple(v)
            kw[k] = v
        return cls(**kw)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_json(f.read())

    def apply_experiment_preset(self) -> "Config":
        """Post-parse mutations the reference dispatcher applies (train.py:23-48)."""
        c = self.replace(normalize=True, channels=1, out_channels=1)
        if c.experiment == "JSRT_baseline":
            # the reference README documents this name but its parser only
            # accepts 'baseline' (README.md:24 vs config.py:19-29)
            c = c.replace(experiment="baseline")
        exp = c.experiment
        if exp == "LEDM":
            c = c.replace(t_steps_to_save=(50, 150, 250))
        elif exp == "LEDMe":
            c = c.replace(t_steps_to_save=(1, 10, 25, 50, 200, 400, 600, 800))
        elif exp == "TEDM":
            c = c.replace(
                shared_weights_over_timesteps=True,
                t_steps_to_save=(1, 10, 25, 50, 200, 400, 600, 800),
            )
        # logdir convention logs/<experiment>/<n_labelled>/<timestamp>
        # (reference: train.py:24; img_only gets logs/CXR14/<timestamp>,
        # reference: trainers/train_CXR14.py:119)
        parent = os.path.dirname(c.log_dir.rstrip("/"))
        base = os.path.basename(c.log_dir.rstrip("/"))
        if exp == "img_only":
            c = c.replace(log_dir=os.path.join(parent, "CXR14", base))
        else:
            c = c.replace(
                log_dir=os.path.join(parent, exp, str(c.n_labelled_images), base)
            )
        return c

    @property
    def feature_channels_per_step(self) -> int:
        """Decoder feature channels per diffusion timestep: sum of up-stage widths.

        dim * sum(reversed(dim_mults)) = 512+256+128+64 = 960 at defaults
        (reference: models/datasetDM_model.py:50-83; verified empirically).
        """
        return self.dim * sum(self.dim_mults)

    @property
    def n_feature_steps(self) -> int:
        return len(self.t_steps_to_save)


MISSING = "<missing>"


def diff_configs(old, new, printer=print) -> Dict[str, Tuple[Any, Any]]:
    """Report changed/new/removed keys between two configs (reference:
    trainers/utils.py:154-174). Accepts Config instances or raw dicts, so
    checkpoints written by older framework versions diff cleanly. Returns
    {key: (old_value, new_value)} with the MISSING sentinel on the absent
    side for added/removed keys."""
    c_old = old.to_dict() if hasattr(old, "to_dict") else dict(old)
    c_new = new.to_dict() if hasattr(new, "to_dict") else dict(new)
    changed: Dict[str, Tuple[Any, Any]] = {}
    for k, v in c_old.items():
        if k in c_new and c_new[k] != v:
            printer(f"{k} differs - old: {v} new: {c_new[k]}")
            changed[k] = (v, c_new[k])
    for k, v in c_new.items():
        if k not in c_old:
            printer(f"{k} is new - {v}")
            changed[k] = (MISSING, v)
    for k, v in c_old.items():
        if k not in c_new:
            printer(f"{k} is removed - {v}")
            changed[k] = (v, MISSING)
    return changed


def build_parser() -> argparse.ArgumentParser:
    """The JAX package's argparse CLI, flag for flag and default for default
    (reference: config.py:13-84). The port rejects at dispatch the flags of
    features it does not have yet (``tedm_tpu_torch.train``)."""
    p = argparse.ArgumentParser(description="tedm_tpu_torch experiment runner")
    defaults = Config()
    p.add_argument("--debug", action="store_true")
    p.add_argument("--mixed_precision", action="store_true",
                   help="bf16 compute on TPU (actually functional, unlike reference AMP)")
    p.add_argument("--resume_path", type=str, default=None)
    p.add_argument("--experiment", type=str, default=defaults.experiment,
                   choices=list(EXPERIMENTS) + ["JSRT_baseline"])
    p.add_argument("--dataset", type=str, default=defaults.dataset, choices=list(DATASETS))
    p.add_argument("--img_size", type=int, default=defaults.img_size)
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--splits_dir", type=str, default=None,
                   help="dir with the split CSVs (default: bundled reference CSVs)")
    p.add_argument("--num_workers", type=int, default=defaults.num_workers)
    p.add_argument("--dim", type=int, default=defaults.dim)
    p.add_argument("--dim_mults", nargs="+", type=int, default=list(defaults.dim_mults))
    p.add_argument("--timesteps", type=int, default=defaults.timesteps)
    p.add_argument("--beta_schedule", type=str, default=defaults.beta_schedule,
                   choices=["linear", "cosine"])
    p.add_argument("--objective", type=str, default=defaults.objective,
                   choices=["pred_noise", "pred_x_0"])
    p.add_argument("--tau", type=float, default=defaults.tau)
    p.add_argument("--global_model_path", type=str, default=None)
    p.add_argument("--glob_loc_model_path", type=str, default=None)
    p.add_argument("--unfreeze_weights_at_step", type=int,
                   default=defaults.unfreeze_weights_at_step)
    p.add_argument("--augment_at_finetuning", action="store_true")
    p.add_argument("--batch_size", type=int, default=defaults.batch_size)
    p.add_argument("--lr", type=float, default=defaults.lr)
    p.add_argument("--weight_decay", type=float, default=defaults.weight_decay)
    p.add_argument("--ema_decay", type=float, default=defaults.ema_decay,
                   help="EMA decay for diffusion backbone params (0 "
                        "disables). Measured A/B (RESULTS_parity.md): use "
                        "0.9999 when total steps >> the averaging horizon "
                        "1/(1-decay) — +2..+4 Dice x100 at 10k steps; "
                        "HARMFUL at short budgets (-0.3..-0.7 at 400-2000 "
                        "steps), leave off for short fine-tunes")
    p.add_argument("--serve_raw_params", action="store_true",
                   help="serve the raw (non-EMA) weights from an --ema_decay "
                        "checkpoint in downstream loaders (EMA-vs-raw A/B)")
    p.add_argument("--max_steps", type=int, default=defaults.max_steps)
    p.add_argument("--p2_loss_weight_gamma", type=float, default=defaults.p2_loss_weight_gamma)
    p.add_argument("--p2_loss_weight_k", type=float, default=defaults.p2_loss_weight_k)
    p.add_argument("--seed", type=int, default=defaults.seed)
    p.add_argument("--log_freq", type=int, default=defaults.log_freq)
    p.add_argument("--val_freq", type=int, default=defaults.val_freq)
    p.add_argument("--val_steps", type=int, default=defaults.val_steps)
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--n_sampled_imgs", type=int, default=defaults.n_sampled_imgs)
    p.add_argument("--max_val_steps", type=int, default=defaults.max_val_steps)
    p.add_argument("--ckpt_every", type=int, default=defaults.ckpt_every)
    p.add_argument("--saved_diffusion_model", type=str, default=defaults.saved_diffusion_model)
    p.add_argument("--t_steps_to_save", type=int, nargs="*",
                   default=list(defaults.t_steps_to_save))
    p.add_argument("--n_labelled_images", type=int, default=None,
                   choices=list(N_LABELLED_CHOICES))
    p.add_argument("--shared_weights_over_timesteps", action="store_true")
    p.add_argument("--early_stop", action="store_true")
    p.add_argument("--standardize_features", action="store_true")
    p.add_argument("--extract_unnormalized", action="store_true",
                   help="reference-parity: skip the [0,1]->[-1,1] normalize in "
                        "feature extraction (the reference's datasetDM defect)")
    p.add_argument("--mesh_shape", nargs="*", type=int, default=[])
    p.add_argument("--mesh_axes", nargs="*", type=str, default=["data"])
    p.add_argument("--param_sharding", type=str, default=defaults.param_sharding,
                   choices=["replicated", "tp", "fsdp"])
    p.add_argument("--tp_min_width", type=int, default=defaults.tp_min_width,
                   help="TP: only shard kernels whose out-channel dim is >= this")
    p.add_argument("--fsdp_min_size", type=int, default=defaults.fsdp_min_size,
                   help="FSDP: only shard param leaves with >= this many elements")
    p.add_argument("--shard_spatial", action="store_true",
                   help="SP: shard the batch H axis over a 'spatial' mesh axis "
                        "(e.g. --mesh_shape 2 4 --mesh_axes data spatial)")
    p.add_argument("--no_pallas", action="store_true", help="disable Pallas kernels")
    p.add_argument("--use_pallas_groupnorm", action="store_true",
                   help="fused GroupNorm+FiLM+SiLU kernel (opt-in; re-measure per shape)")
    p.add_argument("--use_pallas_resblock", action="store_true",
                   help="fused whole-ResnetBlock Pallas kernel")
    p.add_argument("--use_pallas_flash", action="store_true",
                   help="flash-cosine Pallas kernel for the mid attention "
                   "(opt-in; measured slower than XLA for img_size <= 512)")
    p.add_argument("--attn_layout", type=str, default=defaults.attn_layout,
                   choices=["heads_major", "nhwc"],
                   help="linear-attention einsum layout of the JAX package's plain path "
                   "(measured equal on v5e); the port computes the same values under either")
    p.add_argument("--synthetic_data", action="store_true")
    p.add_argument("--data_backend", type=str, default=defaults.data_backend,
                   choices=["threads", "grain", "device"],
                   help="input pipeline backend (same batch contract)")
    p.add_argument("--profile_dir", type=str, default=None)
    p.add_argument("--multihost", action="store_true",
                   help="multi-host: jax.distributed.initialize() at startup")
    p.add_argument("--remat", action="store_true",
                   help="block-level activation rematerialization (nn.remat "
                        "per ResnetBlock/attention block; required to fit "
                        "512^2+ training in HBM)")
    p.add_argument("--ddim_steps", type=int, default=0,
                   help="DDIM fast sampling steps (0 = full ancestral)")
    p.add_argument("--grad_accum", type=int, default=defaults.grad_accum,
                   help="accumulate gradients over N microbatches scanned "
                        "inside the jitted train step (activation memory "
                        "~1/N at the same global batch; composes with "
                        "--remat and every sharding mode)")
    return p


def config_from_args(argv: Optional[Sequence[str]] = None) -> Config:
    args = build_parser().parse_args(argv)
    d = vars(args).copy()
    d["use_pallas"] = not d.pop("no_pallas")
    if d.get("log_dir") is None:
        d["log_dir"] = _default_logdir()
    for k in ("dim_mults", "t_steps_to_save", "mesh_shape", "mesh_axes"):
        d[k] = tuple(d[k])
    cfg = Config(**{k: v for k, v in d.items() if k in {f.name for f in dataclasses.fields(Config)}})
    return cfg.apply_experiment_preset()
