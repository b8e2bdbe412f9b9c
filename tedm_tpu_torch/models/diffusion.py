"""The DDPM process over a UNet apply function (port of
``tedm_tpu/models/diffusion.py``).

Behaviour of the reference DiffusionModel (models/diffusion_model.py:50-301):
epsilon prediction with an L1 loss and p2 reweighting, ancestral sampling
with the clipped posterior log-variance and Imagen-style dynamic
thresholding at the 0.995 quantile. Images are NCHW.

Randomness is explicit: the losses and the samplers take their timesteps
and noise as tensors, or draw them from a ``torch.Generator`` on the
images' device. The JAX package draws from split PRNG keys instead; the two
never agree, so the tests hand JAX's draws to the port.

The JAX package runs the 1000-step reverse trajectory as one ``lax.scan``;
here it is a Python loop of UNet calls under ``torch.no_grad``, and so are
DDIM and DPM-Solver++(2M) over a subsequence of the steps. Their x_T (and
DDIM's per-step noise) are arguments, or are drawn from a generator; their
per-step coefficients are computed in fp32 from the schedule, in the JAX
package's order, on the host.

Under ``--mixed_precision`` the UNet returns bf16 while the images, the
noise and the sampler's x stay fp32, as in the JAX package: the losses take
the error in fp32, and a (B, 1, 1, 1) fp32 coefficient times a bf16 output
promotes to fp32 in PyTorch as in JAX.

Under spatial parallelism (``parallel/spatial.py``) the losses take this
rank's rows of the images: their noise is drawn for the whole map and cut
to them, and each image's mean over its pixels adds the ranks' sums. The
samplers draw alike, and dynamic thresholding takes the quantile of the
whole image.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from tedm_tpu_torch.ops.schedules import DiffusionSchedule, extract, gather
from tedm_tpu_torch.parallel import spatial

# An apply function: (x_t, t) -> model output (epsilon or x_0 prediction).
ApplyFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def normalize_to_neg_one_to_one(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0 - 1.0


def unnormalize_to_zero_to_one(x: torch.Tensor) -> torch.Tensor:
    return (x + 1.0) * 0.5


def _randn(shape: Sequence[int], like: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Noise of ``like``'s device and dtype for a map of ``shape`` (this
    rank's rows under a spatial plan, drawn whole and cut)."""
    return spatial.randn(shape, generator, like.device, like.dtype)


def q_sample(
    sched: DiffusionSchedule, x_0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor
) -> torch.Tensor:
    """x_t = sqrt(a_bar_t) x_0 + sqrt(1-a_bar_t) eps
    (reference: models/diffusion_model.py:176-203). ``sched`` lies on x_0's device."""
    a = extract(sched.sqrt_alphas_cumprod, t, x_0.ndim)
    b = extract(sched.sqrt_one_minus_alphas_cumprod, t, x_0.ndim)
    return a * x_0 + b * noise


def predict_x0_from_noise(sched: DiffusionSchedule, x_t, t, noise) -> torch.Tensor:
    """(reference: models/diffusion_model.py:269-286)"""
    return (
        extract(sched.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
        - extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * noise
    )


def predict_noise_from_x0(sched: DiffusionSchedule, x_t, t, x_0) -> torch.Tensor:
    """(reference: models/diffusion_model.py:288-301)"""
    return (
        extract(sched.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t - x_0
    ) / extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.ndim)


def q_posterior(
    sched: DiffusionSchedule, x_0: torch.Tensor, x_t: torch.Tensor, t: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior q(x_{t-1} | x_t, x_0) mean and clipped log-variance
    (reference: models/diffusion_model.py:259-267)."""
    mean = (
        extract(sched.posterior_mean_coef1, t, x_t.ndim) * x_0
        + extract(sched.posterior_mean_coef2, t, x_t.ndim) * x_t
    )
    return mean, extract(sched.posterior_log_variance_clipped, t, x_t.ndim)


def _quantile_via_topk(flat: torch.Tensor, percentile: float) -> torch.Tensor:
    """Exact linear-interpolated ``percentile`` quantile of each row of
    ``flat`` (B, n) from its top-k order statistics: for the high
    percentiles of dynamic thresholding (0.995: the top 83 of 16384 pixels)
    a top-k replaces the full sort of ``torch.quantile``."""
    n = flat.shape[1]
    pos = percentile * (n - 1)
    i_lo = int(pos)
    frac = pos - i_lo
    k = n - i_lo  # elements from the top covering order stats i_lo, i_lo+1
    top = torch.topk(flat, k, dim=1).values  # descending
    v_lo = top[:, k - 1]
    if frac == 0.0:
        return v_lo
    v_hi = top[:, k - 2] if k >= 2 else v_lo
    return v_lo * (1.0 - frac) + v_hi * frac


def dynamic_threshold(x_0: torch.Tensor, percentile: float) -> torch.Tensor:
    """Imagen dynamic thresholding (reference: models/diffusion_model.py:224-231):
    clip to the per-sample ``percentile`` quantile of |x_0| (floored at 1)
    and rescale into [-1, 1]. Under a spatial plan the quantile is the
    whole image's (``spatial.gather_h``)."""
    flat = spatial.gather_h(x_0).reshape(x_0.shape[0], -1).abs().float()
    if percentile * (flat.shape[1] - 1) >= flat.shape[1] / 2:
        s = _quantile_via_topk(flat, percentile)
    else:
        s = torch.quantile(flat, percentile, dim=1)
    s = s.clamp(min=1.0).to(x_0.dtype).reshape(-1, *((1,) * (x_0.ndim - 1)))
    return torch.clamp(x_0, -s, s) / s


def model_predictions(
    apply_fn: ApplyFn, sched: DiffusionSchedule, x_t, t, objective: str = "pred_noise"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pred_noise, pred_x_0) (reference: models/diffusion_model.py:237-257,
    with the objective consistently named 'pred_x_0')."""
    out = apply_fn(x_t, t)
    if objective == "pred_noise":
        return out, predict_x0_from_noise(sched, x_t, t, out)
    if objective == "pred_x_0":
        return predict_noise_from_x0(sched, x_t, t, out), out
    raise ValueError(f"unknown objective {objective}")


def p_mean_variance(
    apply_fn: ApplyFn,
    sched: DiffusionSchedule,
    x_t: torch.Tensor,
    t: torch.Tensor,
    objective: str = "pred_noise",
    clip_denoised: bool = True,
    dynamic_threshold_percentile: float = 0.995,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(reference: models/diffusion_model.py:221-235)"""
    _, pred_x_0 = model_predictions(apply_fn, sched, x_t, t, objective)
    if clip_denoised:
        pred_x_0 = dynamic_threshold(pred_x_0, dynamic_threshold_percentile)
    mean, log_var = q_posterior(sched, pred_x_0, x_t, t)
    return mean, log_var, pred_x_0


def sample_step(
    apply_fn: ApplyFn,
    sched: DiffusionSchedule,
    x_t: torch.Tensor,
    t: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    objective: str = "pred_noise",
    dynamic_threshold_percentile: float = 0.995,
) -> torch.Tensor:
    """One ancestral reverse step x_t -> x_{t-1} (reference:
    models/diffusion_model.py:205-219); t is (B,) and the noise is masked
    off where t == 0."""
    mean, log_var, _ = p_mean_variance(
        apply_fn, sched, x_t, t, objective, True, dynamic_threshold_percentile
    )
    if noise is None:
        noise = _randn(x_t.shape, x_t, generator)
    nonzero = (t > 0).to(x_t.dtype).reshape(-1, *((1,) * (x_t.ndim - 1)))
    return mean + torch.exp(0.5 * log_var) * noise * nonzero


@torch.no_grad()
def sample_loop_with_snapshots(
    apply_fn: ApplyFn,
    sched: DiffusionSchedule,
    shape: Tuple[int, ...],
    generator: torch.Generator,
    n_snapshots: int = 8,
    objective: str = "pred_noise",
    dynamic_threshold_percentile: float = 0.995,
    dtype: torch.dtype = torch.float32,
    rows: Optional[slice] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full T-step reverse trajectory from x_T ~ N(0, 1), drawn with
    every step's noise from ``generator`` (on the device to sample on).
    Returns (x_0, snapshots (n_snapshots, *shape)); the snapshot of slot i
    is the sample after the step at t = i * (T // n_snapshots), as the
    reference keeps frames at t % stepsize == 0 (trainers/utils.py:88).
    ``rows``: sample those rows of ``shape`` only, every draw made for the
    whole of ``shape`` and cut to them (a rank's share of a batch)."""
    T = sched.num_timesteps
    stepsize = max(T // n_snapshots, 1)
    dev = generator.device
    cut = (lambda a: a) if rows is None else (lambda a: a[rows])
    x = cut(spatial.randn(shape, generator, dev, dtype))
    snaps = torch.zeros((n_snapshots, *x.shape), device=dev, dtype=dtype)
    for t_scalar in range(T - 1, -1, -1):
        t = torch.full((x.shape[0],), t_scalar, dtype=torch.long, device=dev)
        noise = None if rows is None else cut(_randn(shape, x, generator))
        x = sample_step(apply_fn, sched, x, t, noise=noise, generator=generator, objective=objective,
                        dynamic_threshold_percentile=dynamic_threshold_percentile)
        if t_scalar % stepsize == 0:
            snaps[min(t_scalar // stepsize, n_snapshots - 1)] = x
    return x, snaps


def sample_loop(
    apply_fn: ApplyFn,
    sched: DiffusionSchedule,
    shape: Tuple[int, ...],
    generator: torch.Generator,
    objective: str = "pred_noise",
    dynamic_threshold_percentile: float = 0.995,
    dtype: torch.dtype = torch.float32,
    rows: Optional[slice] = None,
) -> torch.Tensor:
    """The final sample in [-1, 1] of the full T-step reverse trajectory
    (of ``rows`` of it, as ``sample_loop_with_snapshots``)."""
    x, _ = sample_loop_with_snapshots(
        apply_fn, sched, shape, generator, 1, objective, dynamic_threshold_percentile, dtype, rows
    )
    return x


def step_grid(num_timesteps: int, n: int) -> List[int]:
    """``n`` timesteps evenly spaced over [0, T-1], descending, as the JAX
    samplers take them: ``jnp.linspace(0, T-1, n)`` in fp32 as XLA
    evaluates it, i * ((T-1) * fp32(1 / (n-1))), which can land an ulp off
    a half, then rounded half to even."""
    if n == 1:
        return [0]
    r = torch.tensor(1.0, dtype=torch.float32) / (n - 1)
    stop = torch.tensor(num_timesteps - 1, dtype=torch.float32)
    grid = torch.cat([torch.arange(n - 1, dtype=torch.float32) * (stop * r), stop[None]])
    return grid.round().long().flip(0).tolist()


class DDIMStep(NamedTuple):
    """One DDIM step: from t to t_prev (-1: the clean state), with
    x <- c_x0 x_0 + c_dir eps (+ sigma noise)."""

    t: int
    t_prev: int
    c_x0: float
    c_dir: float
    sigma: float


def ddim_coefficients(sched: DiffusionSchedule, num_steps: int, eta: float = 0.0) -> List[DDIMStep]:
    """The steps of ``ddim_sample_loop``, their coefficients computed in fp32
    on the host from the schedule, in the JAX package's order."""
    T = sched.num_timesteps
    ts = step_grid(T, num_steps)
    ts_prev = ts[1:] + [-1]
    a_bar = sched.alphas_cumprod.float().cpu()
    a_t = a_bar[ts]
    a_prev = torch.where(torch.tensor(ts_prev) >= 0, a_bar[[max(t, 0) for t in ts_prev]], torch.ones(()))
    sigma = eta * torch.sqrt((1 - a_prev) / (1 - a_t)) * torch.sqrt(1 - a_t / a_prev)
    c_dir = torch.sqrt(torch.clamp(1.0 - a_prev - sigma ** 2, min=0.0)).tolist()
    c_x0 = torch.sqrt(a_prev).tolist()
    return [DDIMStep(*step) for step in zip(ts, ts_prev, c_x0, c_dir, sigma.tolist())]


@torch.no_grad()
def ddim_sample_loop(
    apply_fn: ApplyFn,
    sched: DiffusionSchedule,
    shape: Tuple[int, ...],
    generator: Optional[torch.Generator] = None,
    num_steps: int = 50,
    eta: float = 0.0,
    objective: str = "pred_noise",
    dynamic_threshold_percentile: float = 0.995,
    dtype: torch.dtype = torch.float32,
    x_T: Optional[torch.Tensor] = None,
    noises: Optional[Sequence[torch.Tensor]] = None,
    coefficients: Optional[Sequence[DDIMStep]] = None,
) -> torch.Tensor:
    """DDIM (Song et al. 2021) over ``num_steps`` of the T-step schedule
    (tedm_tpu/models/diffusion.py:241-284), from ``x_T`` ~ N(0, 1), with
    ``noises[i]`` the noise of step i (drawn from ``generator`` when not
    given; none is drawn at ``eta`` 0, where it is multiplied by 0). Each
    step's x_0 is dynamically thresholded and the noise recomputed from it;
    the last step lands on x_0 (t_prev = -1). ``coefficients``: the steps of
    ``ddim_coefficients(sched, num_steps, eta)``, given by a caller that
    traces the loop (a traced program cannot read the schedule on the host).
    Returns the sample in [-1, 1]."""
    steps = coefficients if coefficients is not None else ddim_coefficients(sched, num_steps, eta)
    dev = sched.alphas_cumprod.device
    x = x_T if x_T is not None else spatial.randn(shape, generator, dev, dtype)
    for i, (t, t_prev, c_x0, c_dir, sigma) in enumerate(steps):
        tb = torch.full((shape[0],), t, dtype=torch.long, device=dev)
        _, x_0 = model_predictions(apply_fn, sched, x, tb, objective)
        x_0 = dynamic_threshold(x_0, dynamic_threshold_percentile)
        pred_noise = predict_noise_from_x0(sched, x, tb, x_0)
        x_new = c_x0 * x_0 + c_dir * pred_noise
        if sigma != 0.0 and t_prev >= 0:
            noise = noises[i] if noises is not None else _randn(shape, x, generator)
            x_new = x_new + sigma * noise
        x = x_new.to(dtype)
    return x


class DPMStep(NamedTuple):
    """One DPM-Solver++(2M) step from t_from: D = d_x0 x0 - d_prev x0_prev
    (``None``: D = x0, the first step), then x <- c_x x + c_d D."""

    t_from: int
    d: Optional[Tuple[float, float]]
    c_x: float
    c_d: float


def dpmpp2m_coefficients(sched: DiffusionSchedule, num_steps: int) -> List[DPMStep]:
    """The steps of ``dpmpp2m_sample_loop``, their coefficients computed on
    the host from the schedule, in the JAX package's order."""
    T = sched.num_timesteps
    ts = step_grid(T, num_steps + 1)
    a_bar = sched.alphas_cumprod.float().cpu()
    alpha = torch.sqrt(a_bar)
    sig = torch.sqrt(1.0 - a_bar)
    lam = torch.log(alpha) - torch.log(sig)
    steps = []
    lam_prev_prev = lam[ts[0]]
    for i, (t_from, t_to) in enumerate(zip(ts[:-1], ts[1:])):
        l_from, l_to = lam[t_from], lam[t_to]
        h = l_to - l_from
        d = None
        if i > 0:
            r = (l_from - lam_prev_prev) / h
            d = (float(1.0 + 1.0 / (2.0 * r)), float(1.0 / (2.0 * r)))
        if t_to == 0:
            c_x, c_d = 0.0, 1.0
        else:
            c_x, c_d = float(sig[t_to] / sig[t_from]), float(-(alpha[t_to] * (torch.exp(-h) - 1.0)))
        steps.append(DPMStep(t_from, d, c_x, c_d))
        lam_prev_prev = l_from
    return steps


@torch.no_grad()
def dpmpp2m_sample_loop(
    apply_fn: ApplyFn,
    sched: DiffusionSchedule,
    shape: Tuple[int, ...],
    generator: Optional[torch.Generator] = None,
    num_steps: int = 20,
    objective: str = "pred_noise",
    dynamic_threshold_percentile: float = 0.995,
    dtype: torch.dtype = torch.float32,
    x_T: Optional[torch.Tensor] = None,
    coefficients: Optional[Sequence[DPMStep]] = None,
) -> torch.Tensor:
    """DPM-Solver++(2M) (Lu et al. 2022; tedm_tpu/models/diffusion.py:287-351):
    deterministic second-order multistep sampling in log-SNR time with the
    data prediction, from ``x_T`` (drawn from ``generator`` when not given).
    With lambda = log(alpha / sigma), h_i = lambda_i - lambda_{i-1} and
    r = h_{i-1} / h_i:

        D = (1 + 1/(2r)) x0_i - 1/(2r) x0_{i-1}       (the first step: D = x0)
        x <- (sigma_i / sigma_{i-1}) x - alpha_i (exp(-h_i) - 1) D

    The last step goes to the clean state (sigma 0, alpha 1, exp(-h) 0), as
    DDIM's t_prev = -1. ``coefficients``: the steps of
    ``dpmpp2m_coefficients(sched, num_steps)``, given by a caller that
    traces the loop. Returns the sample in [-1, 1]."""
    steps = coefficients if coefficients is not None else dpmpp2m_coefficients(sched, num_steps)
    dev = sched.alphas_cumprod.device
    x = x_T if x_T is not None else torch.randn(shape, generator=generator, device=dev, dtype=dtype)
    x0_prev = None
    for t_from, d_coef, c_x, c_d in steps:
        tb = torch.full((shape[0],), t_from, dtype=torch.long, device=dev)
        _, x0 = model_predictions(apply_fn, sched, x, tb, objective)
        x0 = dynamic_threshold(x0, dynamic_threshold_percentile)
        d = x0 if d_coef is None else d_coef[0] * x0 - d_coef[1] * x0_prev
        x = (c_x * x + c_d * d).to(dtype)
        x0_prev = x0
    return x


def train_loss(
    apply_fn: ApplyFn,
    sched: DiffusionSchedule,
    x_0: torch.Tensor,
    t: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    objective: str = "pred_noise",
    normalize: bool = True,
    valid: Optional[torch.Tensor] = None,
    aux_channel_losses: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """L1 epsilon-matching loss with p2 reweighting (reference:
    models/diffusion_model.py:120-143). x_0 (B, C, H, W) is in [0, 1] when
    ``normalize``. t (B,) defaults to uniform draws and noise to normal
    draws from ``generator``. ``valid`` (B,) masks padding rows out of the
    mean. ``aux_channel_losses`` also returns the per-channel (C,) split."""
    n = x_0.shape[0]
    if t is None:
        if generator is None:
            raise ValueError("need a generator or the timesteps themselves")
        t = torch.randint(0, sched.num_timesteps, (n,), generator=generator, device=x_0.device)
    if normalize:
        x_0 = normalize_to_neg_one_to_one(x_0)
    if noise is None:
        noise = spatial.randn(x_0.shape, generator, x_0.device, x_0.dtype)
    out = apply_fn(q_sample(sched, x_0, t, noise), t)
    target = noise if objective == "pred_noise" else x_0
    err = (out.float() - target.float()).abs()
    p2 = gather(sched.p2_loss_weight, t)
    row_w = torch.ones(n, device=x_0.device) if valid is None else valid.float()
    denom = row_w.sum().clamp(min=1.0)
    total = (spatial.mean(err.reshape(n, -1), 1) * p2 * row_w).sum() / denom
    if not aux_channel_losses:
        return total
    per_ch = spatial.mean(err.reshape(n, x_0.shape[1], -1), 2) * p2[:, None]
    return total, (per_ch * row_w[:, None]).sum(dim=0) / denom


def val_loss(
    apply_fn: ApplyFn,
    sched: DiffusionSchedule,
    x_0: torch.Tensor,
    t_steps: int,
    noise: Optional[Sequence[torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    objective: str = "pred_noise",
    normalize: bool = True,
    fold_batch: int = 8,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean loss over evenly spaced timesteps (reference:
    models/diffusion_model.py:145-156), folded into the batch in chunks of
    ``fold_batch`` timesteps, as the JAX package does: the last chunk is
    padded with t = 0 rows that do not count. ``noise[c]`` (fold_batch*B,
    C, H, W) is chunk c's noise; without it the noise comes from
    ``generator``. ``valid`` (B,) masks padding rows."""
    T = sched.num_timesteps
    dev = x_0.device
    t_values = torch.arange(0, T, max(T // t_steps, 1), device=dev)
    S = t_values.shape[0]
    pad = (-S) % fold_batch
    t_chunks = torch.cat([t_values, t_values.new_zeros(pad)]).reshape(-1, fold_batch)
    v_chunks = torch.cat([torch.ones(S, device=dev), torch.zeros(pad, device=dev)]).reshape(-1, fold_batch)
    n = x_0.shape[0]
    row_w = torch.ones(n, device=dev) if valid is None else valid.float()
    row_denom = row_w.sum().clamp(min=1.0)
    x_rep = (normalize_to_neg_one_to_one(x_0) if normalize else x_0).repeat(
        fold_batch, *([1] * (x_0.ndim - 1))
    )
    total = torch.zeros((), device=dev)
    for c in range(t_chunks.shape[0]):
        t_rep = t_chunks[c].repeat_interleave(n)
        nz = noise[c] if noise is not None else spatial.randn(x_rep.shape, generator, dev, x_rep.dtype)
        out = apply_fn(q_sample(sched, x_rep, t_rep, nz), t_rep)
        tgt = nz if objective == "pred_noise" else x_rep
        l = spatial.mean((out.float() - tgt.float()).abs().reshape(fold_batch * n, -1), 1)
        l = l * gather(sched.p2_loss_weight, t_rep)
        per_t = (l.reshape(fold_batch, n) * row_w).sum(dim=1) / row_denom
        total = total + (per_t * v_chunks[c]).sum()
    return total / S
