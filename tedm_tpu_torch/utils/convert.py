"""Carry weights from the JAX package to the port.

Turns ``tedm_tpu`` parameter trees, given as nested dicts of numpy arrays,
into ``state_dict``s of the port's modules: the inverse of
``convert_unet_state_dict``, ``convert_classifier_state_dict`` and
``classifier_batch_stats`` in ``tedm_tpu/utils/torch_port.py``, PDDM's
``LinearProbe``, and the contrastive models ``GlobalCL`` and ``LocalCL``.
``task_state_dicts`` turns a JAX task's parameters into the state_dicts a
port checkpoint holds. Pure numpy; the results load with
``load_numpy_state_dict``.

Layout transforms (JAX -> torch):
  Conv kernel   (kh, kw, in, out) -> (out, in, kh, kw)
  Dense kernel  (in, out)         -> (out, in)
  GlobalCL g1_fc1 (H*W*C, out)    -> (out, C*H*W)
  Probe kernel  (c_in, out)       -> (out, c_in, 1, 1)
  ChanLayerNorm g (C,)            -> (1, C, 1, 1)
  GroupNorm scale/bias            -> weight/bias
  BatchNorm scale/bias, mean/var  -> weight/bias, running_mean/running_var
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn


def _conv(w) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1)))


def _dense(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w, np.float32).T)


def _vec(b) -> np.ndarray:
    return np.asarray(b, np.float32).reshape(-1)


def _conv_pair(p: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    return {f"{prefix}.weight": _conv(p["kernel"]), f"{prefix}.bias": _vec(p["bias"])}


def _resnet_block(p: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    for blk in ("block1", "block2"):
        sd.update(_conv_pair(p[blk]["proj"], f"{prefix}.{blk}.proj"))
        sd[f"{prefix}.{blk}.norm.weight"] = _vec(p[blk]["norm"]["scale"])
        sd[f"{prefix}.{blk}.norm.bias"] = _vec(p[blk]["norm"]["bias"])
    if "time_proj" in p:  # Sequential(SiLU, Linear)
        sd[f"{prefix}.time_mlp.1.weight"] = _dense(p["time_proj"]["kernel"])
        sd[f"{prefix}.time_mlp.1.bias"] = _vec(p["time_proj"]["bias"])
    if "res_conv" in p:
        sd.update(_conv_pair(p["res_conv"], f"{prefix}.res_conv"))
    return sd


def _gain(g) -> np.ndarray:
    return _vec(g).reshape(1, -1, 1, 1)


def _prenorm_attn(p: Mapping, prefix: str, linear: bool) -> Dict[str, np.ndarray]:
    a = p["attn"]
    sd = {
        f"{prefix}.fn.norm.g": _gain(p["norm"]["g"]),
        f"{prefix}.fn.fn.to_qkv.weight": _conv(a["to_qkv"]["kernel"]),
    }
    if linear:  # to_out = Sequential(Conv2d, ChanLayerNorm)
        sd.update(_conv_pair(a["to_out"], f"{prefix}.fn.fn.to_out.0"))
        sd[f"{prefix}.fn.fn.to_out.1.g"] = _gain(a["out_norm"]["g"])
    else:
        sd.update(_conv_pair(a["to_out"], f"{prefix}.fn.fn.to_out"))
    return sd


def unet_state_dict(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """``tedm_tpu.models.unet.Unet`` params -> the port's ``Unet`` state_dict.
    A partial tree, as a contrastive model's ``unet`` subtree initialises
    lazily (no time MLPs, the decoder only as far as it runs, no final
    block; tedm_tpu/models/unet.py:199-204), gives the keys it has."""
    sd: Dict[str, np.ndarray] = {}
    sd.update(_conv_pair(params["init_conv"], "init_conv"))
    if "time_mlp" in params:
        tm = params["time_mlp"]
        sd["time_mlp.1.weight"] = _dense(tm["fc1"]["kernel"])
        sd["time_mlp.1.bias"] = _vec(tm["fc1"]["bias"])
        sd["time_mlp.3.weight"] = _dense(tm["fc2"]["kernel"])
        sd["time_mlp.3.bias"] = _vec(tm["fc2"]["bias"])
    for side in ("downs", "ups"):
        i = 0
        while f"{side}_{i}_0" in params:
            sd.update(_resnet_block(params[f"{side}_{i}_0"], f"{side}.{i}.0"))
            sd.update(_resnet_block(params[f"{side}_{i}_1"], f"{side}.{i}.1"))
            sd.update(_prenorm_attn(params[f"{side}_{i}_2"], f"{side}.{i}.2", linear=True))
            last = params[f"{side}_{i}_3"]
            if "conv" in last:  # strided Downsample conv / Sequential(Upsample, Conv)
                sd.update(_conv_pair(last["conv"], f"{side}.{i}.3" + (".1" if side == "ups" else "")))
            else:  # the last stage's plain 3x3 conv
                sd.update(_conv_pair(last, f"{side}.{i}.3"))
            i += 1
    sd.update(_resnet_block(params["mid_block1"], "mid_block1"))
    sd.update(_prenorm_attn(params["mid_attn"], "mid_attn", linear=False))
    sd.update(_resnet_block(params["mid_block2"], "mid_block2"))
    if "final_res_block" in params:
        sd.update(_resnet_block(params["final_res_block"], "final_res_block"))
        sd.update(_conv_pair(params["final_conv"], "final_conv"))
    return sd


def _prefixed(prefix: str, sd: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def global_cl_state_dict(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """``tedm_tpu.models.contrastive.GlobalCL`` params -> the port's
    ``GlobalCL`` state_dict. ``g1_fc1``'s kernel rows are in NHWC flatten
    order, (H, W, C); they are permuted to the port's (C, H, W)."""
    sd = _prefixed("unet", unet_state_dict(params["unet"]))
    c = np.shape(params["unet"]["mid_block2"]["block2"]["proj"]["kernel"])[-1]
    w1 = np.asarray(params["g1_fc1"]["kernel"], np.float32)  # (H*W*C, emb)
    side = int(round((w1.shape[0] // c) ** 0.5))
    w1 = w1.reshape(side, side, c, -1).transpose(2, 0, 1, 3).reshape(c * side * side, -1)
    sd["g1_fc1.weight"] = np.ascontiguousarray(w1.T)
    sd["g1_fc2.weight"] = _dense(params["g1_fc2"]["kernel"])
    return sd


def local_cl_state_dict(params: Mapping[str, Any], batch_stats: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """``tedm_tpu.models.contrastive.LocalCL`` params and batch_stats -> the
    port's ``LocalCL`` state_dict."""
    sd = _prefixed("unet", unet_state_dict(params["unet"]))
    sd["g2_conv1.weight"] = _conv(params["g2_conv1"]["kernel"])
    sd["g2_conv2.weight"] = _conv(params["g2_conv2"]["kernel"])
    sd.update(_batch_norm(params["g2_bn"], batch_stats["g2_bn"], "g2_bn"))
    return sd


def _batch_norm(p: Mapping, stats: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    return {f"{prefix}.weight": _vec(p["scale"]), f"{prefix}.bias": _vec(p["bias"]),
            f"{prefix}.running_mean": _vec(stats["mean"]), f"{prefix}.running_var": _vec(stats["var"]),
            f"{prefix}.num_batches_tracked": np.array(0, np.int64)}


def classifier_state_dict(
    params: Mapping[str, Any], batch_stats: Mapping[str, Any], shared: bool
) -> Dict[str, np.ndarray]:
    """``tedm_tpu.models.segmentation.PixelClassifier`` params and
    batch_stats -> the port's ``PixelClassifier`` state_dict. ``shared``
    selects the TEDM layout, whose indices shift by the leading Rearrange."""
    o = 1 if shared else 0
    w1 = np.asarray(params["conv1_kernel"], np.float32)  # (c_in, h1)
    sd = {
        f"{o}.weight": np.ascontiguousarray(w1.T[:, :, None, None]),
        f"{o}.bias": _vec(params["conv1_bias"]),
    }
    sd.update(_conv_pair(params["conv2"], f"{o + 3}"))
    sd.update(_conv_pair(params["conv3"], f"{o + 6}"))
    for name, idx in (("bn1", o + 2), ("bn2", o + 5)):
        sd.update(_batch_norm(params[name], batch_stats[name], str(idx)))
    return sd


def probe_state_dict(params: Mapping[str, Any], stats: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """``tedm_tpu.models.segmentation.LinearProbe`` params and stats -> the
    port's ``LinearProbe`` state_dict."""
    w = np.asarray(params["kernel"], np.float32)  # (c_in, out)
    return {"weight": np.ascontiguousarray(w.T[:, :, None, None]), "bias": _vec(params["bias"]),
            "mean": _vec(stats["mean"]), "std": _vec(stats["std"])}


def task_state_dicts(
    experiment: str, params: Mapping[str, Any], batch_stats: Mapping[str, Any]
) -> Dict[str, Dict[str, np.ndarray]]:
    """The ``params`` and ``batch_stats`` of a JAX task
    (``tedm_tpu/trainers/{baseline,datasetdm,per_step}.py`` ``build_task``)
    -> the state_dicts of the port's checkpoint of ``experiment``, by key:
    ``{"unet"}`` for the baseline, ``{"backbone", "classifier"}`` for the
    heads."""
    if experiment == "baseline":
        return {"unet": unet_state_dict(params)}
    backbone = unet_state_dict(batch_stats["backbone"])
    if experiment == "PDDM":
        return {"backbone": backbone, "classifier": probe_state_dict(params, batch_stats["stats"])}
    return {"backbone": backbone,
            "classifier": classifier_state_dict(params, batch_stats["bn"], shared=experiment == "TEDM")}


def load_numpy_state_dict(module: nn.Module, sd: Mapping[str, np.ndarray]) -> nn.Module:
    """Load a numpy state_dict strictly (every key, no extra) into ``module``."""
    module.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, strict=True)
    return module
