"""Carry weights from the JAX package to the port.

Turns ``tedm_tpu`` parameter trees, given as nested dicts of numpy arrays,
into ``state_dict``s of the port's modules: the inverse of
``convert_unet_state_dict``, ``convert_classifier_state_dict`` and
``classifier_batch_stats`` in ``tedm_tpu/utils/torch_port.py``, and PDDM's
``LinearProbe``. ``task_state_dicts`` turns a JAX task's parameters into the
state_dicts a port checkpoint holds. Pure numpy; the results load with
``load_numpy_state_dict``.

Layout transforms (JAX -> torch):
  Conv kernel   (kh, kw, in, out) -> (out, in, kh, kw)
  Dense kernel  (in, out)         -> (out, in)
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
    """``tedm_tpu.models.unet.Unet`` params -> the port's ``Unet`` state_dict."""
    n_stages = sum(1 for k in params if k.startswith("downs_") and k.endswith("_0"))
    sd: Dict[str, np.ndarray] = {}
    sd.update(_conv_pair(params["init_conv"], "init_conv"))
    tm = params["time_mlp"]
    sd["time_mlp.1.weight"] = _dense(tm["fc1"]["kernel"])
    sd["time_mlp.1.bias"] = _vec(tm["fc1"]["bias"])
    sd["time_mlp.3.weight"] = _dense(tm["fc2"]["kernel"])
    sd["time_mlp.3.bias"] = _vec(tm["fc2"]["bias"])
    for side in ("downs", "ups"):
        for i in range(n_stages):
            sd.update(_resnet_block(params[f"{side}_{i}_0"], f"{side}.{i}.0"))
            sd.update(_resnet_block(params[f"{side}_{i}_1"], f"{side}.{i}.1"))
            sd.update(_prenorm_attn(params[f"{side}_{i}_2"], f"{side}.{i}.2", linear=True))
            last = params[f"{side}_{i}_3"]
            if "conv" in last:  # strided Downsample conv / Sequential(Upsample, Conv)
                sd.update(_conv_pair(last["conv"], f"{side}.{i}.3" + (".1" if side == "ups" else "")))
            else:  # the last stage's plain 3x3 conv
                sd.update(_conv_pair(last, f"{side}.{i}.3"))
    sd.update(_resnet_block(params["mid_block1"], "mid_block1"))
    sd.update(_prenorm_attn(params["mid_attn"], "mid_attn", linear=False))
    sd.update(_resnet_block(params["mid_block2"], "mid_block2"))
    sd.update(_resnet_block(params["final_res_block"], "final_res_block"))
    sd.update(_conv_pair(params["final_conv"], "final_conv"))
    return sd


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
        sd[f"{idx}.weight"] = _vec(params[name]["scale"])
        sd[f"{idx}.bias"] = _vec(params[name]["bias"])
        sd[f"{idx}.running_mean"] = _vec(batch_stats[name]["mean"])
        sd[f"{idx}.running_var"] = _vec(batch_stats[name]["var"])
        sd[f"{idx}.num_batches_tracked"] = np.array(0, np.int64)
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
