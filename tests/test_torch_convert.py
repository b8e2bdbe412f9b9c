"""Carrying weights and configs between the JAX package and the port.

``tedm_tpu_torch.utils.convert`` is the inverse of the JAX package's
``utils/torch_port.py``: JAX params -> port state_dict -> JAX params must
give back every array exactly. Configs and checkpoints written by one
package load in the other.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tedm_tpu.config import Config as JaxConfig
from tedm_tpu.models.segmentation import PixelClassifier as JaxPixelClassifier
from tedm_tpu.models.unet import Unet as JaxUnet
from tedm_tpu.utils.torch_port import (
    classifier_batch_stats,
    convert_classifier_state_dict,
    convert_unet_state_dict,
)
from tedm_tpu_torch.config import Config, diff_configs
from tedm_tpu_torch.models.segmentation import PixelClassifier
from tedm_tpu_torch.models.unet import Unet
from tedm_tpu_torch.utils.checkpoint import checkpoint_exists, load_checkpoint, save_checkpoint
from tedm_tpu_torch.utils.convert import classifier_state_dict, load_numpy_state_dict, unet_state_dict

torch.set_num_threads(1)


def _random_like(tree, seed):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(lambda p: rs.randn(*p.shape).astype(np.float32), tree)


def _assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=f"{path}/{k}")


@pytest.mark.parametrize("dim,mults", [(8, (1, 2)), (8, (1, 2, 4))])
def test_unet_round_trip_through_torch_port_is_exact(dim, mults):
    jmodel = JaxUnet(dim=dim, dim_mults=mults, channels=1)
    shapes = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)), jnp.zeros((1,), jnp.int32)
    )["params"]
    params = _random_like(shapes, seed=0)
    port = load_numpy_state_dict(Unet(dim=dim, dim_mults=mults, channels=1), unet_state_dict(params))
    back = convert_unet_state_dict(port.state_dict(), n_stages=len(mults))
    _assert_trees_equal(jax.tree_util.tree_map(np.asarray, back), params)


@pytest.mark.parametrize("shared,n_steps", [(True, 1), (False, 3)])
def test_classifier_round_trip_through_torch_port_is_exact(shared, n_steps):
    stages = (32, 16)
    jclf = JaxPixelClassifier(stage_channels=stages, n_steps=n_steps, img_size=16)
    feats = [jnp.zeros((n_steps, 8, 8, 32)), jnp.zeros((n_steps, 16, 16, 16))]
    shapes = jax.eval_shape(lambda: jclf.init(jax.random.PRNGKey(0), feats, train=False))
    params = _random_like(shapes["params"], seed=1)
    stats = _random_like(shapes["batch_stats"], seed=2)
    port = load_numpy_state_dict(
        PixelClassifier(stage_channels=stages, n_steps=n_steps, img_size=16, shared=shared),
        classifier_state_dict(params, stats, shared=shared),
    )
    sd = port.state_dict()
    _assert_trees_equal(convert_classifier_state_dict(sd, shared_weights=shared), params)
    _assert_trees_equal(classifier_batch_stats(sd, shared_weights=shared), stats)


@pytest.mark.parametrize("experiment", ["TEDM", "LEDM", "LEDMe", "baseline"])
def test_config_json_written_by_jax_loads_unchanged(experiment):
    jcfg = JaxConfig(log_dir="/logs/x", ema_decay=0.999, dim_mults=(1, 2, 4)).replace(
        experiment=experiment, n_labelled_images=3
    ).apply_experiment_preset()
    cfg = Config.from_json(jcfg.to_json())
    assert cfg.to_dict() == json.loads(jcfg.to_json())
    assert cfg.to_json() == jcfg.to_json()
    assert diff_configs(cfg, jcfg.to_dict(), printer=lambda _: None) == {}
    # the presets agree too
    raw = Config(log_dir="/logs/x").replace(experiment=experiment, n_labelled_images=3)
    jraw = JaxConfig(log_dir="/logs/x").replace(experiment=experiment, n_labelled_images=3)
    assert raw.apply_experiment_preset().to_json() == jraw.apply_experiment_preset().to_json()


def test_checkpoint_round_trip(tmp_path):
    cfg = Config(log_dir=str(tmp_path), dim=8, dim_mults=(1, 2))
    unet = Unet(dim=8, dim_mults=(1, 2))
    path = str(tmp_path / "best")
    assert not checkpoint_exists(path)
    save_checkpoint(path, {"params": unet.state_dict()}, cfg)
    assert checkpoint_exists(path) and os.path.isfile(os.path.join(path, "config.json"))
    state, old = load_checkpoint(path, cfg.replace(lr=1.0), verbose=False)
    assert old == cfg
    for k, v in unet.state_dict().items():
        torch.testing.assert_close(state["params"][k], v, atol=0, rtol=0)
    # the JAX package reads the same config.json
    assert JaxConfig.load(os.path.join(path, "config.json")).to_json() == cfg.to_json()
