"""The port's ``tp`` rule (``tedm_tpu_torch.parallel.tensor_parallel.plan_of``)
against JAX's ``param_shardings(mode="tp")`` (tedm_tpu/parallel/mesh.py:90-145),
leaf by leaf, on the CPU and without processes.

The port's module gives JAX's tree through ``tedm_tpu/utils/torch_port.py``;
JAX's rule marks each leaf sharded over ``model`` or replicated; a tree of
the same shapes holding 1 where JAX shards and 0 where it replicates comes
back through ``utils.convert`` (JAX to the port) under the port's parameter
names, each tensor all ones or all zeros, which must be the port's plan.
Cases: a UNet of two stages and the TEDM head on a model axis of 2 at
``tp_min_width`` 16 (most layers sharded) and at JAX's default 256 (the wide
qkv convs alone), and of 3 (a width it does not divide stays replicated).
``ChanLayerNorm.g``, (1, C, 1, 1) in the port and (C,) in JAX, stays
replicated where a rule read off the torch tensor would shard it.
"""

import jax
import numpy as np
import pytest
import torch

from tedm_tpu.parallel import make_mesh as jax_make_mesh
from tedm_tpu.parallel import param_shardings as jax_param_shardings
from tedm_tpu.utils.torch_port import classifier_batch_stats, convert_classifier_state_dict, convert_unet_state_dict
from tedm_tpu_torch.models.segmentation import PixelClassifier
from tedm_tpu_torch.models.unet import Unet
from tedm_tpu_torch.parallel import make_mesh
from tedm_tpu_torch.parallel.tensor_parallel import plan_of
from tedm_tpu_torch.utils.convert import classifier_state_dict, unet_state_dict

DIM, MULTS = 16, (1, 2)


def jax_marks(tree, model, min_width):
    """1.0 over each leaf JAX's tp rule shards on a (1, model) mesh, else 0.0."""
    mesh = jax_make_mesh((1, model), ("data", "model"), devices=jax.devices()[:model])
    specs = jax_param_shardings(tree, mesh, "tp", tp_min_width=min_width)
    return jax.tree_util.tree_map(lambda leaf, s: np.full(np.shape(leaf), float("model" in s.spec), np.float32),
                                  tree, specs)


def port_marks(sd):
    out = {}
    for name, a in sd.items():
        if np.issubdtype(np.asarray(a).dtype, np.floating) and not name.endswith(("running_mean", "running_var")):
            assert np.all(a == a.flat[0]), name
            out[name] = bool(a.flat[0])
    return out


def unet_case(model, min_width):
    unet = Unet(dim=DIM, dim_mults=MULTS)
    params = convert_unet_state_dict({k: v.detach().numpy() for k, v in unet.state_dict().items()}, n_stages=2)
    return unet, port_marks(unet_state_dict(jax_marks(params, model, min_width)))


def head_case(model, min_width):
    clf = PixelClassifier(stage_channels=tuple(DIM * m for m in reversed(MULTS)), n_steps=1, img_size=32, shared=True)
    sd = {k: v.detach().numpy() for k, v in clf.state_dict().items()}
    params = convert_classifier_state_dict(sd, shared_weights=True)
    return clf, port_marks(classifier_state_dict(jax_marks(params, model, min_width),
                                                 classifier_batch_stats(sd, shared_weights=True), shared=True))


@pytest.mark.parametrize("model,min_width", [(2, 16), (2, 256), (3, 16)])
@pytest.mark.parametrize("case", [unet_case, head_case], ids=["unet", "TEDM head"])
def test_tp_plan_matches_jax_leaf_by_leaf(case, model, min_width):
    module, want = case(model, min_width)
    got = plan_of(module, model, min_width)
    assert got == want
    if (model, min_width) == (2, 16):
        assert any(got.values()) and not all(got.values())


def test_chan_layer_norm_gain_stays_replicated():
    unet = Unet(dim=DIM, dim_mults=MULTS)
    plan = plan_of(unet, 2, 16)
    gains = {n: p for n, p in unet.named_parameters() if n.endswith(".g")}
    # 4-D in the port, with C >= tp_min_width and divisible: the torch shape alone would shard it
    assert gains and all(p.ndim == 4 and p.shape[1] >= 16 and p.shape[1] % 2 == 0 for p in gains.values())
    assert not any(plan[n] for n in gains)
    _, jax_view = unet_case(2, 16)
    assert not any(jax_view[n] for n in gains)


def test_2d_mesh_checks():
    assert make_mesh((2, 2), ("data", "model"), n_devices=4).shape == (2, 2)
    assert make_mesh((1, 2), ("data", "model"), n_devices=2).axis_names == ("data", "model")
    with pytest.raises(ValueError, match=r"needs 4 devices, have 2"):
        make_mesh((2, 2), ("data", "model"), n_devices=2)
    with pytest.raises(ValueError, match=r"differ in length"):
        make_mesh((2, 2), ("data",), n_devices=4)
    # the data group of a rank holds the ranks of its model coordinate, as JAX reshapes devices row-major
    devices = np.asarray(jax_make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4]).devices)
    ids = np.vectorize(lambda d: d.id)(devices)
    assert ids.tolist() == np.arange(4).reshape(2, 2).tolist()
