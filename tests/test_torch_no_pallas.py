"""``--no_pallas``: the port's UNet takes the linear-attention kernels (B.1 in
fp32, the fused block B.2 in bf16) off its path, as JAX's
``Unet(use_pallas=False)`` does (tedm_tpu/models/unet.py:370,462).

A port ``Unet`` built from a config with the flag (``unet_kernels``) never
calls ``linear_attention`` or ``prenorm_linear_attention`` (each replaced by
a function that raises), and without the flag it calls them; under the flag
its outputs and features match JAX's plain path on the same weights with
either einsum layout (``--attn_layout``): 2e-4 in fp32, 3e-2 of the largest
entry in bf16 (the tolerance of tests/test_torch_mixed_precision.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tedm_tpu.models.unet import Unet as JaxUnet
from tedm_tpu_torch.config import Config, config_from_args
from tedm_tpu_torch.models import unet as U
from tedm_tpu_torch.trainers.common import unet_kernels
from tedm_tpu_torch.utils.convert import load_numpy_state_dict, unet_state_dict

torch.set_num_threads(1)

DIM, MULTS, SIZE = 16, (1, 2), 32
KERNELS = ("linear_attention", "prenorm_linear_attention")


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def params():
    jmodel = JaxUnet(dim=DIM, dim_mults=MULTS, channels=1)
    p = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 1)), jnp.zeros((1,), jnp.int32))["params"]
    rs = np.random.RandomState(0)
    return jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.1 * rs.randn(*a.shape).astype(np.float32), p)


def _port_unet(params, argv, dtype):
    cfg = config_from_args(["--dim", str(DIM), "--dim_mults", *map(str, MULTS), "--img_size", str(SIZE), *argv])
    unet = U.Unet(dim=DIM, dim_mults=MULTS, channels=1, dtype=dtype, **unet_kernels(cfg))
    return load_numpy_state_dict(unet, unet_state_dict(params)).eval()


def _calls(monkeypatch, forbid: bool) -> dict:
    """Count each kernel wrapper's calls through the UNet; raise on one if ``forbid``."""
    calls = dict.fromkeys(KERNELS, 0)
    for name in KERNELS:
        real = getattr(U, name)

        def wrapper(*args, _name=name, _real=real, **kw):
            if forbid:
                raise AssertionError(f"{_name} called under --no_pallas")
            calls[_name] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(U, name, wrapper)
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_no_pallas_takes_the_kernels_off_the_path(params, dtype, monkeypatch):
    assert not config_from_args(["--no_pallas"]).use_pallas and Config().use_pallas
    x = _nchw(np.random.RandomState(1).randn(2, SIZE, SIZE, 1).astype(np.float32))
    t = torch.tensor([3, 777])
    _calls(monkeypatch, forbid=True)
    unet = _port_unet(params, ["--no_pallas"], dtype)
    with torch.no_grad():
        unet(x, t)
    monkeypatch.undo()
    calls = _calls(monkeypatch, forbid=False)
    with torch.no_grad():
        _port_unet(params, [], dtype)(x, t)
    fused = dtype == torch.bfloat16
    # 2 down and 2 up stages: one attention block each
    assert calls == {"linear_attention": 0 if fused else 4, "prenorm_linear_attention": 4 if fused else 0}


@pytest.mark.parametrize("layout", ["heads_major", "nhwc"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_no_pallas_matches_jax_plain_path(params, layout, dtype):
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jmodel = JaxUnet(dim=DIM, dim_mults=MULTS, channels=1, dtype=jdtype, use_pallas=False, attn_layout=layout)
    unet = _port_unet(params, ["--no_pallas", "--attn_layout", layout], dtype)
    x = np.random.RandomState(1).randn(2, SIZE, SIZE, 1).astype(np.float32)
    t = np.array([3, 777], np.int64)
    out_j, feats_j = jax.jit(lambda p, x, t: jmodel.apply(p, x, t, extract_features=True))(
        {"params": params}, jnp.asarray(x), jnp.asarray(t, jnp.int32))
    with torch.no_grad():
        out, feats = unet(_nchw(x), torch.from_numpy(t), extract_features=True)
    assert out.dtype == dtype and len(feats) == len(feats_j) == len(MULTS)
    for got, want in [(out, out_j)] + list(zip(feats, feats_j)):
        if dtype == torch.float32:
            np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=2e-4, rtol=0)
        else:
            assert _rel(_nhwc(got), want.astype(jnp.float32)) <= 3e-2
