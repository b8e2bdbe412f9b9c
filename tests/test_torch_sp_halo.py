"""The spatial-parallel pieces of the port (``tedm_tpu_torch/parallel/spatial.py``)
on 4 gloo ranks, one spatial group of 4 over the rows of a (2, 3, 16, 8)
map (4 rows a rank: two ranks at the map's edges, two inside), against
their one-process versions on the CPU (``torch_sp_worker.halo_cases``).

* ``halo`` + a local conv without row padding equals the row-padded conv of
  the whole map on this rank's rows, for the UNet's 3x3 pad 1, 7x7 pad 3 and
  4x4 stride-2 pad 1 convs: the output, and the gradients of the input
  (each halo row's gradient returned to its rank), the weight and the bias
  (the ranks' parts added), to 1e-5 of their largest entry. The control,
  the halo gradients' return taken out, must miss the input's gate.
* ``gather_h`` is the whole map on every rank, and its gradient this rank's
  rows of the sum of the ranks' gradients; ``spatial_sum`` the sum of the
  ranks' values, its gradient the sum of the ranks' gradients: exactly.
* A UNet (dim 8, mults (1, 2), 16^2: 4 then 2 rows a rank) on each rank's
  rows, fp32 (B.1's plain version), bf16 (B.2's) and with the opt-in
  switches (B.3, B.4, B.5's plain versions on gathered maps): each rank's
  output equals its rows of the one-process output, and the parameters'
  gradients summed over the ranks equal one process's, to 1e-5 of the
  largest entry in fp32, 5e-2 in bf16, or of 0.1 of the model's largest
  gradient entry where that is more (a conv bias before a GroupNorm of one
  channel a group has a gradient of rounding alone).
* The heads' nearest resize of a stage to a rank's rows of the output is
  local at the integer ratios of the stages (no ranks needed).
* Fewer rows a rank than a halo reaches, which JAX runs: the 3x3 and 7x7
  convs on a (2, 3, 4, 8) map, 1 row a rank (the 7x7's halo from the whole
  map), against the whole map's conv as above; and the fp32 UNet at 8^2 (2
  rows a rank, then 1) against one process as above, and against the JAX
  package's forward and backward of the same weights (through
  ``tedm_tpu.utils.torch_port``) on a (1, 4) data x spatial mesh of CPU
  devices, its input's H sharded: each rank's output to 2e-4 of the largest
  entry of its rows of JAX's, the gradients to 2e-4 of each tensor's largest
  entry, or of 0.1 of the model's largest gradient entry where that is
  more (``test_torch_sp_steps.py``'s gate).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_parallel_worker as W
import torch_sp_worker as SW

WORLD = 4
TOL = {"fp32": 1e-5, "opt-in": 1e-5, "bf16": 5e-2}  # bf16: the gate of a bf16 step's gradients on the card


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("sp_halo"))
    W.spawn(SW.halo_cases, WORLD, tmp, tmp, timeout=240)
    return [torch.load(f"{tmp}/halo{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.fixture(scope="module")
def inputs():
    return {k: torch.from_numpy(v) for k, v in SW.halo_inputs().items()}


def rows(t, r):
    return t.chunk(WORLD, dim=2)[r].numpy()


def close(got, want, tol):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() <= tol * np.abs(want).max()


def conv_reference(inputs, name, pre=""):
    k, s, p = SW.CONVS[name]
    x = inputs[pre + "x"].clone().requires_grad_()
    w, b = inputs[name + " w"].clone().requires_grad_(), inputs[name + " b"].clone().requires_grad_()
    y = F.conv2d(x, w, b, stride=s, padding=p)
    (y * inputs[pre + name + " dy"]).sum().backward()
    return y.detach(), x.grad, w.grad, b.grad


@pytest.mark.parametrize("name", list(SW.CONVS))
def test_halo_conv_equals_whole_map_conv(ranks, inputs, name):
    y, dx, dw, db = conv_reference(inputs, name)
    for r, got in enumerate(ranks):
        assert close(got[name]["y"], rows(y, r), 1e-5), r
        assert close(got[name]["dx"], rows(dx, r), 1e-5), r
    assert close(sum(g[name]["dw"] for g in ranks), dw, 1e-5)
    assert close(sum(g[name]["db"] for g in ranks), db, 1e-5)


@pytest.mark.parametrize("name", list(SW.CONVS))
def test_control_without_halo_gradient_return_misses(ranks, inputs, name):
    _, dx, _, _ = conv_reference(inputs, name)
    got = [g[name, "no halo gradient return"] for g in ranks]
    assert not all(close(g["dx"], rows(dx, r), 1e-5) for r, g in enumerate(got))
    assert all(close(g["y"], rows(conv_reference(inputs, name)[0], r), 1e-5) for r, g in enumerate(got))


def test_halo_is_the_padded_map_rows(inputs):
    from tedm_tpu_torch.parallel import spatial

    x = inputs["x"]
    for r in range(WORLD):
        h = spatial.halo_reference(x, WORLD, r, 3, 3)
        assert h.shape[2] == x.shape[2] // WORLD + 6
        np.testing.assert_array_equal(h[:, :, 3:-3].numpy(), spatial.local_rows_reference(x, WORLD, r).numpy())


def test_gather_h_and_spatial_sum_equal_one_process(ranks, inputs):
    from tedm_tpu_torch.parallel import spatial

    whole = spatial.gather_h_reference([spatial.local_rows_reference(inputs["x"], WORLD, r) for r in range(WORLD)])
    np.testing.assert_array_equal(whole.numpy(), inputs["x"].numpy())
    dy = inputs["gather dy"].sum(dim=0)
    total = spatial.spatial_sum_reference(list(inputs["sum x"]))
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["gather"]["y"], inputs["x"].numpy())
        np.testing.assert_allclose(got["gather"]["dx"], rows(dy, r), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["sum"]["y"], total.numpy(), rtol=1e-6, atol=1e-6)  # gloo adds in its own order
        np.testing.assert_array_equal(got["sum"]["dx"], np.full((5, 3), sum(range(1, WORLD + 1)), np.float32))


@pytest.mark.parametrize("path", list(SW.UNET_PATHS))
def test_unet_on_row_shards_equals_one_process(ranks, inputs, path):
    want = SW.unet_step(path, inputs["unet x"], inputs["unet t"], inputs["unet dy"])
    y = torch.from_numpy(want["y"])
    for r, got in enumerate(ranks):
        assert close(got["unet", path]["y"], rows(y, r), TOL[path]), r
    got = ranks[0]["unet", path]["grads"]
    assert got.keys() == want["grads"].keys()
    # a conv bias before a GroupNorm of one channel a group has no gradient
    # but rounding (1e-7 of the model's largest gradient entry in fp32):
    # each tensor is held to its largest entry, or to 0.1 of the model's
    # largest gradient entry where that is more
    floor = 0.1 * max(np.abs(g).max() for g in want["grads"].values())
    bad = [n for n, g in want["grads"].items()
           if not np.abs(got[n] - g).max() <= TOL[path] * max(np.abs(g).max(), floor)]
    assert bad == []


@pytest.mark.parametrize("size", [16, 32])
def test_stage_resize_is_local_at_integer_ratios(size):
    """The heads' nearest resize of a stage (``segmentation.stage_sum``) to a
    rank's rows of the output is the rank's rows of the whole resize: each
    stage's rows divide over the ranks, and an integer ratio maps output row
    o to input row o // ratio."""
    from tedm_tpu_torch.ops.resize import nearest_resize
    from tedm_tpu_torch.parallel import spatial

    f = torch.from_numpy(np.random.RandomState(size).standard_normal((2, 3, 8, 8)).astype(np.float32))
    whole = nearest_resize(f, size, size)
    for r in range(WORLD):
        with spatial.sharded(spatial.Plan(None, WORLD, r)):
            got = nearest_resize(spatial.local_rows(f), spatial.local_size(size), size)
        np.testing.assert_array_equal(got.numpy(), rows(whole, r))


@pytest.mark.parametrize("name", ["3x3", "7x7"])
def test_halo_past_the_neighbours_equals_whole_map_conv(ranks, inputs, name):
    y, dx, dw, db = conv_reference(inputs, name, "narrow ")
    for r, got in enumerate(ranks):
        assert got["narrow", name]["y"].shape[2] == 1
        assert close(got["narrow", name]["y"], rows(y, r), 1e-5), r
        assert close(got["narrow", name]["dx"], rows(dx, r), 1e-5), r
    assert close(sum(g["narrow", name]["dw"] for g in ranks), dw, 1e-5)
    assert close(sum(g["narrow", name]["db"] for g in ranks), db, 1e-5)


def test_unet_of_fewer_rows_a_rank_than_its_halo_matches_jax(ranks, inputs):
    import jax
    import jax.numpy as jnp

    from tedm_tpu.config import Config as JaxConfig
    from tedm_tpu.models.unet import Unet as JaxUnet
    from tedm_tpu.parallel import data_parallel_setup
    from tedm_tpu.utils.torch_port import convert_unet_state_dict

    x, t, dy = inputs["narrow unet x"], inputs["unet t"], inputs["narrow unet dy"]
    want = SW.unet_step("fp32", x, t, dy)
    y1 = torch.from_numpy(want["y"])
    for r, got in enumerate(ranks):
        assert got["unet", "narrow fp32"]["y"].shape[2] == SW.NARROW_UNET // WORLD
        assert close(got["unet", "narrow fp32"]["y"], rows(y1, r), TOL["fp32"]), r
    got = ranks[0]["unet", "narrow fp32"]["grads"]
    floor = 0.1 * max(np.abs(g).max() for g in want["grads"].values())
    assert [n for n, g in want["grads"].items()
            if not np.abs(got[n] - g).max() <= TOL["fp32"] * max(np.abs(g).max(), floor)] == []

    n_stages = len(SW.UNET["dim_mults"])
    params = convert_unet_state_dict({k: v.numpy() for k, v in SW.unet_of("fp32").state_dict().items()}, n_stages)
    junet = JaxUnet(**SW.UNET, channels=1)
    jdy = jnp.asarray(dy.numpy().transpose(0, 2, 3, 1))

    def loss(p, v):
        y = junet.apply({"params": p}, v, jnp.asarray(t.numpy()))
        return (y * jdy).sum(), y

    shard, replicate = data_parallel_setup(
        JaxConfig(mesh_shape=(1, WORLD), mesh_axes=("data", "spatial"), shard_spatial=True), 2)
    xs = shard({"x": x.numpy().transpose(0, 2, 3, 1)})["x"]
    assert xs.sharding.spec == jax.sharding.PartitionSpec("data", "spatial")
    (_, jy), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(replicate(params), xs)
    jy = torch.from_numpy(np.asarray(jy).transpose(0, 3, 1, 2).copy())
    for r, g in enumerate(ranks):
        assert close(g["unet", "narrow fp32"]["y"], rows(jy, r), 2e-4), r
    flat = lambda tree: {"/".join(k.key for k in path): np.asarray(v)
                         for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    mine, theirs = flat(convert_unet_state_dict(got, n_stages)), flat(jgrads)
    assert mine.keys() == theirs.keys()
    floor = 0.1 * max(np.abs(g).max() for g in theirs.values())
    assert [n for n, g in theirs.items() if not np.abs(mine[n] - g).max() <= 2e-4 * max(np.abs(g).max(), floor)] == []
