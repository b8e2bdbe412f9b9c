"""JAX's mesh-axis and shape rules in the port (``parallel/mesh.py``,
``parallel/spatial.py``), on the CPU.

* An axis of any other name holds replicas: one GlobalCL step (UNet of one
  stage at 16^2) of the port on 4 gloo ranks, mesh (2, 2) over ("replica",
  "data"), against the JAX package's step on the same mesh of CPU devices
  (its batch sharded over ``data`` alone). Rank r sits at (r // 2, r % 2):
  data rank r % 2, its images 2 (r % 2) on; the two replicas of a data rank
  read the same rows and reduce with no one. Checks and tolerances are
  ``test_torch_sp_cl.py``'s (the loss to 2e-4 relative of JAX's, the
  parameters as ``test_torch_parallel_steps.deviations`` holds them, the
  gradients to 2e-4 of the one-process step's, all four ranks equal).
* Under an empty ``--mesh_shape`` the mesh keeps the first axis name alone,
  as JAX's ``make_mesh`` does; a mesh without ``data`` is refused on more
  than one rank in JAX's words, as ``tp`` without ``model`` is.
* The shape rule: at 32^2 over 8 row shards with 3 downsamples (4 rows a
  rank, 2, 1 and 1/2 a stage), which the port refuses, JAX on 8 CPU devices
  runs a UNet (dim 8, mults (1, 2, 4, 8), the port's seeded init through
  ``tedm_tpu.utils.torch_port``) to its own one-device loss within 2e-4
  relative, but of its parameter gradients, held against its own one-device
  ones at ``test_torch_sp_steps.py``'s gate (2e-4 of each tensor's largest
  entry, or of 0.1 of the model's largest gradient entry where that is
  more), six miss: the kernels of the second conv (``block2.proj``) of every
  ResnetBlock at the 4^2 stage (4 rows over 8 shards), each exactly twice
  one device's (to 2e-4 of its largest entry). Every other tensor holds.
  The refusal is JAX's own limit, not the port's; 8 rows a rank (S = 4)
  runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_sp_cl as SC
import test_torch_sp_steps as SS
import torch_parallel_worker as W
from tedm_tpu.config import Config as JaxConfig
from tedm_tpu.models.unet import Unet as JaxUnet
from tedm_tpu.parallel import data_parallel_setup
from tedm_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tedm_tpu.utils.torch_port import convert_unet_state_dict
from tedm_tpu_torch.config import Config
from tedm_tpu_torch.models.unet import Unet
from tedm_tpu_torch.parallel import mesh, spatial

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def replicas(tmp_path_factory):
    return SC.run_cl_cases(tmp_path_factory, (2, 2), ["global_cl"], axes=("replica", "data"))


def test_replica_axis_step_matches_jax_2x2_mesh(replicas):
    SS.check(*replicas, "global_cl")


def test_replica_axis_ranks_are_replicas_of_their_data_rank(replicas):
    _, _, got = replicas
    # (data rank, data ranks, the rows the data ranks read when each rank reads 2)
    assert [g["where"] for g in got] == [(0, 2, 4.0), (1, 2, 4.0), (0, 2, 4.0), (1, 2, 4.0)]


@pytest.mark.parametrize("axes", [("replica", "data"), ("data", "spatial"), ("model",)])
def test_empty_mesh_shape_keeps_the_first_axis_name(axes):
    assert jax_make_mesh((), axes).axis_names == axes[:1]
    assert mesh.make_mesh((), axes, n_devices=8) == mesh.Mesh((8,), axes[:1])


@pytest.mark.parametrize("kw", [dict(mesh_axes=("replica", "data")), dict(mesh_shape=(8,), mesh_axes=("replica",)),
                                dict(mesh_axes=("data", "model"), param_sharding="tp")],
                         ids=["empty shape", "no data axis", "tp under an empty shape"])
def test_refusals_in_jax_words(kw):
    with pytest.raises(ValueError) as e:
        data_parallel_setup(JaxConfig(**kw), 8)
    with W.patched(mesh, "world", lambda: 8):
        with pytest.raises(ValueError) as got:
            mesh.check_config(Config(**kw))
    assert str(got.value) == str(e.value)


DOUBLED = sorted(f"{m}/block2/proj/kernel" for m in
                 ("downs_3_0", "downs_3_1", "mid_block1", "mid_block2", "ups_0_0", "ups_0_1"))


def test_shape_rule_refuses_where_jax_gradients_are_wrong():
    with pytest.raises(ValueError, match="4 a rank.*twice"):
        spatial.plan_for(spatial.Plan(None, 8, 0), 32, 3)
    assert spatial.plan_for(spatial.Plan(None, 4, 0), 32, 3) == spatial.Plan(None, 4, 0)
    torch.manual_seed(0)
    unet = Unet(dim=8, dim_mults=(1, 2, 4, 8))
    params = convert_unet_state_dict({k: v.detach().numpy() for k, v in unet.state_dict().items()})
    x = np.random.RandomState(1).randn(2, 32, 32, 1).astype(np.float32)
    t = jnp.asarray([3, 700])
    junet = JaxUnet(dim=8, dim_mults=(1, 2, 4, 8), channels=1)
    f = jax.jit(jax.value_and_grad(lambda p, v: (junet.apply({"params": p}, v, t) ** 2).mean()))
    loss, want = f(params, jnp.asarray(x))  # one device
    shard, replicate = data_parallel_setup(
        JaxConfig(mesh_shape=(1, 8), mesh_axes=("data", "spatial"), shard_spatial=True), 2)
    xs = shard({"x": x})["x"]
    assert xs.sharding.spec == jax.sharding.PartitionSpec("data", "spatial")
    sloss, got = f(replicate(params), xs)
    assert abs(float(sloss) - float(loss)) <= 2e-4 * float(loss)  # the forward: right
    flat = lambda tree: {"/".join(k.key for k in path): np.asarray(v)
                         for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    want, got = flat(want), flat(got)
    floor = 0.1 * max(np.abs(w).max() for w in want.values())
    off = sorted(n for n, w in want.items() if not np.abs(got[n] - w).max() <= 2e-4 * max(np.abs(w).max(), floor))
    assert off == DOUBLED  # the gradients: not, at the 4^2 stage's block2 convs
    for n in off:
        assert np.abs(got[n] - 2 * want[n]).max() <= 2e-4 * 2 * np.abs(want[n]).max()
