"""One tensor-parallel training step of the port on 2 gloo ranks, mesh (1, 2)
over ("data", "model") at ``--tp_min_width 16``, against the JAX package's
step under ``data_parallel_setup`` on the same (1, 2) mesh with
``param_sharding="tp"``, on the CPU (``torch_tp_worker.step_cases``).

Both ranks take the whole global batch of 4 (valid rows [1, 1, 1, 0]); each
holds its out-channel rows of every weight the rule shards, convolves with
them and gathers. Cases: the backbone (``img_only``, a UNet of one stage)
and the TEDM head on it, its frozen backbone sharded too. Weights come from
JAX's init through ``utils.convert``; t, noise and feature noise are JAX's
draws. Tolerances are ``test_torch_parallel_steps.py``'s: the loss to 1e-5
relative, the parameters to 1e-3 * lr where the gradient is significant,
else 2 * lr, BatchNorm statistics to 1e-6 absolute and 1e-5 relative. Both
ranks end with the same loss and parameters; every gathered activation was
computed as half its channels on each rank; each rank holds exactly the
rule's share of the parameter bytes. The control, each step with the model
group's input-gradient sum taken out, must miss JAX's step.
"""

import os

import numpy as np
import pytest
import torch

import test_torch_parallel_steps as S
import torch_parallel_worker as W
import torch_tp_worker as T
from tedm_tpu.config import Config as JaxConfig
from tedm_tpu.parallel import data_parallel_setup

CASES = ["img_only", "TEDM"]


def jax_tp_mesh(shape):
    """JAX's wiring of a (data, model) mesh of ``shape`` under ``tp``."""
    return lambda batch: data_parallel_setup(
        JaxConfig(mesh_shape=shape, mesh_axes=("data", "model"), param_sharding="tp", tp_min_width=T.TP_MIN), batch)


def run_tp_cases(tmp_path_factory, shape, cases):
    """JAX's steps of ``cases`` on its ``shape`` mesh here, then the port's
    ranks in one spawn."""
    tmp = str(tmp_path_factory.mktemp("tp_steps"))
    inputs, want = {}, {}
    with W.patched(S, "mesh2", jax_tp_mesh(shape)):
        for name in cases:
            inputs[name], want[name] = S.JAX_STEPS[name](tmp)
    path = os.path.join(tmp, "inputs.pt")
    torch.save(inputs, path)
    world = shape[0] * shape[1]
    W.spawn(T.step_cases, world, tmp, path, tmp, shape, timeout=300)
    return want, [torch.load(os.path.join(tmp, f"steps{r}.pt"), weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_tp_cases(tmp_path_factory, (1, 2), CASES)


def check_step(want, got, case):
    r0 = got[0][case]
    assert S.deviations(r0, want[case]) == []
    for other in got[1:]:
        assert other[case]["loss"] == r0["loss"]  # the global loss, on every rank
        for name, v in r0["params"].items():
            np.testing.assert_array_equal(other[case]["params"][name], v, err_msg=name)
    if case == "TEDM":
        np.testing.assert_allclose(r0["per_fold"], want[case]["per_fold"], rtol=1e-5, atol=0)
    assert r0["bytes"]["held"] == r0["bytes"]["rule"] < r0["bytes"]["full"]


@pytest.mark.parametrize("case", CASES)
def test_tp_step_matches_jax_1x2_mesh(runs, case):
    want, got = runs
    check_step(want, got, case)


def test_tp_conv_computes_its_half_of_the_out_channels(runs):
    _, got = runs
    widths = got[0]["img_only"]["widths"]
    assert widths and all(2 * local == full for local, full in widths)
    bb = got[0]["TEDM"]["backbone_bytes"]  # the frozen backbone is sharded as the trained one
    assert bb["held"] == bb["rule"] < bb["full"]


@pytest.mark.parametrize("case", CASES)
def test_tp_control_without_input_gradient_sum_misses_jax(runs, case):
    want, got = runs
    assert S.deviations(got[0][case, "no input-gradient sum"], want[case]) != []
