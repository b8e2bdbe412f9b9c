"""Data x tensor parallelism: one training step of the port on 4 gloo ranks,
mesh (2, 2) over ("data", "model") at ``--tp_min_width 16``, against the
JAX package's step under ``data_parallel_setup`` on the same (2, 2) mesh with
``param_sharding="tp"``, on the CPU (``torch_tp_worker.step_cases``).

Ranks 0 and 1 form data rank 0 and take rows 0-1 of the global batch of 4,
ranks 2 and 3 rows 2-3; the valid rows are [1, 1 | 1, 0], so the data
ranks hold unequal counts. The masked mean, the loss's scale and
BatchNorm's statistics reduce over the data group only. Cases, tolerances
and checks are ``test_torch_tp_steps.py``'s; all four ranks end with the
same loss and parameters. Controls that must miss JAX's step: the model
group's input-gradient sum taken out, and the data axis's reductions taken
over all four ranks (each row counted twice).
"""

import pytest

import test_torch_tp_steps as TS

CASES = ["img_only", "TEDM"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return TS.run_tp_cases(tmp_path_factory, (2, 2), CASES)


@pytest.mark.parametrize("case", CASES)
def test_dp_x_tp_step_matches_jax_2x2_mesh(runs, case):
    want, got = runs
    TS.check_step(want, got, case)


@pytest.mark.parametrize("control", ["no input-gradient sum", "reductions over the world"])
@pytest.mark.parametrize("case", CASES)
def test_dp_x_tp_controls_miss_jax(runs, case, control):
    want, got = runs
    assert TS.S.deviations(got[0][case, control], want[case]) != []
