"""Data x spatial parallelism: one TEDM head step of the port on 4 gloo
ranks, mesh (2, 2) over ("data", "spatial"), against the JAX package's step
under ``data_parallel_setup`` on the same (2, 2) mesh with
``shard_spatial=True``, on the CPU (``torch_sp_worker.step_cases``).

Rank r sits at ``divmod(r, 2)``: ranks 0 and 1 form data rank 0 and take
rows 0-1 of the global batch of 4, each 16 of their 32 rows of H; ranks 2
and 3 rows 2-3. The valid rows are [1, 1 | 1, 0], so the data ranks hold
unequal counts: the masked mean reduces over the data group, BatchNorm's
statistics over all four ranks (the data x spatial group), and DDP
averages over the four. Tolerances and checks are
``test_torch_sp_steps.py``'s; all four ranks end with the same loss and
parameters. The control, BatchNorm reduced over the data group alone, must
miss JAX's step.
"""

import pytest

import test_torch_sp_steps as SS


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return SS.run_sp_cases(tmp_path_factory, (2, 2), ["TEDM"])


def test_data_x_spatial_step_matches_jax_2x2_mesh(runs):
    SS.check(*runs, "TEDM")


def test_ranks_sit_at_divmod(runs):
    """Rank r of a (2, 2) mesh at (r // 2, r % 2), as JAX reshapes its
    devices row-major: (data rank, spatial rank, data size, spatial size)."""
    _, _, got = runs
    assert [g["where"] for g in got] == [(0, 0, 2, 2), (0, 1, 2, 2), (1, 0, 2, 2), (1, 1, 2, 2)]


def test_data_x_spatial_control_batchnorm_over_the_data_group_misses_jax(runs):
    want, _, got = runs
    assert SS.deviations(got[0]["TEDM", "BatchNorm over the data group"], want["TEDM"]) != []
