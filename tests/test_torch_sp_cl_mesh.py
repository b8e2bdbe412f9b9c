"""Data x spatial parallelism of the contrastive arms: one GlobalCL step of
the port on 4 gloo ranks, mesh (2, 2) over ("data", "spatial"), against the
JAX package's step on the same (2, 2) mesh of CPU devices with
``shard_spatial=True`` (``torch_sp_cl_worker.step_cases``).

Ranks 0 and 1 form data rank 0 and take images 0-1 of the global batch of
4, each 8 of their 16 rows; ranks 2 and 3 images 2-3. Each spatial group
builds the views of its two images whole, with JAX's draws of those rows,
its ranks each run the UNet on their rows, the mid map is gathered along H
for the head, and NT-Xent takes its negatives over the data group.
Tolerances and checks are ``test_torch_sp_cl.py``'s; all four ranks end with
the same loss and parameters. The control, views cropped from each rank's
own rows, must miss JAX's step.
"""

import pytest

import test_torch_sp_cl as SC
import test_torch_sp_steps as SS


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return SC.run_cl_cases(tmp_path_factory, (2, 2), ["global_cl"])


def test_data_x_spatial_global_cl_step_matches_jax_2x2_mesh(runs):
    SS.check(*runs, "global_cl")


def test_data_x_spatial_global_cl_control_views_cropped_from_local_rows_misses_jax(runs):
    want, _, got = runs
    assert SS.deviations(got[0]["global_cl", "views cropped from local rows"], want["global_cl"]) != []
