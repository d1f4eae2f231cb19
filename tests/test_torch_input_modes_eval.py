"""The eval forward of 'iuv_gt_feat', 'feat' and 'seg' against the JAX
model (`tests/test_torch_input_modes.py::check_eval_forward`: full W48
width, 64 px, B=4, f64, rtol/atol 1e-9), in a file of their own so that
no test file keeps one xdist worker much longer than the others."""

import pytest

from test_torch_input_modes import check_eval_forward, x64_mode  # noqa: F401 (a fixture)


@pytest.mark.parametrize("name", ["iuv_gt_feat", "feat", "seg"])
def test_eval_forward_matches_jax_f64(name, x64_mode):  # noqa: F811
    check_eval_forward(name)
