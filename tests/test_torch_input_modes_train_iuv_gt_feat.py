"""'iuv_gt_feat''s training step against the JAX package
(`tests/test_torch_input_modes.py::check_train_step`: full W48 width,
64 px, B=4, f64, the GT render cast to f64 in both packages; losses rtol
1e-9, gradients within 1e-9 of their tensor's largest entry), one mode a
file: the JAX step's compile takes ~2-3 min of one xdist worker."""

from test_torch_input_modes import check_train_step, x64_mode  # noqa: F401 (a fixture)


def test_train_step_matches_jax_f64(x64_mode):  # noqa: F811
    """The global maps come from the GT render, the limb branch takes GT
    crops with the estimator's detached thetas, and the part losses still
    read the estimator's own stacks: the partial head gets gradients."""
    model = check_train_step("iuv_gt_feat")
    assert float(model.img2iuv.iuv_est.final_pred.predict_partial_iuv.weight.grad.abs().max()) > 0
