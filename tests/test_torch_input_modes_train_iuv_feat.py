"""'iuv_feat''s training step against the JAX package
(`tests/test_torch_input_modes.py::check_train_step`: full W48 width,
64 px, B=4, f64; losses rtol 1e-9, gradients within 1e-9 of their
tensor's largest entry), one mode a file: the JAX step's compile takes
~2-3 min of one xdist worker."""

from test_torch_input_modes import check_train_step, x64_mode  # noqa: F401 (a fixture)


def test_train_step_matches_jax_f64(x64_mode):  # noqa: F811
    """The body net takes the IUV maps and the backbone features, the limb
    net the cleaned stacks and the part crops of the features: both
    adapters and the backbone get gradients from the SMPL losses too."""
    model = check_train_step("iuv_feat")
    adapters = model.iuv2smpl.smpl_para_Outs
    assert adapters.body_net[0].weight.shape[1] == 75 + 48 and adapters.limb_net[0].weight.shape[1] == 21 + 48
