"""'feat''s training step against the JAX package
(`tests/test_torch_input_modes.py::check_train_step`: full W48 width,
64 px, B=4, f64; losses rtol 1e-9, gradients within 1e-9 of their
tensor's largest entry), and its gradient routing, one mode a file: the
JAX step's compile takes ~2-3 min of one xdist worker."""

import numpy as np
import torch

from test_torch_input_modes import BATCH, SIZE, check_train_step, x64_mode  # noqa: F401 (a fixture)


def test_train_step_matches_jax_f64(x64_mode):  # noqa: F811
    """Then, as `tests/test_danet_model.py::test_feat_mode_gradient_routing`
    checks the JAX model: a loss of `para` alone reaches the backbone but
    not the global U head (its maps feed the IUV losses only)."""
    model = check_train_step("feat")
    model.zero_grad(set_to_none=True)
    x = torch.from_numpy(np.random.RandomState(2).rand(BATCH, SIZE, SIZE, 3))
    (model(x, noise={})["para"] ** 2).sum().backward()
    est = model.img2iuv.iuv_est
    assert est.final_pred.predict_u.weight.grad is None
    assert sum(float(p.grad.abs().sum()) for n, p in est.named_parameters()
               if not n.startswith("final_pred") and p.grad is not None) > 0
