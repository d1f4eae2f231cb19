"""The refinement strategies of the decomposed regressor against the JAX
package on the CPU, each on the ResNet-18 DaNet at 64 px
(`tests/test_torch_archs.py::check_arch`): 'gcn_direct', 'lstm' (Bi-LSTMs
with the trunk chain's carry handoff), 'lstm_direct' (raw 9-channel heads,
eval-mode rotations) and the 'gcn' strategy without `refine_on` or without
`pos_intersupv`; eval `para` and the train-mode `joint_rotation` /
`joint_position` lists in f64, and each state_dict through the JAX
package's reference checkpoint map and back."""

import pytest
import torch

from test_torch_archs import check_arch, check_round_trip, x64_mode  # noqa: F401 (a fixture)

torch.set_num_threads(1)
STRATEGIES = ["gcn_direct", "lstm", "lstm_direct", "refine_off", "intersupv_off"]


@pytest.mark.parametrize("arch", STRATEGIES)
def test_refine_matches_jax_f64(arch, x64_mode):  # noqa: F811
    check_arch(arch)


@pytest.mark.parametrize("arch", STRATEGIES)
def test_refine_weight_bridge_round_trip(arch):
    check_round_trip(arch)
