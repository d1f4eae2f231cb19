"""The eval path: pose MPJPE / PA-MPJPE and LSP segmentation scores."""

from danet_densepose2smpl_tpu_torch.eval.harness import PoseEvalResult, run_pose_eval  # noqa: F401
from danet_densepose2smpl_tpu_torch.eval.lsp import run_lsp_eval  # noqa: F401
from danet_densepose2smpl_tpu_torch.eval.metrics import SegmentationScores, compute_mpjpe  # noqa: F401
