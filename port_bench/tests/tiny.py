"""The cells cut to a size a CPU test run holds: a ResNet-18 backbone at
64 px, batches of 4, fp32 training."""

TINY_DANET = {"iuv_regressor": "resnet", "msres_num_layers": 18, "img_size": 64, "heatmap_size": 16}
TINY_SERVE = {"batch": 4, "pool": 3, "warmup": 1, "check_requests": 3, "reference_block": 4,
              "slice_requests": 2}
TINY_TRAIN = {"batch": 4, "distinct_batches": 4, "frame": 80, "slice_steps": 1}
SEED = 2 ** 31 + 977


def tiny(workload: str, **danet) -> dict:
    train = "train" in workload
    d = dict(TINY_DANET, **({"compute_dtype": "float32"} if train else {}), **danet)
    return {"danet": d, "traffic": TINY_TRAIN if train else TINY_SERVE}

# Limits at this size, on the numbers each cell compares (limits/*.json,
# set from full-size runs on the card, where answers and rounding differ).
# Sound tiny runs read a tenth of these or less on the CPU (joints and
# vertices up to 5.4e-5, para_median 4.9e-6, the nearest ratios 3.8e-4;
# loss 0.010, change 0.14, change_median 0.0084, loss_iuv1 and
# grad_median under 5e-6); the planted faults and the fp8 control read
# over these on at least one (joints 0.07-0.14, the faults' nearest ratios
# 1.7e4 or more, fp8's 1.4-1.9, para_median 2.2-2.3; half loss 0.30-0.32,
# loss_iuv1 0.61-0.74, grad_median 31-78; unchanged change 1; fp8 grad_median
# 0.044-0.18).
NEAREST = {"para_nearest": 0.01, "vertices_nearest": 0.01, "joints_nearest": 0.01}
TINY_LIMITS = {
    "w48-serve-fp32-b64": {"para_median": 1e-4, "para_p10": 1e-4, **NEAREST},
    "r50-serve-fp32-b64": {"joints": 1e-3, "para_median": 1e-4, "para_p10": 1e-4, "vertices": 1e-3, **NEAREST},
    "w48-train-bf16-b128": {"change": 0.5, "change_median": 0.03, "grad_median": 0.01, "loss": 0.1,
                            "loss_iuv1": 1e-3},
}
