"""Flax variables -> this package's state_dict.

`state_dict_from_flax(variables, cfg)` takes the JAX DaNet's
`{'params', 'batch_stats'}` tree (numpy or array leaves) and returns the
state_dict of `models.danet.DaNet`. The names are the reference
checkpoint's, so the layout rules are the inverse of the JAX package's
`port/convert.py`:

  conv kernel HWIO            -> weight OIHW
  Dense kernel (I, O)         -> weight (O, I)
  PartwiseDense kernel (G,I,O)-> grouped 1x1 conv weight (G*O, I, 1, 1),
                 bias (G, O)  -> (G*O,)
  BatchNorm scale/bias + mean/var -> weight/bias + running_mean/running_var
  edge_importance (24, 24)    -> (1, 24, 24)

The block-level rule functions are public so tests can convert single
blocks. Each rule is (torch_key, flax_path, transform) with flax_path
starting at 'params' or 'batch_stats'.
"""

from __future__ import annotations

import numpy as np
import torch

from danet_densepose2smpl_tpu_torch.config import DaNetConfig
from danet_densepose2smpl_tpu_torch.nn.hrnet import HRNET_W48_STAGES


def _conv_w(w):
    return np.transpose(w, (3, 2, 0, 1))


def _dense_w(w):
    return np.transpose(w, (1, 0))


def _partwise_w(w):
    g, i, o = w.shape
    return np.transpose(w, (0, 2, 1)).reshape(g * o, i, 1, 1)


def _flat(b):
    return np.reshape(b, (-1,))


def _edge(w):
    return np.reshape(w, (1,) + w.shape)


def _j(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def conv_rules(tp: str, fp: tuple, bias: bool = False) -> list:
    rules = [(_j(tp, "weight"), ("params",) + fp + ("kernel",), _conv_w)]
    if bias:
        rules.append((_j(tp, "bias"), ("params",) + fp + ("bias",), None))
    return rules


def bn_rules(tp: str, fp: tuple) -> list:
    return [
        (_j(tp, "weight"), ("params",) + fp + ("scale",), None),
        (_j(tp, "bias"), ("params",) + fp + ("bias",), None),
        (_j(tp, "running_mean"), ("batch_stats",) + fp + ("mean",), None),
        (_j(tp, "running_var"), ("batch_stats",) + fp + ("var",), None),
    ]


def block_rules(tp: str, fp: tuple, bottleneck: bool, has_downsample: bool) -> list:
    """BasicBlock / Bottleneck."""
    rules = []
    for i in (1, 2, 3) if bottleneck else (1, 2):
        rules += conv_rules(_j(tp, f"conv{i}"), fp + (f"conv{i}",))
        rules += bn_rules(_j(tp, f"bn{i}"), fp + (f"bn{i}", "norm"))
    if has_downsample:
        rules += conv_rules(_j(tp, "downsample.0"), fp + ("downsample_conv",))
        rules += bn_rules(_j(tp, "downsample.1"), fp + ("downsample_bn", "norm"))
    return rules


def res_layer_rules(tp: str, fp: tuple, bottleneck: bool, num_blocks: int,
                    first_has_downsample: bool) -> list:
    rules = []
    for i in range(num_blocks):
        rules += block_rules(_j(tp, str(i)), fp + (str(i),), bottleneck,
                             i == 0 and first_has_downsample)
    return rules


_RESNET_COUNTS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
                  101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def smpl_resnet_rules(tp: str, fp: tuple, depth: int, num_classes: int, truncate: int = 0) -> list:
    bottleneck = depth >= 50
    exp = 4 if bottleneck else 1
    rules = conv_rules(_j(tp, "conv1"), fp + ("conv1",)) + bn_rules(_j(tp, "bn1"), fp + ("bn1", "norm"))
    in_ch = 64
    for li, planes in enumerate((64, 128, 256, 512)):
        if (li == 2 and truncate >= 2) or (li == 3 and truncate >= 1):
            break
        has_ds = li > 0 or in_ch != planes * exp
        rules += res_layer_rules(_j(tp, f"layer{li + 1}"), fp + (f"layer{li + 1}",), bottleneck,
                                 _RESNET_COUNTS[depth][li], has_ds)
        in_ch = planes * exp
    if num_classes > 0:
        rules += [
            (_j(tp, "final_layer.weight"), ("params",) + fp + ("final_layer", "kernel"), _dense_w),
            (_j(tp, "final_layer.bias"), ("params",) + fp + ("final_layer", "bias"), None),
        ]
    return rules


def hrnet_rules(stages, tp: str = "", fp: tuple = ()) -> list:
    rules = []
    for name in ("conv1", "conv2"):
        rules += conv_rules(_j(tp, name), fp + (name,))
    for name in ("bn1", "bn2"):
        rules += bn_rules(_j(tp, name), fp + (name, "norm"))
    rules += res_layer_rules(_j(tp, "layer1"), fp + ("layer1",), True, 4, True)
    prev = (256,)
    for s_idx, (num_modules, num_branches, num_blocks, channels) in enumerate(stages):
        t = s_idx + 1
        for i in range(num_branches):
            if i < len(prev) and prev[i] == channels[i]:
                continue
            tq = _j(tp, f"transition{t}.{i}" if i < len(prev) else f"transition{t}.{i}.0")
            rules += conv_rules(f"{tq}.0", fp + (f"transition{t}_{i}_conv",))
            rules += bn_rules(f"{tq}.1", fp + (f"transition{t}_{i}_bn", "norm"))
        for m in range(num_modules):
            mt, mf = _j(tp, f"stage{t + 1}.{m}"), fp + (f"stage{t + 1}_{m}",)
            for b in range(num_branches):
                rules += res_layer_rules(f"{mt}.branches.{b}", mf + (f"branch{b}",), False,
                                         num_blocks[b], False)
            last = s_idx == len(stages) - 1 and m == num_modules - 1
            for i in range(1 if last else num_branches):
                for j in range(num_branches):
                    if j > i:
                        rules += conv_rules(f"{mt}.fuse_layers.{i}.{j}.0", mf + (f"fuse{i}_{j}_conv",))
                        rules += bn_rules(f"{mt}.fuse_layers.{i}.{j}.1", mf + (f"fuse{i}_{j}_bn", "norm"))
                    for k in range(i - j):
                        rules += conv_rules(f"{mt}.fuse_layers.{i}.{j}.{k}.0", mf + (f"fuse{i}_{j}_{k}_conv",))
                        rules += bn_rules(f"{mt}.fuse_layers.{i}.{j}.{k}.1", mf + (f"fuse{i}_{j}_{k}_bn", "norm"))
        prev = channels
    return rules


def iuv_head_rules(tp: str, fp: tuple) -> list:
    rules = []
    for name in ("predict_u", "predict_v", "predict_uv_index", "predict_ann_index"):
        rules += conv_rules(_j(tp, name), fp + (name,), bias=True)
    rules += res_layer_rules(_j(tp, "predict_hm.0"), fp + ("hm_trunk",), True, 3, False)
    rules += conv_rules(_j(tp, "predict_hm.1"), fp + ("predict_hm",), bias=True)
    return rules


def gcn_rules(tp: str, fp: tuple, num_layers: int) -> list:
    rules = []
    for i in range(num_layers):
        rules += [
            (_j(tp, f"gc.{i}.weight"), ("params",) + fp + (f"gc{i}", "weight"), None),
            (_j(tp, f"gc.{i}.bias"), ("params",) + fp + (f"gc{i}", "bias"), None),
        ]
        rules += bn_rules(_j(tp, f"act.{i}.0"), fp + (f"bn{i}",))
    return rules


def partwise_rules(tp: str, fp: tuple) -> list:
    return [
        (_j(tp, "1.weight"), ("params",) + fp + ("kernel",), _partwise_w),
        (_j(tp, "1.bias"), ("params",) + fp + ("bias",), _flat),
    ]


def adapter_rules(tp: str, fp: tuple) -> list:
    return conv_rules(_j(tp, "0"), fp + ("Conv_0",)) + bn_rules(_j(tp, "1"), fp + ("NormAct_0", "norm"))


def decomposed_rules(cfg: DaNetConfig, tp: str = "", fp: tuple = ()) -> list:
    """DecomposedPredictor, 'gcn' strategy."""
    rules = adapter_rules(_j(tp, "body_net"), fp + ("body_adapter",))
    rules += smpl_resnet_rules(_j(tp, "body_net.3"), fp + ("body_net",), cfg.glo_num_layers, 13)
    rules += adapter_rules(_j(tp, "limb_net"), fp + ("limb_adapter",))
    rules += smpl_resnet_rules(_j(tp, "limb_net.3"), fp + ("limb_net",), cfg.limb_num_layers, 0, truncate=1)
    rules += res_layer_rules(_j(tp, "limb_reslayer.layer4"), fp + ("limb_reslayer", "layer4"),
                             cfg.limb_num_layers >= 50, _RESNET_COUNTS[cfg.limb_num_layers][3], True)
    rules += gcn_rules(_j(tp, "r2p_gcn"), fp + ("r2p_gcn",), 1)
    rules += gcn_rules(_j(tp, "refine_gcn"), fp + ("refine_gcn",), cfg.refinement.gcn_num_layer)
    rules += gcn_rules(_j(tp, "p2r_gcn"), fp + ("p2r_gcn",), 1)
    rules.append((_j(tp, "edge_importance"), ("params",) + fp + ("edge_importance",), _edge))
    for i in range(2):
        rules += partwise_rules(_j(tp, f"pose_regressors.{i}"), fp + (f"pose_regressor_{i}",))
        rules += partwise_rules(_j(tp, f"coord_regressors.{i}"), fp + (f"coord_regressor_{i}",))
    return rules


def danet_rules(cfg: DaNetConfig) -> list:
    """Every parameter and BatchNorm statistic of the serving DaNet."""
    rules = [
        ("img2iuv.learned_ratio", ("params", "img2iuv", "stn_ratio"), None),
        ("img2iuv.learned_offset", ("params", "img2iuv", "stn_offset"), None),
    ]
    rules += hrnet_rules(HRNET_W48_STAGES, "img2iuv.iuv_est", ("img2iuv", "backbone"))
    rules += iuv_head_rules("img2iuv.iuv_est.final_pred", ("img2iuv", "iuv_head"))
    rules += conv_rules("img2iuv.iuv_est.final_pred.predict_partial_iuv",
                        ("img2iuv", "partial_head", "predict_partial_iuv"), bias=True)
    rules += decomposed_rules(cfg, "iuv2smpl.smpl_para_Outs", ("iuv2smpl",))
    return rules


def convert(variables: dict, rules: list) -> dict:
    """Apply `rules` to a flax variables tree. Returns a state_dict of CPU
    tensors, with `num_batches_tracked` = 0 beside every BatchNorm."""
    sd = {}
    for torch_key, path, transform in rules:
        node = variables
        for name in path:
            node = node[name]
        val = np.asarray(node)
        sd[torch_key] = torch.from_numpy(np.ascontiguousarray(transform(val) if transform else val))
        if torch_key.endswith(".running_var"):
            sd[torch_key[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return sd


def state_dict_from_flax(variables: dict, cfg: DaNetConfig) -> dict:
    """The port's DaNet state_dict from the JAX DaNet's variables."""
    return convert(variables, danet_rules(cfg))
