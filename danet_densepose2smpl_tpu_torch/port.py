"""Flax variables -> this package's state_dict.

`state_dict_from_flax(variables, cfg)` takes the JAX DaNet's
`{'params', 'batch_stats'}` tree (numpy or array leaves) and returns the
state_dict of `models.danet.DaNet` for that config (either backbone, every
refinement strategy, the GlobalPredictor); `hmr_state_dict_from_flax` does
the same for the HMR baseline (`nn.hmr.HMR`). The names are the reference
checkpoint's (the GlobalPredictor's, unknown there, follow the flax tree),
so the layout rules are the inverse of the JAX package's `port/convert.py`:

  conv kernel HWIO            -> weight OIHW
  ConvTranspose kernel HWIO   -> weight (I, O, kh, kw), flipped in both
                                 spatial axes (flax's transposed conv does
                                 not flip; torch's does)
  Dense kernel (I, O)         -> weight (O, I)
  PartwiseDense kernel (G,I,O)-> grouped 1x1 conv weight (G*O, I, 1, 1),
                 bias (G, O)  -> (G*O,)
  BatchNorm scale/bias + mean/var -> weight/bias + running_mean/running_var
  edge_importance (24, 24)    -> (1, 24, 24)
  OptimizedLSTMCell gate Dense kernels (I, F), i f g o
                              -> weight_ih / weight_hh (4F, I), the gates
                                 stacked in torch's order (the same); the
                                 cell's one bias (on the h-gates) ->
                                 bias_ih, and bias_hh = 0 (torch adds both)

The block-level rule functions are public so tests can convert single
blocks. Each rule is (torch_key, flax_path, transform) with flax_path
starting at 'params' or 'batch_stats'; a rule that gathers several leaves
into one tensor has a list of paths, and its transform takes the list.
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


def _deconv_w(w):
    return np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1))[:, :, ::-1, ::-1])


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


def mlp1x1_rules(tp: str, fp: tuple) -> list:
    """MLP1x1: torch Sequential(conv, bn, relu, conv, bn, relu)."""
    rules = []
    for i, (conv_key, bn_key) in enumerate((("0", "1"), ("3", "4"))):
        rules += conv_rules(_j(tp, conv_key), fp + (f"Conv_{i}",), bias=True)
        rules += bn_rules(_j(tp, bn_key), fp + (f"NormAct_{i}", "norm"))
    return rules


def _gate_stack(kernels):
    """flax's gate kernels (I, F), i f g o -> torch's stacked (4F, I)."""
    return np.concatenate([np.transpose(k, (1, 0)) for k in kernels], axis=0)


def _zero_bias(biases):
    return np.zeros_like(np.concatenate(biases))


def lstm_rules(tp: str, fp: tuple) -> list:
    """A flax BiLSTM (its fwd and bwd OptimizedLSTMCells) -> one
    bidirectional torch.nn.LSTM."""
    rules = []
    for cell, sfx in (("OptimizedLSTMCell_0", ""), ("OptimizedLSTMCell_1", "_reverse")):
        path = ("params",) + fp + (cell,)
        h_bias = [path + ("h" + g, "bias") for g in "ifgo"]
        rules += [
            (_j(tp, f"weight_ih_l0{sfx}"), [path + ("i" + g, "kernel") for g in "ifgo"], _gate_stack),
            (_j(tp, f"weight_hh_l0{sfx}"), [path + ("h" + g, "kernel") for g in "ifgo"], _gate_stack),
            (_j(tp, f"bias_ih_l0{sfx}"), h_bias, np.concatenate),
            (_j(tp, f"bias_hh_l0{sfx}"), h_bias, _zero_bias),
        ]
    return rules


def decomposed_rules(cfg: DaNetConfig, tp: str = "", fp: tuple = ()) -> list:
    """DecomposedPredictor, every refinement strategy."""
    r = cfg.refinement
    rules = adapter_rules(_j(tp, "body_net"), fp + ("body_adapter",))
    rules += smpl_resnet_rules(_j(tp, "body_net.3"), fp + ("body_net",), cfg.glo_num_layers, 13)
    rules += adapter_rules(_j(tp, "limb_net"), fp + ("limb_adapter",))
    rules += smpl_resnet_rules(_j(tp, "limb_net.3"), fp + ("limb_net",), cfg.limb_num_layers, 0, truncate=1)
    rules += res_layer_rules(_j(tp, "limb_reslayer.layer4"), fp + ("limb_reslayer", "layer4"),
                             cfg.limb_num_layers >= 50, _RESNET_COUNTS[cfg.limb_num_layers][3], True)
    positions = cfg.joint_position_weights > 0 and r.pos_intersupv
    rules += partwise_rules(_j(tp, "pose_regressors.0"), fp + ("pose_regressor_0",))
    if cfg.refine_strategy in ("gcn", "gcn_direct"):
        gcn = cfg.refine_strategy == "gcn"
        if gcn:
            rules += gcn_rules(_j(tp, "r2p_gcn"), fp + ("r2p_gcn",), 1)
            rules += gcn_rules(_j(tp, "p2r_gcn"), fp + ("p2r_gcn",), 1)
        if r.refine_on:
            rules += gcn_rules(_j(tp, "refine_gcn"), fp + ("refine_gcn",), r.gcn_num_layer)
            rules.append((_j(tp, "edge_importance"), ("params",) + fp + ("edge_importance",), _edge))
        rules += partwise_rules(_j(tp, "pose_regressors.1"), fp + ("pose_regressor_1",))
        if gcn and positions:
            for i in range(2 if r.refine_on else 1):
                rules += partwise_rules(_j(tp, f"coord_regressors.{i}"), fp + (f"coord_regressor_{i}",))
        return rules
    direct = cfg.refine_strategy == "lstm_direct"
    for s in range(r.stack_num):
        for j in range(5):
            rules += lstm_rules(_j(tp, f"limb_lstm.{s}.{j}"), fp + (f"lstm_{s}_{j}",))
        head = f"pose_regressor_direct_{s}" if direct else f"pose_regressor_{s + 1}"
        rules += partwise_rules(_j(tp, f"pose_regressors.{s + 1}"), fp + (head,))
        if direct:
            continue
        for ind in range(24):
            rules += mlp1x1_rules(_j(tp, f"rot2pos.{s}.{ind}"), fp + (f"rot2pos_{s}_{ind}",))
        rules += mlp1x1_rules(_j(tp, f"pos2rot.{s}"), fp + (f"pos2rot_{s}",))
        if positions:
            rules += partwise_rules(_j(tp, f"coord_regressors.{2 * s}"), fp + (f"coord_regressor_{s}_pre",))
            rules += partwise_rules(_j(tp, f"coord_regressors.{2 * s + 1}"), fp + (f"coord_regressor_{s}_post",))
    return rules


def global_rules(cfg: DaNetConfig, tp: str = "", fp: tuple = ()) -> list:
    """GlobalPredictor: the adapter and the ResNet, named after the flax tree."""
    rules = adapter_rules(_j(tp, "Conv1x1BNRelu_0"), fp + ("Conv1x1BNRelu_0",))
    return rules + smpl_resnet_rules(_j(tp, "conv_body"), fp + ("conv_body",), cfg.glo_num_layers, 229)


def pose_resnet_rules(tp: str, fp: tuple, depth: int) -> list:
    """PoseResNet: the ResNet trunk and the 3 deconv layers (torch
    `deconv_layers.{0,3,6}` convs, `{1,4,7}` BatchNorms)."""
    rules = smpl_resnet_rules(tp, fp, depth, 0)
    for i in range(3):
        rules.append((_j(tp, f"deconv_layers.{3 * i}.weight"),
                      ("params",) + fp + (f"deconv{i}", "ConvTranspose_0", "kernel"), _deconv_w))
        rules += bn_rules(_j(tp, f"deconv_layers.{3 * i + 1}"), fp + (f"deconv{i}", "NormAct_0", "norm"))
    return rules


def danet_rules(cfg: DaNetConfig) -> list:
    """Every parameter and BatchNorm statistic of the DaNet for `cfg`. The
    input modes change the regressor's adapter shapes only, except
    'iuv_gt', whose JAX model has no estimator: its trainable STN
    ratio/offset sit at the top of the flax tree and keep the estimator's
    torch names."""
    if cfg.input_mode == "iuv_gt":
        rules = [("img2iuv.learned_ratio", ("params", "stn_ratio"), None),
                 ("img2iuv.learned_offset", ("params", "stn_offset"), None)]
    else:
        rules = []
        if cfg.decomposed:
            rules += [
                ("img2iuv.learned_ratio", ("params", "img2iuv", "stn_ratio"), None),
                ("img2iuv.learned_offset", ("params", "img2iuv", "stn_offset"), None),
            ]
        if cfg.iuv_regressor == "hrnet":
            rules += hrnet_rules(HRNET_W48_STAGES, "img2iuv.iuv_est", ("img2iuv", "backbone"))
        else:
            rules += pose_resnet_rules("img2iuv.iuv_est", ("img2iuv", "backbone"), cfg.msres_num_layers)
        rules += iuv_head_rules("img2iuv.iuv_est.final_pred", ("img2iuv", "iuv_head"))
        if cfg.decomposed:
            rules += conv_rules("img2iuv.iuv_est.final_pred.predict_partial_iuv",
                                ("img2iuv", "partial_head", "predict_partial_iuv"), bias=True)
    if cfg.decomposed:
        rules += decomposed_rules(cfg, "iuv2smpl.smpl_para_Outs", ("iuv2smpl",))
    else:
        rules += global_rules(cfg, "iuv2smpl.smpl_para_Outs", ("iuv2smpl",))
    return rules


def hmr_rules() -> list:
    """The HMR baseline (torchvision-style ResNet-50 names, fc1/fc2 and the
    decpose/decshape/deccam heads)."""
    rules = conv_rules("conv1", ("conv1",)) + bn_rules("bn1", ("bn1", "norm"))
    for li, n in enumerate(_RESNET_COUNTS[50]):
        rules += res_layer_rules(f"layer{li + 1}", (f"layer{li + 1}",), True, n, True)
    for name in ("fc1", "fc2", "decpose", "decshape", "deccam"):
        rules += [(f"{name}.weight", ("params", name, "kernel"), _dense_w),
                  (f"{name}.bias", ("params", name, "bias"), None)]
    return rules


def convert(variables: dict, rules: list) -> dict:
    """Apply `rules` to a flax variables tree. Returns a state_dict of CPU
    tensors, with `num_batches_tracked` = 0 beside every BatchNorm."""
    def leaf(path):
        node = variables
        for name in path:
            node = node[name]
        return np.asarray(node)

    sd = {}
    for torch_key, path, transform in rules:
        if isinstance(path, list):
            val = transform([leaf(p) for p in path])
        else:
            val = leaf(path)
            val = transform(val) if transform else val
        sd[torch_key] = torch.from_numpy(np.ascontiguousarray(val))
        if torch_key.endswith(".running_var"):
            sd[torch_key[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return sd


def state_dict_from_flax(variables: dict, cfg: DaNetConfig) -> dict:
    """The port's DaNet state_dict from the JAX DaNet's variables."""
    return convert(variables, danet_rules(cfg))


def hmr_state_dict_from_flax(variables: dict) -> dict:
    """The port's HMR state_dict from the JAX HMR's variables."""
    return convert(variables, hmr_rules())
