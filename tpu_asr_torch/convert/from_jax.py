"""JAX (params, batch_stats) trees -> the port's NeMo-keyed `state_dict`.

The exact inverse of tpu_asr/convert/nemo_import.py::convert_state_dict:

- Conv2d kernel (kh, kw, in, out) HWIO  -> weight (out, in, kh, kw)
- Dense kernel (in, out)                -> Linear weight (out, in)
- Dense as 1x1 Conv1d (in, out)         -> Conv1d weight (out, in, 1)
- depthwise Conv kernel (k, 1, d)       -> Conv1d weight (d, 1, k)
- LayerNorm / BatchNorm scale, bias     -> weight, bias (a layer-norm
  conv module's `norm` -> conv.batch_norm, NeMo's key for either norm)
- batch_stats mean, var                 -> running_mean, running_var
- stacked (L, ...) layer leaves         -> encoder.layers.{i}.*
- DistilCTCModel's params and batch_stats: 'student', 'teacher'
  -> student.*, teacher.*; 'flow_matching' -> flow_matching.*
                                        (distil_to_state_dict)

Leaves may be numpy or JAX arrays; this module imports no JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from tpu_asr_torch.config import ModelConfig


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def jax_to_state_dict(params: Dict[str, Any], batch_stats: Dict[str, Any],
                      cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}

    def dense(key, p):
        sd[f"{key}.weight"] = _t(p["kernel"]).T.contiguous()
        if "bias" in p:
            sd[f"{key}.bias"] = _t(p["bias"])

    def conv1x1(key, p):
        sd[f"{key}.weight"] = _t(p["kernel"]).T.contiguous()[..., None]
        sd[f"{key}.bias"] = _t(p["bias"])

    def norm(key, p):
        sd[f"{key}.weight"] = _t(p["scale"])
        sd[f"{key}.bias"] = _t(p["bias"])

    pre = params["encoder"]["pre_encode"]
    n_stages = {2: 1, 4: 2, 8: 3}[cfg.encoder.subsampling_factor]
    for i in range(n_stages):
        conv = pre[f"conv{i}"]
        key = f"encoder.pre_encode.conv.{2 * i}"
        sd[f"{key}.weight"] = _t(conv["kernel"]).permute(3, 2, 0,
                                                         1).contiguous()
        sd[f"{key}.bias"] = _t(conv["bias"])
    dense("encoder.pre_encode.out", pre["out"])

    stacked = params["encoder"]["layers"]
    stats = batch_stats.get("encoder", {}).get("layers", {})
    for i in range(cfg.encoder.n_layers):
        layer = _index(stacked, i)
        k = f"encoder.layers.{i}"
        for name in ("norm_feed_forward1", "norm_self_att", "norm_conv",
                     "norm_feed_forward2", "norm_out"):
            norm(f"{k}.{name}", layer[name])
        for ff in ("feed_forward1", "feed_forward2"):
            dense(f"{k}.{ff}.linear1", layer[ff]["linear1"])
            dense(f"{k}.{ff}.linear2", layer[ff]["linear2"])
        att = layer["self_attn"]
        for name in ("linear_q", "linear_k", "linear_v", "linear_out",
                     "linear_pos"):
            dense(f"{k}.self_attn.{name}", att[name])
        sd[f"{k}.self_attn.pos_bias_u"] = _t(att["pos_bias_u"])
        sd[f"{k}.self_attn.pos_bias_v"] = _t(att["pos_bias_v"])
        conv = layer["conv"]
        conv1x1(f"{k}.conv.pointwise_conv1", conv["pointwise_conv1"])
        sd[f"{k}.conv.depthwise_conv.weight"] = _t(
            conv["depthwise_conv"]["kernel"]).permute(2, 1, 0).contiguous()
        sd[f"{k}.conv.depthwise_conv.bias"] = _t(
            conv["depthwise_conv"]["bias"])
        conv1x1(f"{k}.conv.pointwise_conv2", conv["pointwise_conv2"])
        if "norm" in conv:                   # conv_norm_type='layer_norm'
            norm(f"{k}.conv.batch_norm", conv["norm"])
        else:
            norm(f"{k}.conv.batch_norm", conv["batch_norm"])
            bn = _index(stats, i)["conv"]["batch_norm"]
            sd[f"{k}.conv.batch_norm.running_mean"] = _t(bn["mean"])
            sd[f"{k}.conv.batch_norm.running_var"] = _t(bn["var"])
            sd[f"{k}.conv.batch_norm.num_batches_tracked"] = torch.tensor(0)
    conv1x1("decoder.decoder_layers.0",
            params["decoder"]["decoder_layers_0"])
    return sd


def flow_to_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX FlowMatchingModule's params (the `mlp` meta encoder) -> the
    port's FlowMatchingModule `state_dict`."""
    sd: Dict[str, torch.Tensor] = {}
    euler = params["euler"]
    dense = {"euler.time_embed": euler["time_embed"],
             "euler.meta_encoder.fc1": euler["meta_encoder"]["fc1"],
             "euler.meta_encoder.fc2": euler["meta_encoder"]["fc2"]}
    if "shape_transform" in params:
        dense["shape_transform"] = params["shape_transform"]
    for key, p in dense.items():
        sd[f"{key}.weight"] = _t(p["kernel"]).T.contiguous()
        sd[f"{key}.bias"] = _t(p["bias"])
    if "shape_transform_conv" in params:     # kernel (1, C, C_t)
        p = params["shape_transform_conv"]
        sd["shape_transform_conv.weight"] = _t(p["kernel"])[0].T \
            .contiguous()[..., None]
        sd["shape_transform_conv.bias"] = _t(p["bias"])
    return sd


def distil_to_state_dict(params: Dict[str, Any], batch_stats: Dict[str, Any],
                         student_cfg: ModelConfig,
                         teacher_cfg: Optional[ModelConfig] = None
                         ) -> Dict[str, torch.Tensor]:
    """A JAX DistilCTCModel's whole tree -> the port's DistilCTCModel
    `state_dict`: params['student'] and batch_stats['student'] ->
    `student.*`, params['teacher'] and batch_stats['teacher'] ->
    `teacher.*` (needs `teacher_cfg`), params['flow_matching'] ->
    `flow_matching.*`. Any other subtree raises."""
    left = set(params) - {"student", "teacher", "flow_matching"}
    if left:
        raise ValueError(f"distil_to_state_dict: no port counterpart for "
                         f"{sorted(left)}")
    sd = {f"student.{k}": v for k, v in jax_to_state_dict(
        params["student"], batch_stats.get("student", {}),
        student_cfg).items()}
    if "teacher" in params:
        if teacher_cfg is None:
            raise ValueError("distil_to_state_dict: the tree has a teacher; "
                             "pass teacher_cfg")
        sd.update({f"teacher.{k}": v for k, v in jax_to_state_dict(
            params["teacher"], batch_stats.get("teacher", {}),
            teacher_cfg).items()})
    if "flow_matching" in params:
        sd.update({f"flow_matching.{k}": v for k, v in
                   flow_to_state_dict(params["flow_matching"]).items()})
    return sd


def _index(tree, i: int):
    """Layer i of a tree of stacked (L, ...) leaves."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]
