"""JAX (params, batch_stats) trees -> the port's NeMo-keyed `state_dict`.

The exact inverse of tpu_asr/convert/nemo_import.py::convert_state_dict:

- Conv2d kernel (kh, kw, in, out) HWIO  -> weight (out, in, kh, kw); the
  pre-encode's conv{i} / dw_conv{i} / pw_conv{i} -> pre_encode.conv.{j},
  NeMo's Sequential indices (striding: 0, 2, 4, ..; dw_striding: 0, then
  2 + 3 (i - 1) and 3 + 3 (i - 1)); stacking's pre_norm and out ->
  pre_encode.pre_norm, pre_encode.proj_out; the factor-1 Linear `out` ->
  pre_encode
- reduction_subsampling.conv (f, d, d)  -> Conv1d weight (d, d, f)
- Dense kernel (in, out)                -> Linear weight (out, in)
- Dense as 1x1 Conv1d (in, out)         -> Conv1d weight (out, in, 1)
- depthwise Conv kernel (k, 1, d)       -> Conv1d weight (d, 1, k)
- LayerNorm / BatchNorm scale, bias     -> weight, bias (a layer-norm
  conv module's `norm` -> conv.batch_norm, NeMo's key for either norm)
- batch_stats mean, var                 -> running_mean, running_var
- stacked (L, ...) layer leaves         -> encoder.layers.{i}.*, and after
  a mid-stack reduction `layers_post`   -> encoder.layers_post.{i}.*
- the global-attention projections linear_{q,k,v}_global and the encoder's
  out_proj as Linear layers
- DistilCTCModel's params and batch_stats: 'student', 'teacher'
  -> student.*, teacher.*; the KD modules 'flow_matching' (any meta
  encoder), 'router', 'layer_proj', 'diffkd_mod' and 'diffm_pipeline'
  under their own names               (distil_to_state_dict, kd_to_state_dict)
- in the KD modules: Conv kernel (k, in/groups, out) -> Conv1d weight (out,
  in/groups, k); ConvTranspose kernel (k, in, out) -> ConvTranspose1d
  weight (in, out, k) flipped in time (torch's ConvTranspose1d(k=4, s=2,
  p=1) is flax's with padding (2, 2) and the kernel reversed); attention
  DenseGeneral query/key/value (d, heads, dh) -> Linear (heads * dh, d),
  out (heads, dh, d_out) -> Linear (d_out, heads * dh); Embed embedding ->
  weight; flax's automatic names LayerNorm_0, Dense_0, Dense_1 -> norm,
  linear1, linear2; block{i}, down{i}, up{i} -> blocks.{i}, downs.{i},
  ups.{i}

Leaves may be numpy or JAX arrays; this module imports no JAX.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from tpu_asr_torch.config import ModelConfig


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(sd, key, p):
    sd[f"{key}.weight"] = _t(p["kernel"]).T.contiguous()
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _conv1x1(sd, key, p):
    sd[f"{key}.weight"] = _t(p["kernel"]).T.contiguous()[..., None]
    sd[f"{key}.bias"] = _t(p["bias"])


def _norm(sd, key, p):
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])


def jax_to_state_dict(params: Dict[str, Any], batch_stats: Dict[str, Any],
                      cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    enc_p = params["encoder"]
    enc_s = batch_stats.get("encoder", {})
    sd.update(pre_encode_to_state_dict(enc_p["pre_encode"], cfg.encoder,
                                       "encoder.pre_encode"))
    for stack in ("layers", "layers_post"):
        if stack in enc_p:
            _layers(enc_p[stack], enc_s.get(stack, {}), f"encoder.{stack}",
                    sd)
    if "reduction_subsampling" in enc_p:
        conv = enc_p["reduction_subsampling"]["conv"]     # (f, d_in, d_out)
        sd["encoder.reduction_subsampling.conv.weight"] = _t(
            conv["kernel"]).permute(2, 1, 0).contiguous()
        sd["encoder.reduction_subsampling.conv.bias"] = _t(conv["bias"])
    if "out_proj" in enc_p:
        _dense(sd, "encoder.out_proj", enc_p["out_proj"])
    _conv1x1(sd, "decoder.decoder_layers.0",
             params["decoder"]["decoder_layers_0"])
    return sd


def pre_encode_to_state_dict(pre: Dict[str, Any], enc, prefix: str = ""
                             ) -> Dict[str, torch.Tensor]:
    """A JAX ConvSubsampling's params (EncoderConfig `enc`) -> the port's
    pre-encode `state_dict` (see the module note), its keys under
    `prefix.` when a prefix is given."""
    sd: Dict[str, torch.Tensor] = {}
    if enc.subsampling_factor <= 1 or not enc.subsampling:
        _dense(sd, "_", pre["out"])                  # a bare Linear
    else:
        if "pre_norm" in pre:
            _norm(sd, "pre_norm", pre["pre_norm"])
        if "conv0" not in pre:                       # stacking
            _dense(sd, "proj_out", pre["out"])
        else:
            _dense(sd, "out", pre["out"])
            i, convs = 1, [("0", pre["conv0"])]
            while f"conv{i}" in pre or f"dw_conv{i}" in pre:
                if f"dw_conv{i}" in pre:
                    convs += [(str(3 * i - 1), pre[f"dw_conv{i}"]),
                              (str(3 * i), pre[f"pw_conv{i}"])]
                else:
                    convs.append((str(2 * i), pre[f"conv{i}"]))
                i += 1
            for k, p in convs:           # (kh, kw, in, out) -> (out, in, ..)
                sd[f"conv.{k}.weight"] = _t(p["kernel"]).permute(
                    3, 2, 0, 1).contiguous()
                sd[f"conv.{k}.bias"] = _t(p["bias"])
    sd = {k.removeprefix("_."): v for k, v in sd.items()}
    return {f"{prefix}.{k}" if prefix else k: v for k, v in sd.items()}


def _layers(stacked, stats, prefix, sd) -> None:
    """The stacked (L, ...) layers of one scan segment -> prefix.{i}.*"""
    n = len(np.asarray(stacked["norm_out"]["scale"]))
    for i in range(n):
        layer = _index(stacked, i)
        k = f"{prefix}.{i}"
        for name in ("norm_feed_forward1", "norm_self_att", "norm_conv",
                     "norm_feed_forward2", "norm_out"):
            _norm(sd, f"{k}.{name}", layer[name])
        for ff in ("feed_forward1", "feed_forward2"):
            _dense(sd, f"{k}.{ff}.linear1", layer[ff]["linear1"])
            _dense(sd, f"{k}.{ff}.linear2", layer[ff]["linear2"])
        att = layer["self_attn"]
        for name in ("linear_q", "linear_k", "linear_v", "linear_out",
                     "linear_pos", "linear_q_global", "linear_k_global",
                     "linear_v_global"):
            if name in att:
                _dense(sd, f"{k}.self_attn.{name}", att[name])
        sd[f"{k}.self_attn.pos_bias_u"] = _t(att["pos_bias_u"])
        sd[f"{k}.self_attn.pos_bias_v"] = _t(att["pos_bias_v"])
        conv = layer["conv"]
        _conv1x1(sd, f"{k}.conv.pointwise_conv1", conv["pointwise_conv1"])
        sd[f"{k}.conv.depthwise_conv.weight"] = _t(
            conv["depthwise_conv"]["kernel"]).permute(2, 1, 0).contiguous()
        sd[f"{k}.conv.depthwise_conv.bias"] = _t(
            conv["depthwise_conv"]["bias"])
        _conv1x1(sd, f"{k}.conv.pointwise_conv2", conv["pointwise_conv2"])
        if "norm" in conv:                   # conv_norm_type='layer_norm'
            _norm(sd, f"{k}.conv.batch_norm", conv["norm"])
        else:
            _norm(sd, f"{k}.conv.batch_norm", conv["batch_norm"])
            bn = _index(stats, i)["conv"]["batch_norm"]
            sd[f"{k}.conv.batch_norm.running_mean"] = _t(bn["mean"])
            sd[f"{k}.conv.batch_norm.running_var"] = _t(bn["var"])
            sd[f"{k}.conv.batch_norm.num_batches_tracked"] = torch.tensor(0)


KD_MODULES = ("flow_matching", "router", "layer_proj", "diffkd_mod",
              "diffm_pipeline")
_AUTO_NAMES = {"LayerNorm_0": "norm", "Dense_0": "linear1",
               "Dense_1": "linear2"}
_LISTS = {"block": "blocks", "down": "downs", "up": "ups"}


def kd_to_state_dict(params: Dict[str, Any],
                     prefix: str = "") -> Dict[str, torch.Tensor]:
    """The params of a JAX KD module (FlowMatchingModule with any meta
    encoder, DynamicStepRouter, DiffKDModule, LatentKDPipeline, or a
    Dense) -> its port counterpart's `state_dict` (see the module note),
    keys under `prefix.` when given."""
    sd: Dict[str, torch.Tensor] = {}
    _kd_tree(params, prefix, "", sd)
    return sd


def _kd_tree(tree, prefix: str, name: str, sd) -> None:
    key = lambda leaf: f"{prefix}.{leaf}" if prefix else leaf
    if "embedding" in tree:
        sd[key("weight")] = _t(tree["embedding"])
        return
    if "scale" in tree:
        _norm(sd, prefix, tree)
        return
    if "kernel" in tree:
        k = _t(tree["kernel"])
        if k.dim() == 2:                                      # Dense
            sd[key("weight")] = k.T.contiguous()
        elif name in ("query", "key", "value"):               # (d, h, dh)
            sd[key("weight")] = k.reshape(k.shape[0], -1).T.contiguous()
        elif name == "out":                                   # (h, dh, o)
            sd[key("weight")] = k.reshape(-1, k.shape[-1]).T.contiguous()
        elif re.fullmatch(r"up\d+", name):                    # transposed
            sd[key("weight")] = k.flip(0).permute(1, 2, 0).contiguous()
        else:                                                 # Conv
            sd[key("weight")] = k.permute(2, 1, 0).contiguous()
        sd[key("bias")] = _t(tree["bias"]).reshape(-1)
        return
    for sub, child in tree.items():
        m = re.fullmatch(r"(block|down|up)(\d+)", sub)
        leaf = (f"{_LISTS[m[1]]}.{m[2]}" if m
                else _AUTO_NAMES.get(sub, sub))
        _kd_tree(child, key(leaf), sub, sd)


def distil_to_state_dict(params: Dict[str, Any], batch_stats: Dict[str, Any],
                         student_cfg: ModelConfig,
                         teacher_cfg: Optional[ModelConfig] = None
                         ) -> Dict[str, torch.Tensor]:
    """A JAX DistilCTCModel's whole tree -> the port's DistilCTCModel
    `state_dict`: params['student'] and batch_stats['student'] ->
    `student.*`, params['teacher'] and batch_stats['teacher'] ->
    `teacher.*` (needs `teacher_cfg`), each KD module of KD_MODULES ->
    `<its name>.*`. Any other subtree raises."""
    left = set(params) - {"student", "teacher", *KD_MODULES}
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
    for name in KD_MODULES:
        if name in params:
            sd.update(kd_to_state_dict(params[name], name))
    return sd


def _index(tree, i: int):
    """Layer i of a tree of stacked (L, ...) leaves."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]
