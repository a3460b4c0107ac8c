"""The port's five optimizers (tpu_asr_torch/train/optim.py) against
optax as tpu_asr/train/optim.py builds them (adamw, adam, sgd, novograd,
adafactor; Noam schedule; global-norm clipping; the teacher frozen).

- Three steps of seeded numpy gradients, at global norms below and above
  the clipping threshold 0.5, go through optax's update and the port's (the
  port clips with the train step's own functions), on a model whose leaves
  have JAX's shapes: a 2-layer scan segment (`student.encoder.layers.{i}`:
  an FFN kernel (2, 128, 512) that adafactor factors, its bias, a norm
  scale), a decoder, a meta encoder's MultiHeadAttention (JAX's query /
  key / value kernels (128, 2, 64) and biases (2, 64), its out kernel
  (2, 64, 128)) and a frozen `teacher`: every parameter within 1e-6 of
  optax's, relative to its tensor's largest magnitude; the teacher
  bit-unchanged.
- The grouping of a real DistilCTCModel's per-layer tensors (FM-KT with the
  `swin` meta encoder) into optax's leaves, against JAX's tree from
  jax.eval_shape of its init: one group per JAX leaf, of the same size.
"""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

import tpu_asr.config as JC
import tpu_asr_torch.config as PC
from tpu_asr.models.distil_model import DistilCTCModel as JaxDistil
from tpu_asr.train.optim import build_optimizer as jax_build_optimizer
from tpu_asr_torch.kd.meta_encoders import MultiHeadAttention
from tpu_asr_torch.models.distil_model import DistilCTCModel
from tpu_asr_torch.train.optim import (OPTIMIZERS, build_optimizer,
                                       clip_by_global_norm, global_norm,
                                       optax_leaves, set_lr)

D, F, H = 128, 512, 2


class Layer(nn.Module):
    def __init__(self):
        super().__init__()
        self.linear1 = nn.Linear(D, F)
        self.norm_out = nn.LayerNorm(D)


class Port(nn.Module):
    """student.encoder.layers.{0,1}, student.decoder, flow_matching's
    attention and a teacher: the port's names for JAX's tree below."""

    def __init__(self):
        super().__init__()
        self.student = nn.Module()
        self.student.encoder = nn.Module()
        self.student.encoder.layers = nn.ModuleList([Layer(), Layer()])
        self.student.decoder = nn.Linear(D, 17)
        self.flow_matching = nn.Module()
        self.flow_matching.attn = MultiHeadAttention(D, H)
        self.teacher = nn.Linear(D, D)


def _jax_tree(seed, scale=None):
    rng = np.random.default_rng(seed)

    def a(*shape, kind="w"):
        n = rng.normal(size=shape).astype(np.float32)
        if scale is not None:
            return np.float32(scale) * n
        return (1 + np.float32(0.1) * np.abs(n)) if kind == "scale" else \
            n / np.float32(np.sqrt(shape[-2] if kind == "w" else 10))

    dense = lambda *s: {"kernel": a(*s), "bias": a(*s[:-2], s[-1],
                                                       kind="b")}
    mha = {k: {"kernel": a(D, H, D // H), "bias": a(H, D // H, kind="b")}
           for k in ("query", "key", "value")}
    mha["out"] = {"kernel": a(H, D // H, D, kind="b"), "bias": a(D, kind="b")}
    return {"student": {"encoder": {"layers": {
                "feed_forward1": {"linear1": dense(2, D, F)},
                "norm_out": {"scale": a(2, D, kind="scale"),
                             "bias": a(2, D, kind="b")}}},
                        "decoder": dense(D, 17)},
            "flow_matching": {"attn": mha},
            "teacher": dense(D, D)}


def _state_dict(tree):
    """JAX's tree -> the Port's state_dict."""
    t = lambda x: torch.from_numpy(np.array(x, np.float32))
    lay = tree["student"]["encoder"]["layers"]
    sd = {}
    for i in range(2):
        k = f"student.encoder.layers.{i}"
        sd[f"{k}.linear1.weight"] = t(lay["feed_forward1"]["linear1"][
            "kernel"][i]).T.contiguous()
        sd[f"{k}.linear1.bias"] = t(lay["feed_forward1"]["linear1"]["bias"][i])
        sd[f"{k}.norm_out.weight"] = t(lay["norm_out"]["scale"][i])
        sd[f"{k}.norm_out.bias"] = t(lay["norm_out"]["bias"][i])
    for key, p in (("student.decoder", tree["student"]["decoder"]),
                   ("teacher", tree["teacher"])):
        sd[f"{key}.weight"] = t(p["kernel"]).T.contiguous()
        sd[f"{key}.bias"] = t(p["bias"])
    for name, p in tree["flow_matching"]["attn"].items():
        k = t(p["kernel"])
        k = k.reshape(D, -1) if name != "out" else k.reshape(-1, D)
        sd[f"flow_matching.attn.{name}.weight"] = k.T.contiguous()
        sd[f"flow_matching.attn.{name}.bias"] = t(p["bias"]).reshape(-1)
    return sd


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_matches_optax(name):
    clip = 0.5          # between the second and the third step's norms
    ocfg = dict(name=name, d_model=128, warmup_steps=2,
                gradient_clip_val=clip)
    jparams = _jax_tree(1)
    tx = jax_build_optimizer(JC.OptimConfig(**ocfg), jparams)
    grads_all = [_jax_tree(10 + step, scale=3e-4 * (step + 1) ** 1.3)
                 for step in range(3)]

    @jax.jit           # one small program: eager optax compiles per op
    def three_steps(params, grads_all):
        opt_state = tx.init(params)
        for grads in grads_all:
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
        return params

    model = Port()
    model.load_state_dict(_state_dict(jparams), strict=True)
    teacher0 = {k: v.clone() for k, v in model.teacher.state_dict().items()}
    opt, schedule = build_optimizer(PC.OptimConfig(**ocfg), model)
    norms = []
    for step, grads in enumerate(grads_all):
        pgrads = _state_dict(grads)
        live = []
        for n, p in model.named_parameters():
            if not n.startswith("teacher."):
                p.grad = pgrads[n].clone()
                live.append(p.grad)
        norms.append(float(global_norm(live)))
        clip_by_global_norm(live, clip, global_norm(live))
        set_lr(opt, schedule(step))
        opt.step()
    assert norms[1] < clip < norms[2], norms
    want = _state_dict(jax.device_get(three_steps(jparams, grads_all)))
    for n, t in model.state_dict().items():
        if n.startswith("teacher."):
            assert torch.equal(t, teacher0[n[len("teacher."):]]), n
            np.testing.assert_array_equal(t.numpy(), want[n].numpy())
            continue
        w = want[n].numpy()
        np.testing.assert_allclose(t.numpy(), w, rtol=0,
                                   atol=1e-6 * np.abs(w).max(),
                                   err_msg=f"{name}: {n}")


def _configs(mod):
    enc = mod.EncoderConfig(feat_in=40, n_layers=2, d_model=256, n_heads=4,
                            conv_kernel_size=7)
    teacher = mod.ModelConfig(
        spec_augment=None, encoder=enc,
        preprocessor=mod.PreprocessorConfig(features=40),
        decoder=mod.DecoderConfig(feat_in=256, num_classes=16),
        compute_dtype="float32")
    student = mod.make_student_config(teacher)
    flow = mod.FlowMatchingConfig(
        meta_encoder_type="swin", student_dim=128, teacher_dim=256,
        student_head_num=2, teacher_head_num=4, time_embed_dim=8,
        hidden_dim=16, training_sampling=2, inference_sampling=2)
    distill = mod.DistillationConfig(use_logit_distillation=True,
                                     use_flow_matching=True, flow=flow)
    return teacher, student, distill


def test_leaves_group_the_layer_stacks():
    teacher, student, distill = _configs(JC)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(
        functools.partial(JaxDistil(student, teacher, distill).init,
                          train=True),
        {n: key for n in ("params", "specaug", "dropout", "gumbel",
                          "noise")},
        jnp.zeros((1, 1600)), jnp.full((1,), 1600, jnp.int32),
        jnp.zeros((1, 4), jnp.int32), jnp.full((1,), 4, jnp.int32))["params"]
    model = DistilCTCModel(*[c for c in (_configs(PC)[1], _configs(PC)[0],
                                         _configs(PC)[2])])
    named = [(n, p) for n, p in model.named_parameters()
             if not n.startswith("teacher.")]
    leaves = optax_leaves(model, named)
    trainable = {k: v for k, v in shapes.items() if k != "teacher"}
    want = sorted(int(np.prod(a.shape)) for a in jax.tree.leaves(trainable))
    assert sorted(sum(p.numel() for p in ps) for ps, _ in leaves) == want
    stacked = [ps for ps, _ in leaves if len(ps) > 1]
    assert stacked and all(len(ps) == 2 for ps in stacked)
    assert sum(v is not None for _, v in leaves) == 7   # q/k/v kernel, bias, out
