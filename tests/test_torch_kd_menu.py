"""The rest of KD in the port against the JAX package on the CPU: the
whole KD train step (tpu_asr_torch's make_distil_train_step against
jax.value_and_grad of the JAX DistilCTCModel's loss, which is what JAX's
make_distil_train_step differentiates) with the dynamic step router, per-layer
step counts, layerwise KD, interCTC, DiffKD and every diffm version, a tiny
teacher (2 layers, d 64, 4 heads) and student (2 layers, d 32, 2 heads),
every dropout rate 0, no SpecAugment and no dither, weights carried by the
bridge (convert/from_jax.distil_to_state_dict), batch made with numpy from a
seed.

Each case pairs one diffm version with other options, so that 8 compiled
JAX programs cover all of them (this file runs v6, the others one each in
test_torch_router_{group,mode,avg,median}.py, test_torch_kd_per_layer.py,
test_torch_diffm.py and test_torch_kd_options.py):
  v1 + router 'group' + layerwise 'all'
  v2 + router 'batch_mode' + interCTC
  v3 + router 'batch_avg' + DiffKD
  v4 + router 'batch_median' + layerwise 'last'
  v5 + sampling_steps_per_layer + interCTC on both layers
  v6 + router 'group' + DiffKD + layerwise 'all' + interCTC
  v7 + layerwise 'last' + DiffKD
  v8 + sampling_steps_per_layer + layerwise 'all'
Checked: every loss component at 1e-5 relative, the metrics (the router's
mean step count, each interCTC loss) at 1e-5, every student and KD-module
gradient within 1e-5 + 1e-4 x its tensor's max|ref| (fp32 sums in another
order), grad_norm at 1e-5; the teacher bit-unchanged and without gradient.

Randomness the two frameworks cannot share is taken out of the result:
- router steps: router_fc2 is solved so that every (layer, sample) row's
  logits put one chosen step count 60 above the rest (the test asserts a
  margin above 21 on every row; fp32 Gumbel noise lies in [-3.83, 16.64],
  so no draw can move the argmax), with the counts [[1, 2], [4, 3]]: four
  distinct counts for the group loss, a tie for batch_mode (smallest wins),
  means 1.5 and 3.5 for batch_avg (half to even: 2 and 4), even batches for
  batch_median (lower middle: 1 and 3);
- diffm ver 3-8: adapter.g2's bias is +40, so gamma = sigmoid(...) is 1.0
  in fp32 on every frame (asserted on the frames of the step) and
  z_noisy = z whatever the noise.
Also: layerwise KD with diffm's fresh projection, whose loss is held to
JAX's layerwise_mse_loss on the port's drawn weights and whose weights lie
within their bounds.
"""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import tpu_asr.config as JC
import tpu_asr_torch.config as PC
from tests.test_torch_train import _batch, _configs, _torch_batch
from tpu_asr.kd import losses as jax_losses
from tpu_asr.models.distil_model import DistilCTCModel as JaxDistil
from tpu_asr_torch.convert.from_jax import KD_MODULES, distil_to_state_dict
from tpu_asr_torch.kd.diffm import NoiseAdapter
from tpu_asr_torch.models.distil_model import (DistilCTCModel,
                                               fresh_layer_proj)
from tpu_asr_torch.train.trainer import (DistilTrainState,
                                         make_distil_train_step, step_rngs)

K, MARGIN = 4, 60.0
STEPS = np.array([[1, 2], [4, 3]])           # (layer, sample) router counts


def distill(mod, version=6, router=None, per_layer=None, backend="xla",
            meta="mlp", **kw):
    """DistillationConfig at the tiny widths: logit KD, FM-KT (3 steps,
    or `per_layer`, or the router with strategy `router`) and diffm ver
    `version`, plus the options in kw."""
    flow = mod.FlowMatchingConfig(
        meta_encoder_type=meta, student_dim=32, teacher_dim=64,
        student_head_num=2, teacher_head_num=4, time_embed_dim=8,
        hidden_dim=16, training_sampling=3, inference_sampling=3,
        euler_backend=backend, sampling_steps_per_layer=per_layer,
        use_dynamic_steps=router is not None,
        router_strategy=router or "batch_mode", router_max_sampling_steps=K)
    return mod.DistillationConfig(
        use_logit_distillation=True, kd_alpha=0.1, use_flow_matching=True,
        flow=flow,
        router=mod.RouterConfig(max_steps=K, stu_dim=32, tch_dim=64,
                                hidden_dim=16, proj_dim=12, num_layers=2,
                                layer_emb_dim=6, budget_target=2.0),
        diffkd=mod.DiffKDConfig(steps=3, teacher_dim=64, student_dim=32,
                                latent_dim=16),
        use_diffm=version is not None,
        diffm=mod.DiffmConfig(model_version=version or 1, latent_dim=16,
                              student_dim=32, teacher_dim=64,
                              fm=dataclasses.replace(
                                  flow, meta_encoder_type="mlp",
                                  hidden_dim=12)),
        **kw)


FULL = dict(version=6, router="group", use_layerwise_distillation=True,
            use_diffkd=True, interctc_layers=(1,))


def random_tree(shapes, seed):
    """numpy leaves for a tree of shapes: norm scales and BatchNorm
    variances near 1, biases and means small, kernels scaled by fan-in."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        n = rng.normal(size=a.shape).astype(np.float32)
        if name in ("scale", "var"):
            return 1.0 + 0.1 * np.abs(n) * (1 if name == "var" else np.sign(n))
        if name == "kernel":
            return n / np.sqrt(np.prod(a.shape[:-1]))
        return 0.1 * n if name != "embedding" else n

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def superset(meta="mlp"):
    """(JAX params, batch_stats) of a model holding every KD module
    (diffm ver 6 holds every diffm submodule): the shapes of its init
    (traced, not run) filled from a seed."""
    teacher, student = _configs(JC)
    model = JaxDistil(student, teacher, distill(JC, meta=meta, **FULL))
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(
        functools.partial(model.init, train=True),
        {n: key for n in ("params", "specaug", "dropout", "gumbel",
                          "noise")}, jb["signal"], jb["signal_len"],
        jb["tokens"], jb["token_len"])
    return (random_tree(shapes["params"], 1),
            random_tree(shapes.get("batch_stats", {}), 2))


def subset(params, model):
    """The JAX params of the KD modules the port `model` holds."""
    out = {k: params[k] for k in ("student", "teacher")}
    for name in KD_MODULES:
        if hasattr(model, name):
            out[name] = params[name]
    if "diffm_pipeline" in out:
        kids = dict(model.diffm_pipeline.named_children())
        out["diffm_pipeline"] = {k: v for k, v in
                                 out["diffm_pipeline"].items() if k in kids}
    return out


def port_model(params, stats, cfg):
    teacher, student = _configs(PC)
    model = DistilCTCModel(student, teacher, cfg)
    params = subset(params, model)
    model.load_state_dict(distil_to_state_dict(params, stats, student,
                                               teacher), strict=True)
    return model, params


def port_features(model, tb):
    """(L, B, T', D) student (training forward) and teacher features; the
    model's state is left as it was."""
    keep = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        model.train()
        _, _, stu = model.student.encode(tb["signal"], tb["signal_len"],
                                         True, step_rngs(0, 0, "cpu"))
        _, _, tch = model.teacher.encode(tb["signal"], tb["signal_len"])
    model.load_state_dict(keep)
    return stu, tch


def set_router_margin(params, stats, model, tb):
    """Solve router_fc2 so that row (l, b)'s logits put STEPS[l, b] MARGIN
    above every other count; returns the updated JAX params after asserting
    a margin above 21 on every row of the port's logits."""
    stu, tch = port_features(model, tb)
    ids = torch.arange(stu.shape[0])
    with torch.no_grad():
        h = model.router.hidden(stu, tch, ids).reshape(-1, 16).double()
    h_aug = torch.cat([h, torch.ones(h.shape[0], 1, dtype=h.dtype)], 1)
    target = torch.zeros(h.shape[0], K, dtype=h.dtype)
    target[torch.arange(h.shape[0]), torch.from_numpy(STEPS).reshape(-1)
           - 1] = MARGIN
    w = torch.linalg.pinv(h_aug) @ target
    params = {**params, "router": {**params["router"], "router_fc2": {
        "kernel": w[:-1].float().numpy(), "bias": w[-1].float().numpy()}}}
    model.load_state_dict(distil_to_state_dict(
        params, stats, model.student_cfg, model.teacher_cfg), strict=True)
    with torch.no_grad():
        top2 = model.router.logits(stu, tch, ids).topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).min().item()
    assert margin > 21.0, margin
    return params


def set_gamma_one(params):
    adapter = params["diffm_pipeline"]["adapter"]
    g2 = {**adapter["g2"], "bias": np.full_like(adapter["g2"]["bias"], 40.0)}
    return {**params, "diffm_pipeline": {**params["diffm_pipeline"],
                                         "adapter": {**adapter, "g2": g2}}}


# XLA's CPU backend without its costly passes: these programs run once
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def run_once(fn, *args):
    """fn(*args) as one XLA program compiled with FAST_COMPILE."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args)


def jax_loss_and_grads(cfg, params, stats):
    """JAX's losses, metrics and gradients (the teacher's none: JAX's
    trainer stops them at its parameters) of one training forward."""
    teacher, student = _configs(JC)
    jmodel = JaxDistil(student, teacher, cfg)
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    key = jax.random.PRNGKey(1)
    rngs = {n: key for n in ("specaug", "dropout", "gumbel", "noise")}
    frozen = params["teacher"]
    trained = {k: v for k, v in params.items() if k != "teacher"}

    def loss_fn(p):
        out, _ = jmodel.apply(
            {"params": {**p, "teacher": frozen}, "batch_stats": stats},
            jb["signal"], jb["signal_len"], jb["tokens"], jb["token_len"],
            train=True, rngs=rngs, mutable=["batch_stats"])
        return out.losses["total"], (out.losses, out.metrics)

    (_, (losses, metrics)), grads = run_once(jax.value_and_grad(
        loss_fn, has_aux=True), trained)
    return losses, metrics, grads


def check_step(opts, monkeypatch, meta="mlp"):
    """One port train step of the case `opts` against JAX (see the module
    note)."""
    full, stats = superset(meta)
    cfg_p, cfg_j = distill(PC, meta=meta, **opts), distill(JC, meta=meta,
                                                           **opts)
    model, params = port_model(full, stats, cfg_p)
    tb = _torch_batch(_batch())
    if cfg_p.flow.use_dynamic_steps:
        params = set_router_margin(params, stats, model, tb)
    gammas = []
    if "adapter" in params.get("diffm_pipeline", {}):
        params = set_gamma_one(params)
        gamma = NoiseAdapter.gamma
        monkeypatch.setattr(NoiseAdapter, "gamma", lambda self, z: gammas.
                            append(gamma(self, z)) or gammas[-1])
    model.load_state_dict(distil_to_state_dict(
        params, stats, model.student_cfg, model.teacher_cfg), strict=True)
    want_losses, want_metrics, want_grads = jax_loss_and_grads(
        cfg_j, params, stats)

    teacher0 = {k: v.clone() for k, v in model.state_dict().items()
                if k.startswith("teacher.")}
    state = DistilTrainState.create(model, PC.OptimConfig(d_model=32,
                                                          warmup_steps=10))
    state, metrics = make_distil_train_step(model)(state, tb, 0)
    if gammas:
        assert all(bool((g == 1.0).all()) for g in gammas)
    assert set(want_losses) == {k[5:] for k in metrics
                                if k.startswith("loss/")}
    for name, want in want_losses.items():
        np.testing.assert_allclose(metrics[f"loss/{name}"].item(),
                                   float(want), rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    assert set(want_metrics) == {k for k in metrics if "/" in k
                                 and not k.startswith("loss/")}
    for name, want in want_metrics.items():
        np.testing.assert_allclose(metrics[name].item(), float(want),
                                   rtol=1e-5, err_msg=name)
    grads = distil_to_state_dict(want_grads, stats, model.student_cfg)
    norm = np.sqrt(sum(float(jnp.sum(jnp.square(g)))
                       for g in jax.tree.leaves(want_grads)))
    np.testing.assert_allclose(metrics["grad_norm"].item(), norm, rtol=1e-5)
    for name, p in model.named_parameters():
        if name.startswith("teacher."):
            assert p.grad is None and not p.requires_grad, name
            assert torch.equal(p.detach(), teacher0[name]), name
            continue
        w = grads[name].numpy()
        if p.grad is None:        # detached in both (DiffKD's encoder)
            assert not w.any(), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-5 + 1e-4 * np.abs(w).max(),
                                   err_msg=name)
    return metrics


CASES = {
    "v1_group_layerwise_all": dict(version=1, router="group",
                                   use_layerwise_distillation=True),
    "v2_batch_mode_interctc": dict(version=2, router="batch_mode",
                                   interctc_layers=(0,)),
    "v3_batch_avg_diffkd": dict(version=3, router="batch_avg",
                                use_diffkd=True),
    "v4_batch_median_layerwise_last": dict(
        version=4, router="batch_median", use_layerwise_distillation=True,
        layer_kd_scope="last"),
    "v5_per_layer_interctc": dict(version=5, per_layer=(2, 3),
                                  interctc_layers=(0, 1)),
    "v6_group_diffkd_layerwise_interctc": FULL,
    "v7_layerwise_last_diffkd": dict(version=7, use_diffkd=True,
                                     use_layerwise_distillation=True,
                                     layer_kd_scope="last"),
    "v8_per_layer_layerwise_all": dict(version=8, per_layer=(3, 1),
                                       use_layerwise_distillation=True),
}


def run_case(case, monkeypatch):
    """check_step for CASES[case]; the router's mean step count is STEPS'
    mean."""
    metrics = check_step(CASES[case], monkeypatch)
    if "router" in CASES[case]:
        assert metrics["router/batch_mean_sampling_steps_mean"].item() == \
            STEPS.mean()


# one case a file (a JAX step compiles in 5-10 s on the CPU): the others
# run in test_torch_router_{group,mode,avg,median}.py,
# test_torch_kd_per_layer.py, test_torch_diffm.py and test_torch_kd_options.py
def test_kd_step_matches_jax(monkeypatch):
    run_case("v6_group_diffkd_layerwise_interctc", monkeypatch)


def test_fresh_layer_projection_matches_jax_loss():
    full, stats = superset()
    cfg = distill(PC, version=None, use_layerwise_distillation=True,
                  diffm_fresh_layer_proj=True, layer_kd_alpha=0.7)
    model, _ = port_model(full, stats, cfg)
    assert not hasattr(model, "layer_proj")
    tb = _torch_batch(_batch())
    stu, tch = port_features(model, tb)
    out = model(tb["signal"], tb["signal_len"], tb["tokens"],
                tb["token_len"], train=True, rngs=step_rngs(3, 0, "cpu"))
    w, b = fresh_layer_proj(step_rngs(3, 0, "cpu")["noise"], 2, 32, 64,
                            torch.float32, "cpu")
    bound = 1 / 32 ** 0.5
    assert w.abs().max() <= bound and b.abs().max() <= bound
    assert w.abs().max() > 0.9 * bound and w.std() > 0.5 * bound
    proj = np.einsum("lbts,lsd->lbtd", stu.numpy(), w.numpy()) + b.numpy()
    want = 0.7 * float(jax_losses.layerwise_mse_loss(jnp.asarray(proj),
                                                     jnp.asarray(tch.numpy())))
    np.testing.assert_allclose(out.losses["layer_kd"].item(), want,
                               rtol=1e-5)
