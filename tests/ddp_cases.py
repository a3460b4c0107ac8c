"""The cases of tests/test_torch_ddp.py that both frameworks run, without
importing torch: the configurations (for tpu_asr.config or
tpu_asr_torch.config), the global batch, and JAX's loss and gradients of
one training forward, which tests/test_torch_ddp.py computes in spawned
processes of this module alone (side by side, while the port's ranks run).

The size: log-mel of 24 features, a teacher of d 32 (4 heads) and its
halved student (d 16, 2 heads), 2 layers, conv kernel 7 with BatchNorm, a
global batch of 4 rows (2 ranks of 2).
"""

import dataclasses

import numpy as np

ROWS = 4                                   # the global batch
K, MARGIN = 4, 60.0
# (layer, sample) router counts: rank 0's samples are the first two; each
# rank's lower median (1 and 3, then 3 and 1) differs from the global one
STEPS = np.array([[1, 2, 4, 3], [3, 4, 1, 2]])
CASES = {"ctc_mean_volume": dict(reduction="mean_volume"),
         "logit_fm": dict(fm=True), "router_median": dict(
             router="batch_median"), "router_group": dict(router="group")}


def configs(mod, dropout=0.0, spec=False, dither=0.0, reduction="mean_batch"):
    """(teacher, student) of the module `mod` (tpu_asr.config or
    tpu_asr_torch.config)."""
    enc = mod.EncoderConfig(feat_in=24, n_layers=2, d_model=32, n_heads=4,
                            conv_kernel_size=7, conv_norm_type="batch_norm",
                            dropout=dropout, dropout_pre_encoder=dropout,
                            dropout_att=dropout)
    teacher = mod.ModelConfig(
        preprocessor=mod.PreprocessorConfig(features=24, dither=dither),
        spec_augment=mod.SpecAugmentConfig() if spec else None, encoder=enc,
        decoder=mod.DecoderConfig(feat_in=32, num_classes=16),
        compute_dtype="float32", ctc_reduction=reduction)
    student = mod.make_student_config(teacher)
    return teacher, dataclasses.replace(student, ctc_reduction=reduction)


def distill(mod, fm=False, router=None):
    """DistillationConfig of a case: CTC alone, or logit KD + FM with the
    mlp meta encoder (3 steps, or routed with the strategy `router`)."""
    if not fm and router is None:
        return mod.DistillationConfig()
    flow = mod.FlowMatchingConfig(
        student_dim=16, teacher_dim=32, student_head_num=2,
        teacher_head_num=4, time_embed_dim=8, hidden_dim=16,
        training_sampling=3, inference_sampling=3, euler_backend="xla",
        use_dynamic_steps=router is not None,
        router_strategy=router or "batch_mode", router_max_sampling_steps=K)
    return mod.DistillationConfig(
        use_logit_distillation=True, kd_alpha=0.1, use_flow_matching=True,
        flow=flow, router=mod.RouterConfig(
            max_steps=K, stu_dim=16, tch_dim=32, hidden_dim=16, proj_dim=12,
            num_layers=2, layer_emb_dim=6, budget_target=2.0))


def case_configs(mod, name, **kw):
    """(teacher, student, DistillationConfig) of CASES[name]."""
    opts = dict(CASES[name])
    teacher, student = configs(mod, reduction=opts.pop("reduction",
                                                       "mean_batch"), **kw)
    return teacher, student, distill(mod, **opts)


def global_batch(seed=0):
    """4 rows whose halves differ: rank 0's two long, loud clips and long
    targets, rank 1's short ones, so the local BatchNorm statistics and
    target lengths are not the global ones."""
    rng = np.random.default_rng(seed)
    lens = np.array([16000, 15000, 7000, 4000], np.int32)
    sig = (rng.normal(size=(ROWS, 16000)) * 0.1).astype(np.float32)
    sig[:2] *= 3.0
    sig[np.arange(16000)[None, :] >= lens[:, None]] = 0.0
    return {"signal": sig, "signal_len": lens,
            "tokens": rng.integers(0, 16, size=(ROWS, 6)).astype(np.int32),
            "token_len": np.array([6, 5, 2, 1], np.int32)}


# XLA's CPU backend without its costly passes: these programs run once
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jax_loss_and_grads(name, params, stats):
    """JAX's losses and gradients (the teacher's none: JAX's trainer stops
    them at its parameters) of one training forward of CASES[name] at the
    global batch on one device, as floats and numpy arrays."""
    import jax
    import jax.numpy as jnp

    import tpu_asr.config as JC
    from tpu_asr.models.distil_model import DistilCTCModel

    jax.config.update("jax_platforms", "cpu")
    teacher, student, d = case_configs(JC, name)
    jmodel = DistilCTCModel(student, teacher, d)
    jb = {k: jnp.asarray(v) for k, v in global_batch().items()}
    key = jax.random.PRNGKey(1)
    rngs = {n: key for n in ("specaug", "dropout", "gumbel", "noise")}
    frozen = params.get("teacher")
    trained = {k: v for k, v in params.items() if k != "teacher"}

    def loss_fn(p):
        p = {**p, "teacher": frozen} if frozen is not None else p
        out, _ = jmodel.apply(
            {"params": p, "batch_stats": stats}, jb["signal"],
            jb["signal_len"], jb["tokens"], jb["token_len"], train=True,
            rngs=rngs, mutable=["batch_stats"])
        return out.losses["total"], out.losses

    fn = jax.value_and_grad(loss_fn, has_aux=True)
    (_, losses), grads = jax.jit(fn).lower(trained).compile(
        compiler_options=FAST_COMPILE)(trained)
    return ({k: float(v) for k, v in losses.items()},
            jax.tree.map(np.asarray, grads))
