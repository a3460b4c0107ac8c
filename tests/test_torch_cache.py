"""The teacher feature caches of the port against the JAX package on the CPU
(tpu_asr_torch/models/distil_model.py `tch_last_feat` / `tch_all_feat`,
train/trainer.py's harvest and cached steps, train/loop.py's
TeacherFeatureCache), at the size of tests/test_torch_kd_menu.py: a
teacher of 2 layers, d 64, 4 heads, a student of d 32, every dropout rate
0, no SpecAugment and no dither, JAX's parameters drawn from a seed
(test_torch_kd_menu.random_tree) and carried by the bridge.

- harvest: the port's harvest step returns the teacher's last layer and
  every layer, equal to JAX's teacher encode (what JAX's harvest step
  returns) at 1e-4 in fp32, and the encoded lengths;
- cached against harvest: from one state and one batch, the cached step
  fed the harvested features equals the harvest step (every loss,
  grad_norm and every parameter after the update at 1e-6 relative, as
  JAX's tests/test_teacher_cache.py holds JAX's), and JAX's cached loss
  on the same features (jax.value_and_grad of its model with
  tch_last_feat / tch_all_feat, what JAX's cached step differentiates):
  every loss at 1e-5 relative, every gradient within 1e-5 + 1e-4 x its
  tensor's max|ref|, grad_norm at 1e-5. Two cases, one JAX program each
  (the cached loss and gradients beside the teacher's encode):
  logit KD + last-scope layerwise KD on the last-layer cache, and FM-KT
  (mlp, 8 Euler steps) + logit KD + DiffKD + diffm ver 3 on the all-layer
  cache (diffm's noise taken out as in test_torch_kd_menu.py: gamma = 1),
  the second in tests/test_torch_cache_all.py;
- the store: bfloat16 above fp16's 65504 round-trips bit-exact in RAM and
  through the directory (uint16 .npy bits), fp32 too, padded frames 0;
- the refusals of JAX's tests/test_teacher_cache.py:205 and :282: the
  last-layer cache with flow matching, and a cache with
  steps_per_dispatch > 1.
(A 2-epoch Trainer.fit with each cache against the fit without is in
tests/test_torch_multi_step.py.)
"""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_asr.config as JC
import tpu_asr_torch.config as PC
from tests.test_torch_kd_menu import (distill, port_model, random_tree,
                                      run_once, set_gamma_one)
from tests.test_torch_train import _batch, _configs, _torch_batch
from tpu_asr.models.distil_model import DistilCTCModel as JaxDistil
from tpu_asr_torch.convert.from_jax import distil_to_state_dict
from tpu_asr_torch.train.loop import TeacherFeatureCache, Trainer
from tpu_asr_torch.train.trainer import (DistilTrainState,
                                         make_distil_train_step)

OPTIM = dict(d_model=32, warmup_steps=10)


def case_config(mod, case):
    """'last': logit KD + last-scope layerwise KD; 'all': FM-KT (mlp, 8
    steps) + logit KD + DiffKD + diffm ver 3."""
    if case == "last":
        return dataclasses.replace(
            distill(mod, version=None), use_flow_matching=False,
            use_layerwise_distillation=True, layer_kd_scope="last",
            layer_kd_alpha=0.2)
    d = distill(mod, version=3, use_diffkd=True)
    return dataclasses.replace(d, flow=dataclasses.replace(
        d.flow, training_sampling=8, inference_sampling=8))


@functools.lru_cache(maxsize=None)
def union():
    """(JAX params, batch_stats) of a model holding both cases' modules:
    the shapes of its init (traced, not run) filled from a seed
    (test_torch_kd_menu.random_tree)."""
    teacher, student = _configs(JC)
    cfg = dataclasses.replace(case_config(JC, "all"),
                              use_layerwise_distillation=True,
                              layer_kd_scope="last")
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(
        functools.partial(JaxDistil(student, teacher, cfg).init, train=True),
        {n: key for n in ("params", "specaug", "dropout", "gumbel",
                          "noise")}, jb["signal"], jb["signal_len"],
        jb["tokens"], jb["token_len"])
    return (random_tree(shapes["params"], 1),
            random_tree(shapes.get("batch_stats", {}), 2))


@functools.lru_cache(maxsize=None)
def setup(case):
    """(JAX params of the case's modules, batch_stats, port configuration)
    with diffm's gamma pinned to 1."""
    full, stats = union()
    cfg = case_config(PC, case)
    _, params = port_model(full, stats, cfg)
    if "diffm_pipeline" in params:
        params = set_gamma_one(params)
    return params, stats, cfg


def fresh(case):
    """A port model of the case with its weights, and a fresh state."""
    params, stats, cfg = setup(case)
    teacher, student = _configs(PC)
    from tpu_asr_torch.models.distil_model import DistilCTCModel
    model = DistilCTCModel(student, teacher, cfg)
    model.load_state_dict(distil_to_state_dict(params, stats, student,
                                               teacher), strict=True)
    return model, DistilTrainState.create(model, PC.OptimConfig(**OPTIM))


@functools.lru_cache(maxsize=None)
def harvest_and_jax(case):
    """The port's harvest step from a fresh state (metrics, gradients,
    parameters after it, (tch_last, tch_feats, encoded_len)), and JAX's
    losses and student gradients with those features cached (B, T', Dt)
    tch_last_feat for 'last', (L, B, T', Dt) tch_all_feat for 'all') beside
    JAX's teacher encode of the batch, in one program."""
    model, state = fresh(case)
    harvest = run(make_distil_train_step(
        model, harvest_teacher=True, harvest_all=case == "all"), model,
        state, _torch_batch(_batch()))
    last, feats, _ = harvest[3]
    params, stats, _ = setup(case)
    teacher, student = _configs(JC)
    jm = JaxDistil(student, teacher, case_config(JC, case))
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    key = jax.random.PRNGKey(1)
    rngs = {n: key for n in ("specaug", "dropout", "gumbel", "noise")}
    frozen = params["teacher"]
    trained = {k: v for k, v in params.items() if k != "teacher"}
    kw = "tch_last_feat" if case == "last" else "tch_all_feat"
    variables = lambda p: {"params": {**p, "teacher": frozen},
                           "batch_stats": stats}

    def loss_fn(p, f):
        out, _ = jm.apply(
            variables(p), jb["signal"], jb["signal_len"], jb["tokens"],
            jb["token_len"], train=True, rngs=rngs, mutable=["batch_stats"],
            **{kw: f})
        return out.losses["total"], out.losses

    def program(p, f):
        encoded = jm.apply(variables(p), jb["signal"], jb["signal_len"],
                           method=lambda m, s, l: m.teacher.encode(
                               s, l, train=False))
        return jax.value_and_grad(loss_fn, has_aux=True)(p, f), encoded

    ((_, losses), grads), encoded = run_once(
        program, trained, jnp.asarray((last if case == "last"
                                       else feats).numpy()))
    return harvest, losses, grads, jax.tree.map(np.asarray, encoded)


def run(step, model, state, batch):
    """One step; (metrics, gradients, parameters after it, extra outputs)
    as numpy."""
    out = step(state, batch, 0)
    metrics = {k: v.numpy() for k, v in out[1].items()}
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()
             if p.grad is not None}
    params = {n: p.detach().numpy().copy()
              for n, p in model.named_parameters()}
    return metrics, grads, params, out[2] if len(out) > 2 else None


def check_harvest(case):
    (_, _, _, (last, feats, enc_len)), _, _, jax_out = harvest_and_jax(case)
    _, want_len, want_feats = jax_out
    assert want_feats.shape == (2, 2, 26, 64)
    if case == "all":
        np.testing.assert_allclose(feats.numpy(), want_feats, rtol=1e-4,
                                   atol=1e-4)
    else:
        assert feats is None
    np.testing.assert_allclose(last.numpy(), want_feats[-1], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(enc_len.numpy(), want_len)


def check_cached_step(case):
    (m_h, g_h, p_h, (last, feats, _)), want_losses, want_grads, _ = \
        harvest_and_jax(case)
    model, state = fresh(case)
    key, cached = (("tch_last_feat", last) if case == "last" else
                   ("tch_all_feat", feats.transpose(0, 1)))
    m_c, g_c, p_c, _ = run(make_distil_train_step(
        model, cached_teacher=case == "last",
        cached_all_layers=case == "all"), model, state,
        {**_torch_batch(_batch()), key: cached})
    assert set(m_h) == set(m_c)
    for k in m_h:
        np.testing.assert_allclose(m_c[k], m_h[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    for n in p_h:
        np.testing.assert_allclose(p_c[n], p_h[n], rtol=1e-6, atol=1e-7,
                                   err_msg=n)

    assert set(want_losses) == {k[5:] for k in m_c if k.startswith("loss/")}
    for name, want in want_losses.items():
        np.testing.assert_allclose(m_c[f"loss/{name}"], float(want),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    _, stats, _ = setup(case)
    grads = distil_to_state_dict(want_grads, stats, model.student_cfg)
    norm = np.sqrt(sum(float(np.square(np.asarray(g, np.float64)).sum())
                       for g in jax.tree.leaves(want_grads)))
    np.testing.assert_allclose(m_c["grad_norm"], norm, rtol=1e-5)
    assert not any(n.startswith("teacher.") for n in g_c)
    for n, g in g_c.items():
        w = grads[n].numpy()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 + 1e-4 * np.abs(w).max(),
                                   err_msg=n)


# one JAX program a file (each compiles in 6-8 s on the CPU): the
# all-layer case is tests/test_torch_cache_all.py
def test_harvest_matches_jax_teacher():
    check_harvest("last")


def test_cached_step_matches_harvest_and_jax():
    check_cached_step("last")


@pytest.mark.parametrize("spill", [False, True])
def test_store_round_trips_bf16_above_fp16_range(tmp_path, spill):
    """bfloat16 bits (values up to 3.7e6, past fp16's 65504) and fp32 come
    back bit-exact, in RAM and through the directory; frames past an
    utterance are 0."""
    spill_dir = str(tmp_path / "spill") if spill else None
    feats = (torch.arange(2 * 3 * 4 * 2, dtype=torch.float32)
             .reshape(2, 3, 4, 2) * 1e5 + 1e5)               # (L, B, T, D)
    cache = TeacherFeatureCache(torch.bfloat16, all_layers=True,
                                spill_dir=spill_dir)
    cache.put_batch([10, 11, 12], feats, lengths=[4, 3, 4], l_pad=8000)
    assert cache.has_all([10, 12]) and not cache.has_all([10, 13])
    assert cache.tprime == {8000: 4}
    out = cache.assemble([11, 10], t_prime=5, d_t=2)        # (B, L, T, D)
    bf = feats.to(torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 2, 5, 2)
    assert torch.equal(out[1, :, :4], bf[:, 0])
    assert torch.equal(out[0, :, :3], bf[:, 1, :3])
    assert (out[0, :, 3:] == 0).all() and (out[1, :, 4] == 0).all()
    assert float(out.float().max()) > 65504.0
    if spill:
        on_disk = np.load(tmp_path / "spill" / "11.npy")
        assert on_disk.dtype == np.uint16 and on_disk.shape == (2, 3, 2)
        assert cache.fresh == {10, 11, 12} and not cache.data
    last = TeacherFeatureCache(torch.float32, spill_dir=spill_dir)
    last.put_batch([7], feats[0, :1] / 3, lengths=[2], l_pad=100)
    got = last.assemble([7], t_prime=4, d_t=2)
    assert got.dtype == torch.float32
    assert torch.equal(got[0, :2], feats[0, 0, :2] / 3)
    assert (got[0, 2:] == 0).all()


def test_refusals_match_jax(tmp_path):
    """The last-layer features with flow matching raise (JAX's
    test_cached_step_rejects_fm); the Trainer refuses cache_teacher with
    flow matching and a cache with steps_per_dispatch > 1 (JAX's
    test_trainer_rejects_cache_with_fm_or_spd)."""
    model, state = fresh("all")
    step = make_distil_train_step(model, cached_teacher=True)
    tb = _torch_batch(_batch())
    with pytest.raises(ValueError, match="tch_last_feat"):
        step(state, {**tb, "tch_last_feat": torch.zeros(2, 26, 64)}, 0)
    teacher, student = _configs(PC)
    cfg = PC.TrainConfig(model=student, distillation=model.distill,
                         optim=PC.OptimConfig(d_model=32),
                         cache_teacher=True, dp_size=1)
    with pytest.raises(ValueError, match="use cache_teacher_all"):
        Trainer(model, cfg, None, tmp_path / "a", device="cpu")
    lk, _ = fresh("last")
    for change in (dict(cache_teacher=True), dict(cache_teacher=False,
                                                  cache_teacher_all=True)):
        with pytest.raises(ValueError, match="steps_per_dispatch"):
            Trainer(lk, dataclasses.replace(
                cfg, distillation=lk.distill, steps_per_dispatch=2,
                **change), None, tmp_path / "b", device="cpu")
    assert Trainer(model, dataclasses.replace(
        cfg, cache_teacher=False, cache_teacher_all=True), None,
        tmp_path / "c", device="cpu")._cache.all_layers
