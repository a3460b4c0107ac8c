"""Pipeline parallelism of the port (parallel/pipeline.py) on the CPU: gloo
ranks started by tpu_asr_torch/parallel/launch.py (spawn: this process has
JAX loaded) run tests/torch_parallel_ranks.py while JAX's references compile
here. The size is tests/test_pipeline.py's KD model (teacher d 32 / 4 heads,
student d 16 / 2 heads, 2 layers (one a stage), layer-norm conv modules,
32 features,
16 classes; logit KD, layerwise KD and FM-KT with the mlp meta encoder at 2
steps), a batch of 4; weights come from JAX (jax.eval_shape of the init
filled from a seed) through convert/from_jax.py.

- ctc_forward_pipelined of the student CTCModel at (pp 2, n_micro 2) and
  (pp 2, n_micro 4) against JAX's ctc_forward_pipelined on its virtual
  mesh (pp 2, n_micro 2: JAX's own tests hold its result independent of
  n_micro): lengths equal, log-probs within 1e-5 (tests/test_pipeline.py's
  tolerance);
- the gradients of sum(encoded * r) through the pipelined encoder (pp 2,
  n_micro 2) against JAX's unpipelined ones: within 1e-4 x the tensor's
  max|ref| with a 2e-6 floor (tests/test_pipeline.py's rule);
- distil_forward_pipelined's losses at pp 2 against JAX's
  distil_forward_pipelined on its virtual mesh (2e-4, test_pipeline.py's);
- a dp1 x pp2 x tp2 KD step (4 ranks) against JAX's unsharded step (as
  tests/test_pipeline.py's three-axis test): every loss within 1e-4
  relative, every trained parameter's gradient within 1e-5 + 1e-4 x the
  tensor's max|ref|, equal losses on every rank; the same at dp2 x pp2
  (each data replica 2 rows: its losses summed over the data axis, and
  the gradients the pipelined backward summed over it, on both
  replicas);
- the guards raise JAX's messages, for the same configurations;
- with dropout 0.1 (and its generator), the port's pipelined step at pp 2
  equals its own unpipelined step: losses within 1e-5 relative, gradients
  within 1e-5 + 1e-4 x max|ref| (the stages draw the unpipelined masks).
"""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddp_cases as C
import torch_parallel_ranks as R
import tpu_asr.config as JC
import tpu_asr_torch.config as PC
from test_torch_kd_menu import random_tree
from tpu_asr.models.ctc_model import CTCModel as JaxCTC
from tpu_asr.models.distil_model import DistilCTCModel as JaxDistil
from tpu_asr.parallel import pipeline as jp
from tpu_asr_torch.convert.from_jax import (distil_to_state_dict,
                                            jax_to_state_dict)
from tpu_asr_torch.models.distil_model import DistilCTCModel
from tpu_asr_torch.parallel import pipeline as pp_port
from tpu_asr_torch.parallel.launch import launch
from tpu_asr_torch.train.trainer import step_rngs

B, SAMPLES = 4, 8000
T_OUT = 13                    # frames after the x4 subsampling of SAMPLES


def configs(mod, dropout=0.0):
    """(teacher, student, DistillationConfig) of test_pipeline.py's KD
    model."""
    enc = mod.EncoderConfig(feat_in=32, n_layers=2, d_model=32, n_heads=4,
                            conv_kernel_size=7, conv_norm_type="layer_norm",
                            attention_backend="xla", dropout=dropout,
                            dropout_pre_encoder=dropout,
                            dropout_att=dropout)
    teacher = mod.ModelConfig(
        preprocessor=mod.PreprocessorConfig(features=32, dither=0.0),
        spec_augment=None, encoder=enc,
        decoder=mod.DecoderConfig(feat_in=32, num_classes=16),
        compute_dtype="float32")
    student = mod.make_student_config(teacher)
    flow = mod.FlowMatchingConfig(
        meta_encoder_type="mlp", student_dim=16, teacher_dim=32,
        student_head_num=2, time_embed_dim=8, hidden_dim=16,
        training_sampling=2, inference_sampling=2)
    return teacher, student, mod.DistillationConfig(
        use_logit_distillation=True, use_layerwise_distillation=True,
        use_flow_matching=True, flow=flow)


def batch():
    rng = np.random.default_rng(0)
    return {"signal": (rng.normal(size=(B, SAMPLES)) * 0.1).astype(
        np.float32),
        "signal_len": np.array([8000, 6500, 5000, 4100], np.int32),
        "tokens": rng.integers(0, 16, size=(B, 6)).astype(np.int32),
        "token_len": np.array([6, 5, 4, 2], np.int32)}


@functools.lru_cache(maxsize=None)
def jax_weights():
    teacher, student, d = configs(JC)
    jb = {k: jnp.asarray(v) for k, v in batch().items()}
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(
        functools.partial(JaxDistil(student, teacher, d).init, train=True),
        {n: key for n in ("params", "specaug", "dropout", "gumbel",
                          "noise")}, jb["signal"], jb["signal_len"],
        jb["tokens"], jb["token_len"])
    return random_tree(shapes["params"], 1)


def jax_refs():
    """JAX's references, each compiled once without XLA's costly passes."""
    teacher, student, d = configs(JC)
    params = jax_weights()
    jb = {k: jnp.asarray(v) for k, v in batch().items()}
    key = jax.random.PRNGKey(1)
    rngs = {n: key for n in ("specaug", "dropout", "gumbel", "noise")}
    mesh = jp.make_pp_mesh(dp_size=1, pp_size=2,
                           devices=jax.devices("cpu")[:2])
    ctc = JaxCTC(student)
    model = JaxDistil(student, teacher, d)
    r = np.random.default_rng(5).normal(size=(B, T_OUT, 16)).astype(
        np.float32)

    def enc_obj(p):
        return jnp.sum(ctc.apply({"params": p}, jb["signal"],
                                 jb["signal_len"]).encoded * r)

    def loss_fn(p):
        o = model.apply({"params": {**p, "teacher": params["teacher"]}},
                        jb["signal"], jb["signal_len"], jb["tokens"],
                        jb["token_len"], train=True, rngs=rngs)
        return o.losses["total"], o.losses

    programs = {
        "ctc": (lambda v, s, l: jp.ctc_forward_pipelined(ctc, v, s, l, mesh,
                                                         2),
                {"params": params["student"]}, jb["signal"],
                jb["signal_len"]),
        "enc_grads": (jax.grad(enc_obj), params["student"]),
        "pp_losses": (lambda v: jp.distil_forward_pipelined(
            model, v, jb["signal"], jb["signal_len"], jb["tokens"],
            jb["token_len"], mesh, n_micro=2, rngs=rngs).losses,
            {"params": params}),
        "step": (jax.value_and_grad(loss_fn, has_aux=True),
                 {k: v for k, v in params.items() if k != "teacher"})}
    # traced one after another, compiled two at a time (XLA's compiler does
    # not hold the interpreter), each without XLA's costly passes
    lowered = {k: jax.jit(fn).lower(*a) for k, (fn, *a) in programs.items()}
    with ThreadPoolExecutor(2) as pool:
        done = {k: pool.submit(lo.compile, compiler_options=C.FAST_COMPILE)
                for k, lo in lowered.items()}
        out = {k: jax.tree.map(np.asarray, f.result()(*programs[k][1:]))
               for k, f in done.items()}
    (_, losses), grads = out.pop("step")
    out["losses"] = {k: float(v) for k, v in losses.items()}
    out["pp_losses"] = {k: float(v) for k, v in out["pp_losses"].items()}
    out["grads"], out["r"] = grads, r
    return out


def save_atomic(obj, path):
    torch.save(obj, str(path) + ".tmp")
    Path(str(path) + ".tmp").rename(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Three launches (2 ranks at pp 2: the CTC forwards and the encoder
    gradients; 2 ranks at pp 2: the KD forward at dropout 0 and at 0.1; 4
    ranks: the KD step at dp1 x pp2 x tp2 and at dp2 x pp2), started at
    once: the ranks
    wait for the weights, which are written here, then JAX's references
    compile here."""
    root = tmp_path_factory.mktemp("pp")
    teacher, student, d = configs(PC)
    t_d, s_d, d_d = configs(PC, dropout=0.1)
    sd, ctc_sd = root / "w.pt", root / "ctc.pt"
    b = batch()
    run = lambda jobs, n: launch(R.run_jobs, (jobs,), ["cpu"] * n,
                                 timeout=240, coll_timeout=120, threads=1)
    with ThreadPoolExecutor(3) as pool:
        f4 = pool.submit(run, [
            ("pp_distil", (student, teacher, d, str(sd), b, 1, 2, 2, 2)),
            ("pp_distil", (student, teacher, d, str(sd), b, 2, 2, 1, 2))], 4)
        r_cot = np.random.default_rng(5).normal(size=(B, T_OUT, 16)).astype(
            np.float32)
        f2 = pool.submit(run, [
            ("pp_ctc", (student, str(ctc_sd), b["signal"], b["signal_len"],
                        2, 2)),
            ("pp_ctc", (student, str(ctc_sd), b["signal"], b["signal_len"],
                        2, 4)),
            ("pp_encoder_grads", (student, str(ctc_sd), b["signal"],
                                  b["signal_len"], 2, 2, r_cot))], 2)
        f2b = pool.submit(run, [
            ("pp_distil", (student, teacher, d, str(sd), b, 1, 2, 1, 2)),
            ("pp_distil", (s_d, t_d, d_d, str(sd), b, 1, 2, 1, 2))], 2)
        params = jax_weights()
        full = distil_to_state_dict(params, {}, student, teacher)
        save_atomic(full, sd)
        save_atomic(jax_to_state_dict(params["student"], {}, student),
                    ctc_sd)
        want = jax_refs()
        # the port's own unpipelined step at dropout 0.1
        model = DistilCTCModel(s_d, t_d, d_d)
        model.load_state_dict(full, strict=True)
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        out = model.train()(tb["signal"], tb["signal_len"], tb["tokens"],
                            tb["token_len"], train=True,
                            rngs=step_rngs(0, 0, "cpu"))
        out.losses["total"].backward()
        one = ({k: v.item() for k, v in out.losses.items()},
               {k: p.grad.numpy().copy() for k, p in model.named_parameters()
                if p.grad is not None})
        got2 = [a + b for a, b in zip(f2.result(), f2b.result())]
        got4 = f4.result()
    np.testing.assert_array_equal(r_cot, want["r"])
    return {"want": want, "two": got2, "four": got4, "one": one,
            "student": student, "teacher": teacher}


@pytest.mark.parametrize("n_micro", [2, 4])
def test_ctc_forward_pipelined_matches_jax(runs, n_micro):
    lp, n = runs["two"][0][0 if n_micro == 2 else 1]
    want_lp, want_n = runs["want"]["ctc"]       # JAX's at n_micro 2
    np.testing.assert_array_equal(n, want_n)
    np.testing.assert_allclose(lp, want_lp, rtol=1e-5, atol=1e-5)
    lp1, _ = runs["two"][1][0 if n_micro == 2 else 1]
    np.testing.assert_array_equal(lp1, lp)          # every stage holds them


def test_encoder_gradients_match_jax_unpipelined(runs):
    got = runs["two"][0][2]
    student = runs["student"]
    want = jax_to_state_dict(runs["want"]["enc_grads"], {}, student)
    assert {k for k in got} == {k for k in want
                                if not k.startswith("decoder.")}
    for k, g in got.items():
        w = want[k].numpy()
        np.testing.assert_allclose(
            g, w, rtol=0, atol=max(1e-4 * np.abs(w).max(), 2e-6), err_msg=k)


def test_distil_forward_pipelined_losses_match_jax(runs):
    got = runs["two"][0][3]["losses"]
    want = runs["want"]["pp_losses"]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=2e-4, atol=2e-4,
                                   err_msg=k)


def test_dp1_pp2_tp2_step_matches_jax_unsharded(runs):
    check_step_against_jax(runs, 0)


def test_dp2_pp2_step_matches_jax_unsharded(runs):
    check_step_against_jax(runs, 1)
    # both data replicas hold the global batch's gradients
    norms = [r[1]["norm"] for r in runs["four"]]
    assert norms == [norms[0]] * 4


def check_step_against_jax(runs, job):
    """The 4-rank KD step of launch job `job` against JAX's unsharded
    step: losses equal on every rank and within 1e-4 relative of JAX's,
    rank 0's whole gradients within 1e-5 + 1e-4 x max|ref|."""
    ranks = [r[job] for r in runs["four"]]
    want = runs["want"]
    got = ranks[0]
    for r in ranks:
        assert r["losses"] == got["losses"]
    for k, v in want["losses"].items():
        np.testing.assert_allclose(got["losses"][k], v, rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    grads = {k: v for k, v in distil_to_state_dict(
        want["grads"], {}, runs["student"], runs["teacher"]).items()}
    assert set(got["grads"]) == set(grads)
    for k, g in got["grads"].items():
        w = grads[k].numpy()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 + 1e-4 * np.abs(w).max(),
                                   err_msg=k)


CASES = {
    "dropout_without_rng": (dict(dropout=0.1), True, False),
    "stochastic_depth": (dict(stochastic_depth_drop_prob=0.1), True, True),
    "batch_norm": (dict(conv_norm_type="batch_norm"), True, True),
    "reduction": (dict(reduction="pooling", reduction_factor=2), False,
                  False),
    "feat_out": (dict(feat_out=48), False, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_guards_raise_jax_messages(case):
    change, train, rng = CASES[case]
    messages = []
    for mod, check in ((JC, jp._check_cfg), (PC, pp_port._check_cfg)):
        cfg = dataclasses.replace(mod.EncoderConfig(), **change)
        with pytest.raises(ValueError) as err:
            check(cfg, train, have_rng=rng)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    # both pass the configuration without the change
    pp_port._check_cfg(PC.EncoderConfig(conv_norm_type="layer_norm"), True,
                       have_rng=True)


def test_pipelined_step_with_dropout_equals_unpipelined(runs):
    got = runs["two"][0][4]
    want_losses, want_grads = runs["one"]
    assert got["losses"]["total"] == runs["two"][1][4]["losses"]["total"]
    for k, v in want_losses.items():
        np.testing.assert_allclose(got["losses"][k], v, rtol=1e-5, err_msg=k)
    assert set(got["grads"]) == set(want_grads)
    for k, g in got["grads"].items():
        w = want_grads[k]
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 + 1e-4 * np.abs(w).max(),
                                   err_msg=k)
    # dropout acted: the step differs from the dropout-0 one
    assert got["losses"]["total"] != runs["two"][0][3]["losses"]["total"]
