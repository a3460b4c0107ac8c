"""Tensor parallelism of the port (parallel/mesh.py, parallel/sharding.py,
the TP paths of models/conformer.py and models/decoder.py, the Trainer at
tp_size > 1) on the CPU: gloo ranks started by
tpu_asr_torch/parallel/launch.py (spawn: this process has JAX loaded) run
tests/torch_parallel_ranks.py, while JAX's references compile here. The
size is tests/ddp_cases.py's (24 features, teacher d 32 / 4 heads, student
d 16 / 2 heads, 2 layers, conv kernel 7 with BatchNorm, a global batch of 4
whose halves differ), with logit KD (alpha 0.1), every dropout rate 0;
weights come from JAX (jax.eval_shape of the init filled from a seed)
through convert/from_jax.py.

- the port's TP_RULES pick JAX's leaves: every port parameter is split,
  along the dim that carries JAX's 'model' axis, exactly where JAX's
  `_spec_for` shards the leaf it comes from, at tp 2 and 4, with 128
  classes + blank (129: the decoder replicated) and with 127 + blank
  (128: split);
- two logit-KD steps at dp1 x tp2 (2 ranks) and dp2 x tp2 (4 ranks)
  against JAX's one-device make_distil_train_step on the same batch (as
  tests/test_sharding.py holds JAX's own TP step to its replicated one):
  losses within 1e-4 relative (that test's tolerance) and the parameters
  after each step by tests/test_torch_train.py's fp32 rule (elements whose
  gradient exceeds 1e-4 x the largest, within 1e-5 x |ref| + 5e-3 x the
  learning rate; BatchNorm's mean also within 0.1 x the depthwise bias's
  difference the step before, a gradient that is rounding noise); the
  first step's gradients within 1e-5 + 1e-4 x the tensor's max|ref| of the
  one-rank port step's (which tests/test_torch_train.py holds to JAX's);
  each rank runs half of each attention's heads;
- the attention's dropout streams at tp 2 equal tp 1's: the two ranks'
  partial sums of the plain sublayer (relpos_attention_plain with
  `heads`) add up to the whole sublayer at dropout 0.1 (1e-6);
- checkpoints: a one-rank checkpoint restored at tp 2 gives the same
  parameters and Adam moments (exactly), and the tp 2 ranks' checkpoint
  restored at one rank gives their parameters (exactly);
- the Trainer at tp_size=2 on two ranks: each logged step's losses and
  grad_norm within 1e-5 of the one-rank fit's (tests/test_torch_ddp.py's
  fit setup, 6 clips and global batches of 4, written here so that the
  file does not import its modules).
"""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import dataclasses
import functools
import json
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
from tpu_asr.models.distil_model import DistilCTCModel as JaxDistil
from tpu_asr.parallel.sharding import _path_names, _spec_for
from tpu_asr.train.optim import build_optimizer as jax_build_optimizer
from tpu_asr.train.trainer import DistilTrainState as JaxState
from tpu_asr.train.trainer import make_distil_train_step as jax_make_step
from tpu_asr_torch.convert.from_jax import distil_to_state_dict
from tpu_asr_torch.data.audio import write_wav
from tpu_asr_torch.data.manifest import ManifestEntry, write_manifest
from tpu_asr_torch.data.tokenizer import train_bpe
from tpu_asr_torch.models.distil_model import DistilCTCModel
from tpu_asr_torch.ops.cuda_attention import relpos_attention_plain
from tpu_asr_torch.ops.positions import rel_positional_encoding
from tpu_asr_torch.parallel.launch import launch
from tpu_asr_torch.parallel.sharding import split_dim
from tpu_asr_torch.train.loop import Trainer
from tpu_asr_torch.train.trainer import (DistilTrainState,
                                         make_distil_train_step)
from tpu_asr_torch.utils.checkpoint import (restore_train_state,
                                            save_train_state)

STEPS = 2


def configs(mod, num_classes=16):
    teacher, student = C.configs(mod)
    if num_classes != 16:
        dec = lambda cfg: dataclasses.replace(cfg, decoder=dataclasses.replace(
            cfg.decoder, num_classes=num_classes))
        teacher, student = dec(teacher), dec(student)
    return teacher, student, mod.DistillationConfig(
        use_logit_distillation=True, kd_alpha=0.1)


@functools.lru_cache(maxsize=None)
def jax_weights(num_classes=16):
    """(params, batch_stats) of the JAX model: its init traced, not run,
    filled from a seed; another vocab swaps the decoders' leaves for
    leaves of its width."""
    if num_classes != 16:
        params, stats = jax_weights()
        rng = np.random.default_rng(num_classes)
        params = jax.tree.map(lambda a: a, params)          # a copy
        for who in ("student", "teacher"):
            dec = params[who]["decoder"]["decoder_layers_0"]
            dec["kernel"] = rng.normal(size=dec["kernel"].shape[:-1] + (
                num_classes + 1,)).astype(np.float32)
            dec["bias"] = np.zeros(num_classes + 1, np.float32)
        return params, stats
    teacher, student, d = configs(JC)
    jb = {k: jnp.asarray(v) for k, v in C.global_batch().items()}
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(
        functools.partial(JaxDistil(student, teacher, d).init, train=True),
        {n: key for n in ("params", "specaug", "dropout")}, jb["signal"],
        jb["signal_len"], jb["tokens"], jb["token_len"])
    return (random_tree(shapes["params"], 1),
            random_tree(shapes.get("batch_stats", {}), 2))


def jax_steps():
    """JAX's losses and (params, batch_stats) after each of STEPS
    one-device train steps (numpy)."""
    teacher, student, d = configs(JC)
    params, stats = jax_weights()
    model = JaxDistil(student, teacher, d)
    jb = {k: jnp.asarray(v) for k, v in C.global_batch().items()}
    key = jax.random.PRNGKey(1)
    state = JaxState.create(
        apply_fn=model.apply, params=params, batch_stats=stats,
        tx=jax_build_optimizer(JC.OptimConfig(d_model=16, warmup_steps=10),
                               params))
    step = jax.jit(jax_make_step(model)).lower(state, jb, key).compile(
        compiler_options=C.FAST_COMPILE)
    losses, states = [], []
    for _ in range(STEPS):
        state, metrics = step(state, jb, key)
        losses.append(float(metrics["loss/total"]))
        states.append((jax.tree.map(np.asarray, state.params),
                       jax.tree.map(np.asarray, state.batch_stats)))
    return losses, states


def port_state_dict(num_classes=16):
    teacher, student, _ = configs(PC, num_classes)
    params, stats = jax_weights(num_classes)
    return distil_to_state_dict(params, stats, student, teacher)


def one_rank_checkpoint(root):
    """A one-rank state after one step, saved to root/one/last; its model
    state_dict, optimizer moments and gradients (tests/test_torch_train.py
    holds this step to JAX's)."""
    teacher, student, d = configs(PC)
    model = DistilCTCModel(student, teacher, d)
    model.load_state_dict(port_state_dict(), strict=True)
    state = DistilTrainState.create(model, PC.OptimConfig(d_model=16,
                                                          warmup_steps=10))
    local = {k: torch.from_numpy(v) for k, v in C.global_batch().items()}
    state, _ = make_distil_train_step(model)(state, local, 0)
    save_train_state(root / "one", state)
    return ({k: v.numpy().copy() for k, v in model.state_dict().items()},
            state.optimizer.state_dict()["state"],
            {k: p.grad.numpy().copy() for k, p in model.named_parameters()
             if p.grad is not None})


def fit_setup(root):
    """tests/test_torch_ddp.py's fit setup, without its imports: a CTC
    student with logit KD, 6 seeded noise clips of 0.6-1.0 s, a 28-piece
    BPE, global batches of 4. (configs, tokenizer, manifest,
    TrainConfig)."""
    rng = np.random.default_rng(3)
    words = ["the", "cat", "sat", "on", "a", "mat", "dog", "ran", "far"]
    entries = []
    for i in range(6):
        dur = float(np.round(rng.uniform(0.6, 1.0), 3))
        write_wav(root / f"u{i}.wav", (rng.normal(size=int(16000 * dur))
                                       * 0.1).astype(np.float32), 16000)
        entries.append(ManifestEntry(str(root / f"u{i}.wav"), dur, " ".join(
            rng.choice(words, size=rng.integers(2, 5)))))
    write_manifest(root / "m.jsonl", entries)
    tok = train_bpe([e.text for e in entries], 28)
    teacher, student = C.configs(PC)
    teacher = dataclasses.replace(teacher, decoder=dataclasses.replace(
        teacher.decoder, num_classes=tok.vocab_size))
    student = PC.make_student_config(teacher)
    d = PC.DistillationConfig(use_logit_distillation=True)
    ds = dict(batch_size=4, max_duration=16.7)
    cfg = PC.TrainConfig(
        model=student, distillation=d,
        optim=PC.OptimConfig(d_model=16, warmup_steps=10),
        train_ds=PC.DataConfig(shuffle=True, **ds),
        test_ds=PC.DataConfig(shuffle=False, **ds), max_epochs=2)
    return student, teacher, d, tok, str(root / "m.jsonl"), cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two launches (2 ranks: dp1 x tp2 steps, a one-rank checkpoint's
    restore and the Trainer's fit; 4 ranks: dp2 x tp2 steps), waited for
    in a thread while JAX's references compile here."""
    root = tmp_path_factory.mktemp("tp")
    teacher, student, d = configs(PC)
    sd = str(root / "w.pt")
    batch = C.global_batch()
    fs, ft, fd, tok, man, fcfg = fit_setup(root)
    tp_cfg = dataclasses.replace(fcfg, tp_size=2)
    run = lambda jobs, n: launch(R.run_jobs, (jobs,), ["cpu"] * n,
                                 timeout=240, coll_timeout=120, threads=1)
    with ThreadPoolExecutor(2) as pool:
        # the ranks start at once and wait for the weights and the
        # one-rank checkpoint, written here meanwhile
        f4 = pool.submit(run, [("tp_steps", (student, teacher, d, sd, batch,
                                             2, 2, STEPS))], 4)
        f2 = pool.submit(run, [
            ("tp_steps", (student, teacher, d, sd, batch, 1, 2, STEPS,
                          str(root / "tp_ckpt"))),
            ("tp_steps", (student, teacher, d, sd, batch, 1, 2, 0, None,
                          str(root / "one" / "last"))),
            ("tp_fit", (fs, ft, fd, tok, man, str(root / "fit2"),
                        tp_cfg))], 2)
        torch.save(port_state_dict(), sd + ".tmp")
        Path(sd + ".tmp").rename(sd)
        one_sd, one_opt, one_grads = one_rank_checkpoint(root)
        want = jax_steps()
        torch.manual_seed(0)
        tr = Trainer(DistilCTCModel(fs, ft, fd), fcfg, tok, root / "fit1",
                     log_every=1, device="cpu")
        tr.fit(man, max_steps=3)
        fit1 = [json.loads(line)
                for line in open(root / "fit1" / "metrics.jsonl")]
        got2, got4 = f2.result(), f4.result()
    return {"want": want, "two": got2, "four": got4, "root": root,
            "one": (one_sd, one_opt), "one_grads": one_grads,
            "fit1": fit1}


@pytest.mark.parametrize("layout", ["dp1_tp2", "dp2_tp2"])
def test_tp_steps_match_jax(runs, layout):
    want_losses, want_states = runs["want"]
    ranks = runs["two" if layout == "dp1_tp2" else "four"]
    got = ranks[0][0]
    teacher, student, _ = configs(PC)
    for r in ranks:                      # every rank logs the same
        assert [m["loss/total"] for m in r[0]["metrics"]] == \
            [m["loss/total"] for m in got["metrics"]]
    # each rank runs half of every attention's heads: (student's 1 of 2,
    # teacher's 2 of 4), the first at its model index
    assert got["heads"][0] == (1, 0) and (2, 0) in got["heads"]
    assert ranks[1][0]["heads"][0] == (1, 1)
    for i in range(STEPS):
        np.testing.assert_allclose(got["metrics"][i]["loss/total"],
                                   want_losses[i], rtol=1e-4)
    grads = runs["one_grads"]          # the one-rank step's, held to JAX's
    top = max(np.abs(g).max() for g in grads.values())
    assert set(got["grads"]) == set(grads)
    for k, g in got["grads"].items():
        w = grads[k]
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 + 1e-4 * np.abs(w).max(),
                                   err_msg=k)
    decided = {k: np.abs(g) > 1e-4 * top for k, g in grads.items()}
    schedule = DistilTrainState.create(
        DistilCTCModel(student, teacher),
        PC.OptimConfig(d_model=16, warmup_steps=10)).schedule
    prev = None
    for i in range(STEPS):
        want_sd = {k: v.numpy() for k, v in distil_to_state_dict(
            *want_states[i], student, teacher).items()}
        lr = schedule(i)
        for k, t in got["states"][i].items():
            if "num_batches_tracked" in k:
                continue
            keep = decided.get(k, np.ones(t.shape, bool))
            atol = 5e-3 * lr
            if k.endswith("running_mean") and prev is not None:
                # BatchNorm's mean moves with the depthwise bias of the
                # step before, whose gradient is rounding noise (zero in
                # exact arithmetic) that Adam turns into a step of either
                # sign: 1 - momentum of the biases' difference
                b = k.replace("batch_norm.running_mean",
                              "depthwise_conv.bias")
                atol = atol + 0.1 * np.abs(prev[0][b] - prev[1][b])
            atol = np.broadcast_to(atol, t.shape)[keep]
            diff = np.abs(t[keep] - want_sd[k][keep])
            assert np.all(diff <= atol + 1e-5 * np.abs(want_sd[k][keep])), \
                f"step {i + 1}: {k}: max |err| {diff.max()}"
        prev = (got["states"][i], want_sd)


def test_attention_dropout_streams_of_tp2_equal_tp1():
    rng = np.random.default_rng(3)
    b, t, d, h = 2, 9, 16, 4
    dk = d // h
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    x = f(b, t, d)
    wq, wk, wv, wp, wo = (f(d, d) * 0.3 for _ in range(5))
    bq, bk, bv = f(d), f(d), f(d)
    bu, bvv = f(h, dk), f(h, dk)
    pe = rel_positional_encoding(t, d)
    mask = torch.arange(t)[None] < torch.tensor([9, 6])[:, None]
    whole = relpos_attention_plain(x, wq, bq, wk, bk, wv, bv, bu, bvv, wp,
                                   wo, pe, mask, h, 0.1, 1234)
    parts = 0
    for first in (0, 2):
        sl = slice(first * dk, (first + 2) * dk)
        parts = parts + relpos_attention_plain(
            x, wq[sl], bq[sl], wk[sl], bk[sl], wv[sl], bv[sl],
            bu[first:first + 2], bvv[first:first + 2], wp[sl], wo[:, sl],
            pe, mask, 2, 0.1, 1234, None, (-1, -1), (first, h))
    no_drop = relpos_attention_plain(x, wq, bq, wk, bk, wv, bv, bu, bvv, wp,
                                     wo, pe, mask, h)
    assert (whole - no_drop).abs().max() > 1e-3      # dropout acted
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), rtol=0,
                               atol=1e-6)


def test_checkpoint_moves_between_tp2_and_one_rank(runs):
    one_sd, one_opt = runs["one"]
    restored = runs["two"][0][1]
    assert restored["restored_step"] == 1
    for k, v in one_sd.items():
        np.testing.assert_array_equal(restored["restored"][k], v, err_msg=k)
    for i, st in one_opt.items():
        for k, v in st.items():
            if torch.is_tensor(v) and v.dim() > 0:
                np.testing.assert_array_equal(restored["restored_opt"][i][k],
                                              v.numpy(), err_msg=f"{i} {k}")
    # the tp 2 ranks' checkpoint, at one rank
    teacher, student, d = configs(PC)
    model = DistilCTCModel(student, teacher, d)
    state = DistilTrainState.create(model, PC.OptimConfig(d_model=16,
                                                          warmup_steps=10))
    state = restore_train_state(Path(runs["root"]) / "tp_ckpt", state)
    assert state.step == STEPS
    tp_final = runs["two"][0][0]["states"][-1]
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), tp_final[k], err_msg=k)


def test_trainer_at_tp2_logs_the_one_rank_steps(runs):
    one = [r for r in runs["fit1"] if "loss/total" in r]
    two = [r for r in runs["two"][0][2] if "loss/total" in r]
    assert [r["step"] for r in two] == [r["step"] for r in one] == [1, 2, 3]
    for a, b in zip(one, two):
        for k in [k for k in a if k.startswith("loss/")] + ["grad_norm"]:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("num_classes", [128, 127])
def test_rules_pick_jax_leaves(tp, num_classes):
    params, stats = jax_weights(num_classes)

    def marker(path, a):
        spec = tuple(_spec_for(_path_names(path), a.shape, tp))
        out = np.zeros(a.shape, np.float32)
        if "model" in spec:
            ax = spec.index("model")
            shape = [1] * a.ndim
            shape[ax] = a.shape[ax]
            out = out + np.arange(1, a.shape[ax] + 1,
                                  dtype=np.float32).reshape(shape)
        return out

    teacher, student, _ = configs(PC, num_classes)
    marks = distil_to_state_dict(
        jax.tree_util.tree_map_with_path(marker, params),
        jax.tree.map(np.zeros_like, stats), student, teacher)
    n_split = 0
    for key, t in marks.items():
        varies = [d for d in range(t.dim()) if t.shape[d] > 1 and bool(
            (t - t.narrow(d, 0, 1)).abs().max() > 0)]
        want = varies[0] if varies else None
        assert split_dim(key, tuple(t.shape), tp) == want, key
        n_split += want is not None
    vocab = num_classes + 1
    for who in ("student", "teacher"):
        key = f"{who}.decoder.decoder_layers.0.weight"
        got = split_dim(key, tuple(marks[key].shape), tp)
        assert got == (0 if vocab % tp == 0 else None), (key, vocab)
    assert n_split > 0
