"""Data-parallel training of the port across processes, on the CPU: two gloo
ranks started by tpu_asr_torch/parallel/launch.py (spawn, never fork: this
process has JAX loaded), each holding 2 rows of a global batch of 4, at the
size of tests/ddp_cases.py (24 features, teacher d 32 / student d 16, 2
layers, conv kernel 7 with BatchNorm). One launch serves the tests of the
module fixture, beside the CLI's own run; every collective times out after
120 s, the launch and the CLI after 240 s. (The 2-rank step against JAX's
is tests/test_torch_ddp_jax.py, apart so that each file stays under 30 s.)

- (a) the mesh helpers under the group: sums, broadcast, barriers, the
  differentiable all-reduce and its backward, gathered rows, row offsets
  and draws cut to the rank's rows;
- (d) 2 ranks against 1 with dropout 0.1, SpecAugment and dither on, for
  logit KD + FM, the router ('batch_mode') and logit KD + FM + DiffKD
  (whose DDP finds unused parameters), 2 steps from seeded
  weights: losses at 1e-5, the gradients of the first step (1e-5 + 1e-4 x
  the tensor's max|ref|), the BatchNorm running statistics after it at
  1e-5, the router's counts equal where their Gumbel margin exceeds 1e-3,
  the parameters after 2 steps by the fp32 rule of
  tests/test_torch_train.py (elements whose gradient exceeds 1e-4 x the
  largest, within 1e-5 x |ref| + 2e-2 x the learning rate);
- (e) a 2-rank Trainer.fit of 3 steps with evaluate and evaluate_packed,
  then a 1-rank restore of its checkpoint: WER equal and loss within 1e-5;
  rank 0 alone writes metrics and checkpoints, each rank its heartbeat; a
  checkpoint saved at 1 rank restores at 2 with the same evaluation;
- (f) `python -m tpu_asr_torch.cli.asr_train --platform cpu --gpus 2`
  trains 2 steps and writes one metrics.jsonl and one checkpoints
  directory (rank 0's), and prints its result once.
"""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ddp_cases as C
import torch_ddp_ranks as R
import tpu_asr_torch.config as PC
from test_torch_fit import corpus
from tpu_asr_torch.data.tokenizer import train_bpe
from tpu_asr_torch.models.distil_model import DistilCTCModel
from tpu_asr_torch.parallel.launch import launch
from tpu_asr_torch.train.loop import Trainer
from tpu_asr_torch.train.optim import build_optimizer
from tpu_asr_torch.utils.checkpoint import save_train_state

ROOT = Path(__file__).resolve().parent.parent
# the cases with every random draw on: (case of ddp_cases, changes to its
# DistillationConfig, to its FlowMatchingConfig); DiffKD's teacher encoder
# takes no gradient, so its DDP looks for unused parameters
DRAWS = {"logit_fm": ("logit_fm", {}, {}),
         "router_mode": ("router_median", {}, {"router_strategy":
                                               "batch_mode"}),
         "diffkd": ("logit_fm", {"use_diffkd": True, "diffkd":
                                 PC.DiffKDConfig(steps=3, teacher_dim=32,
                                                 student_dim=16,
                                                 latent_dim=16)}, {})}


def fit_setup(root):
    """(configs, tokenizer, manifest, TrainConfig) of the fit test: a CTC
    student with logit KD, 6 clips of 0.6-1.0 s, global batches of 4."""
    man, texts = corpus(root, n=6, seed=3, lo=0.6, hi=1.0)
    tok = train_bpe(texts, 28)
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
        test_ds=PC.DataConfig(shuffle=False, **ds), max_epochs=2,
        heartbeat_every=1, straggler_report_every=2)
    return student, teacher, d, tok, man, cfg


CLI_YAML = """preprocessor:
  features: 24
  dither: 0.0
encoder:
  feat_in: 24
  n_layers: 2
  d_model: 32
  n_heads: 4
  conv_kernel_size: 7
  dropout: 0.0
  dropout_pre_encoder: 0.0
  dropout_att: 0.0
decoder:
  feat_in: 32
  num_classes: 28
"""


def start_cli(root):
    """asr_train with --platform cpu --gpus 2, in the background."""
    man, _ = corpus(root, n=8, seed=9, lo=0.6, hi=1.0)
    (root / "tiny.yaml").write_text(CLI_YAML)
    env = dict(os.environ, PYTHONPATH=str(ROOT), EXP_NAME="run")
    env.pop("XLA_FLAGS", None)
    log = open(root / "cli.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_asr_torch.cli.asr_train", "--platform",
         "cpu", "--gpus", "2", "--train_manifest", man, "--val_manifest",
         man, "--config", str(root / "tiny.yaml"), "--epochs", "1",
         "--batch_size", "4", "--output_dir", str(root / "out")],
        cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    return proc, log


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every 2-rank job of this module in one launch, beside the CLI run."""
    root = tmp_path_factory.mktemp("ddp")
    (root / "cli").mkdir()
    cli = start_cli(root / "cli")
    try:
        jobs, draws, batch = [("mesh_probe", ())], {}, C.global_batch()
        for name, (case, change, flow) in DRAWS.items():
            teacher, student, d = C.case_configs(PC, case, dropout=0.1,
                                                 spec=True, dither=1e-5)
            d = dataclasses.replace(d, flow=dataclasses.replace(d.flow,
                                                                **flow),
                                    **change)
            torch.manual_seed(0)
            sd = str(root / f"{name}.pt")
            torch.save(DistilCTCModel(student, teacher, d).state_dict(), sd)
            draws[name] = (student, teacher, d, sd, batch, 2)
            jobs.append(("run_steps", draws[name]))
        fit = fit_setup(root)
        w1 = Trainer(DistilCTCModel(fit[0], fit[1], fit[2]), fit[5], fit[3],
                     root / "w1", device="cpu")
        w1.init_state()
        save_train_state(root / "w1", w1.state, name="start")
        jobs += [("fit_and_eval", (*fit[:5], str(root / "fit"), fit[5])),
                 ("restore_and_eval", (*fit[:5], str(root / "w1r"), fit[5],
                                       str(root / "w1" / "start")))]
        got = launch(R.run_jobs, (jobs,), ["cpu", "cpu"], timeout=240,
                     coll_timeout=120, threads=2)
    except BaseException:
        cli[0].kill()
        raise
    return {"root": root, "ranks": got, "draws": draws, "fit": fit,
            "w1": w1, "cli": cli}


def test_mesh_helpers_across_two_ranks(runs):
    for r, probe in enumerate(p[0] for p in runs["ranks"]):
        assert (probe["rank"], probe["world"], probe["main"]) == (r, 2,
                                                                  r == 0)
        assert probe["sum"] == [1.0, 2.0] and probe["bcast"] == 41
        assert probe["any"] == [True, False] and probe["local"] == 7
        assert (probe["offset"], probe["rows"]) == (3 * r, 6)
        np.testing.assert_array_equal(probe["gather"], [[0, 10, 1, 11]])
        np.testing.assert_array_equal(probe["reduced"], np.full((2, 3), 6.0))
        np.testing.assert_array_equal(probe["grad"], np.full((2, 3), 6.0))
        assert (probe["gsum"], probe["gmean"], probe["bmean"]) == (1.0, 3.5,
                                                                   r / 2)
        want = torch.rand(4, 5, generator=torch.Generator().manual_seed(7))
        np.testing.assert_array_equal(probe["drawn"],
                                      want[2 * r:2 * r + 2].numpy())


def _fp32_rule(one, two, steps, lr):
    """tests/test_torch_train.py's comparison of parameters after `steps`
    steps, on the elements whose first gradient is decided. The BatchNorm
    running statistics are held after the first step: after the second
    they carry the depthwise-conv bias, whose gradient is zero in exact
    arithmetic and whose Adam step is therefore rounding noise at the
    learning rate's scale (test_torch_train.py)."""
    grads = one["grads"]
    top = max(float(np.abs(g).max()) for g in grads.values())
    for k, want in one["stats1"].items():
        np.testing.assert_allclose(two["stats1"][k], want, rtol=0, atol=1e-5,
                                   err_msg=k)
    for k, want in one["state"].items():
        got = two["state"][k]
        if "num_batches_tracked" in k:
            assert got == want == (0 if k.startswith("teacher.") else
                                   steps), k
        elif "running" in k:
            continue
        elif k in grads:
            keep = np.abs(grads[k]) > 1e-4 * top
            np.testing.assert_allclose(got[keep], want[keep], rtol=1e-5,
                                       atol=2e-2 * lr, err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("name", list(DRAWS))
def test_two_ranks_equal_one_with_every_random_draw(runs, name):
    i = 1 + list(DRAWS).index(name)
    two = runs["ranks"][0][i]
    student, teacher, d, sd, batch, steps = runs["draws"][name]
    one = R.run_steps(student, teacher, d, sd, batch, steps)
    for a, b in zip(one["metrics"], two["metrics"]):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    for k, w in one["grads"].items():
        np.testing.assert_allclose(two["grads"][k], w, rtol=0,
                                   atol=1e-5 + 1e-4 * np.abs(w).max(),
                                   err_msg=k)
    for (s1, m1), (s2, _) in zip(one["router"], two["router"]):
        sure = m1 > 1e-3
        assert sure.mean() > 0.9
        np.testing.assert_array_equal(s2[sure], s1[sure])
    assert len(one["router"]) == (steps if d.flow.use_dynamic_steps else 0)
    _, schedule = build_optimizer(PC.OptimConfig(d_model=16,
                                                 warmup_steps=10),
                                  DistilCTCModel(student, teacher, d))
    _fp32_rule(one, two, steps, schedule(steps - 1))


def test_fit_eval_and_cross_restore(runs):
    root = runs["root"]
    student, teacher, d, tok, man, cfg = runs["fit"]
    fits = [rank[-2] for rank in runs["ranks"]]
    assert fits[0] == fits[1] and fits[0][0] == 3
    _, bucketed, packed = fits[0]
    assert bucketed["num_utts"] == packed["num_utts"] == 6
    assert packed["wer"] == bucketed["wer"]
    np.testing.assert_allclose(packed["loss"], bucketed["loss"], rtol=1e-5)
    rows = [json.loads(l) for l in open(root / "fit" / "metrics.jsonl")]
    assert [r["step"] for r in rows if "loss/total" in r] == [1, 2, 3]
    assert [r["step"] for r in rows if "val/wer" in r] == [2, 3]
    assert sorted(p.name for p in (root / "fit" / "checkpoints").iterdir()) \
        == ["last"]
    assert sorted(p.name for p in (root / "fit" / "heartbeats").iterdir()) \
        == ["rank0", "rank1"]
    assert [r["straggler/n_flagged"] >= 0 for r in rows
            if "straggler/n_flagged" in r] == [True]
    # the 2-rank checkpoint restored at one rank
    one = R.restore_and_eval(student, teacher, d, tok, man, root / "one",
                             cfg, str(root / "fit" / "checkpoints" / "last"))
    assert one[0] == 3 and one[1]["wer"] == bucketed["wer"]
    np.testing.assert_allclose(one[1]["loss"], bucketed["loss"], rtol=1e-5)
    # a 1-rank checkpoint restored at two ranks
    restored = [rank[-1] for rank in runs["ranks"]]
    want = runs["w1"].evaluate(man)
    for step, ev in restored:
        assert step == 0 and ev["wer"] == want["wer"]
        np.testing.assert_allclose(ev["loss"], want["loss"], rtol=1e-5)


def test_cli_trains_on_two_cpu_ranks(runs):
    proc, log = runs["cli"]
    try:
        rc = proc.wait(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
        log.close()
    root = runs["root"] / "cli"
    text = (root / "cli.log").read_text()
    assert rc == 0, text[-3000:]
    assert text.count("[val] wer=") == 1, text[-3000:]
    run = root / "out" / "run"
    rows = [json.loads(l) for l in open(run / "metrics.jsonl")]
    assert [r["step"] for r in rows if "loss/total" in r] == [1]
    assert torch.load(run / "checkpoints" / "last",
                      weights_only=True)["step"] == 2
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == [
        "last", "student", "student_config.json", "tokenizer.model"]
    assert sorted(p.name for p in (root / "out").iterdir()) == ["run"]
