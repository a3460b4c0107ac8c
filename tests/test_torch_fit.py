"""The port's fit loop on its own, on the CPU (tpu_asr_torch/train/loop.py,
utils/checkpoint.py, utils/exp_manager.py):

- a CTC fit stopped after 3 steps (mid-epoch) and resumed in a new
  process state (a new model from the same initial weights, a new
  Trainer) equals
  the fit never stopped, bit for bit: the losses of every step, the final
  weights, BatchNorm statistics and optimizer state, with dropout 0.1,
  SpecAugment and dither on (the step's generators come from (seed,
  step), and the resumed epoch skips the batches it had trained on);
- the checkpoint restores bit-equal, the student export loads into a
  CTCModel bit-equal, and `last` rotates to the `last-vN` names JAX's
  rotate_last gives;
- heartbeats, the straggler report and the train-batch WER fire when a
  step crosses their interval (exp_manager.crossed; JAX's `step % N == 0`
  misses a multiple inside a multi-step dispatch);
- `evaluate_packed` gives `evaluate`'s WER and its loss within 1e-5 (a CTC
  student; the attention's segment mode runs its plain version here),
  and refuses flow matching;
- the Trainer refuses what it does not run: a tp_size that does not
  divide the world (tp_size=2 on one rank), a dp_size other than the
  world, a teacher cache with steps_per_dispatch > 1;
- exp_manager: versioned run directories with a config snapshot, the
  step timer, a torch.profiler trace, fault injection's refusals, and
  SIGTERM during a fit saving the checkpoint before exiting 143; a
  SIGTERM that lands inside the optimizer's update (parameters moved, the
  step not yet counted) is saved after the step, and the fit resumed from
  that checkpoint equals the fit never stopped, bit for bit;
- MetricsLogger's W&B passthrough with a stand-in `wandb` module.
"""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import dataclasses
import json

import numpy as np
import pytest
import torch

import tpu_asr_torch.config as PC
from tpu_asr.utils.checkpoint import rotate_last as jax_rotate_last
from tpu_asr_torch.data.audio import write_wav
from tpu_asr_torch.data.manifest import ManifestEntry, write_manifest
from tpu_asr_torch.data.tokenizer import train_bpe
from tpu_asr_torch.models.ctc_model import CTCModel
from tpu_asr_torch.models.distil_model import DistilCTCModel
from tpu_asr_torch.train.loop import Trainer
from tpu_asr_torch.utils.checkpoint import (export_student, load_student,
                                            restore_train_state, rotate_last,
                                            save_train_state)
from tpu_asr_torch.utils.exp_manager import (StepTimer, check_heartbeats,
                                             crossed, maybe_inject_fault,
                                             profile_trace, setup_experiment)


WORDS = ["the", "cat", "sat", "on", "a", "mat", "dog", "ran", "far", "away"]


def corpus(root, n=6, seed=0, lo=2.2, hi=3.0):
    """n seeded noise clips of lo..hi s (one duration bucket) with texts
    from WORDS; returns (manifest path, texts)."""
    rng = np.random.default_rng(seed)
    entries = []
    for i in range(n):
        dur = float(np.round(rng.uniform(lo, hi), 3))
        x = (rng.normal(size=int(16000 * dur)) * 0.1).astype(np.float32)
        write_wav(root / f"u{i}.wav", x, 16000)
        entries.append(ManifestEntry(
            str(root / f"u{i}.wav"), dur,
            " ".join(rng.choice(WORDS, size=rng.integers(2, 5)))))
    write_manifest(root / "m.jsonl", entries)
    return str(root / "m.jsonl"), [e.text for e in entries]


def configs(mod, vocab, dropout=0.0, spec=False, dither=0.0):
    enc = mod.EncoderConfig(n_layers=2, d_model=64, n_heads=4,
                            conv_kernel_size=7, dropout=dropout,
                            dropout_pre_encoder=dropout, dropout_att=dropout)
    teacher = mod.ModelConfig(
        spec_augment=mod.SpecAugmentConfig() if spec else None,
        preprocessor=mod.PreprocessorConfig(dither=dither), encoder=enc,
        decoder=mod.DecoderConfig(feat_in=64, num_classes=vocab),
        compute_dtype="float32")
    return teacher, mod.make_student_config(teacher)


def train_config(mod, student, distill, epochs=2):
    ds = dict(batch_size=3, max_duration=16.7)
    return mod.TrainConfig(
        model=student, distillation=distill,
        optim=mod.OptimConfig(d_model=32, warmup_steps=10),
        train_ds=mod.DataConfig(shuffle=True, **ds),
        test_ds=mod.DataConfig(shuffle=False, **ds), max_epochs=epochs,
        dp_size=1)


def _trainer(man, texts, workdir, distill=None, epochs=2, **cfg_kw):
    tok = train_bpe(texts, 28)
    teacher, student = configs(PC, tok.vocab_size, dropout=0.1, spec=True,
                               dither=1e-5)
    distill = distill or PC.DistillationConfig(use_logit_distillation=True)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = DistilCTCModel(student, teacher, distill)
    cfg = dataclasses.replace(train_config(PC, student, distill, epochs),
                              **cfg_kw)
    return Trainer(model, cfg, tok, workdir, log_every=1, device="cpu")


def _rows(path):
    return [json.loads(l) for l in open(path)]


def _losses(rows):
    return [{k: v for k, v in r.items() if k.startswith("loss/")}
            for r in rows if "loss/total" in r]


@pytest.fixture(scope="module")
def whole_fit(tmp_path_factory):
    """(corpus root, manifest, texts, Trainer) of a CTC fit of two epochs
    never stopped."""
    root = tmp_path_factory.mktemp("whole_fit")
    man, texts = corpus(root, seed=3, lo=0.6, hi=1.0)
    whole = _trainer(man, texts, root / "whole",
                     distill=PC.DistillationConfig())
    whole.fit(man)
    assert whole.state.step == 4 and whole.state.epoch == 2
    return root, man, texts, whole


def _assert_same_fit(whole, second, root, split):
    assert _losses(_rows(split / "metrics.jsonl")) == \
        _losses(_rows(root / "whole" / "metrics.jsonl"))
    want = whole.model.state_dict()
    for k, v in second.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    a, b = whole.state.optimizer.state_dict(), \
        second.state.optimizer.state_dict()
    for i, st in a["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(b["state"][i][k])), (i, k)


def test_resumed_fit_equals_uninterrupted(tmp_path, whole_fit):
    root, man, texts, whole = whole_fit
    ctc = PC.DistillationConfig()
    first = _trainer(man, texts, tmp_path / "split", distill=ctc)
    first.fit(man, max_steps=3)
    assert (first.state.step, first.state.epoch,
            first.state.epoch_step) == (3, 1, 2)
    second = _trainer(man, texts, tmp_path / "split", distill=ctc)
    second.fit(man, resume=True)
    assert second.state.step == 4
    _assert_same_fit(whole, second, root, tmp_path / "split")


def test_sigterm_inside_optimizer_step_resumes_exactly(tmp_path, whole_fit):
    import os
    import signal

    root, man, texts, whole = whole_fit
    ctc = PC.DistillationConfig()

    first = _trainer(man, texts, tmp_path / "split", distill=ctc)
    first.init_state()
    opt = first.state.optimizer
    update = opt.step

    def killed_mid_step(*a, **kw):
        out = update(*a, **kw)
        if first.state.step == 2:
            # the weights and moments of step 3 are written; the trainer
            # has not yet counted the step
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    opt.step = killed_mid_step
    with pytest.raises(SystemExit) as exc:
        first.fit(man)
    assert exc.value.code == 143
    saved = torch.load(first.ckpt_dir / "last", weights_only=True)
    assert (saved["step"], saved["epoch"], saved["epoch_step"]) == (3, 1, 2)
    second = _trainer(man, texts, tmp_path / "split", distill=ctc)
    second.fit(man, resume=True)
    assert second.state.step == 4
    _assert_same_fit(whole, second, root, tmp_path / "split")


def test_checkpoint_roundtrip_and_rotation(tmp_path):
    man, texts = corpus(tmp_path, n=3, seed=4, lo=0.6, hi=1.0)
    tr = _trainer(man, texts, tmp_path / "run", epochs=1)
    tr.fit(man)
    ckpt = tr.ckpt_dir
    assert (ckpt / "last").is_file()
    fresh = _trainer(man, texts, tmp_path / "other")
    fresh.init_state()
    restore_train_state(ckpt, fresh.state)
    assert fresh.state.step == tr.state.step == 1
    for k, v in tr.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    want = tr.state.optimizer.state_dict()["state"]
    got = fresh.state.optimizer.state_dict()["state"]
    assert all(torch.equal(got[i]["exp_avg"], want[i]["exp_avg"])
               for i in want)
    export_student(ckpt, tr.state, tr.model.student_cfg)
    student = load_student(ckpt / "student", CTCModel(tr.model.student_cfg))
    for k, v in tr.model.student.state_dict().items():
        assert torch.equal(student.state_dict()[k], v), k
    assert json.loads((ckpt / "student_config.json").read_text())[
        "encoder"]["d_model"] == 32

    # last -> last-vN, the names JAX's rotate_last gives
    jdir, pdir = tmp_path / "jax_ckpt", tmp_path / "port_ckpt"
    for d in (jdir, pdir):
        d.mkdir()
        (d / "last-v1").mkdir()
    for _ in range(2):
        (jdir / "last").mkdir()
        jax_rotate_last(jdir)
        save_train_state(pdir, tr.state)
        rotate_last(pdir)
    assert sorted(p.name for p in pdir.iterdir()) == \
        sorted(p.name for p in jdir.iterdir()) == ["last-v1", "last-v2",
                                                    "last-v3"]
    # a fresh fit rotates the old `last` away; a resumed one keeps it
    tr2 = _trainer(man, texts, tmp_path / "run", epochs=1)
    tr2.fit(man)
    assert (ckpt / "last-v1").is_file() and (ckpt / "last").is_file()


def test_heartbeats_fire_on_interval_crossings(tmp_path):
    assert crossed(4, 1, 2) and not crossed(3, 1, 2)
    # a dispatch of 3 steps ending at step 5 crosses 4; 5 % 4 != 0
    assert crossed(5, 3, 4) and not crossed(7, 2, 4) and not crossed(5, 3, 0)
    man, texts = corpus(tmp_path, seed=5, lo=0.6, hi=1.0)
    tr = _trainer(man, texts, tmp_path / "run", heartbeat_every=2,
                  straggler_report_every=3)
    tr.train_wer_every = 2
    tr.fit(man, max_steps=3)
    beats = check_heartbeats(tmp_path / "run", timeout_s=3600)
    assert beats["ranks"][0]["step"] == 2 and beats["stale"] == []
    reports = [r for r in _rows(tmp_path / "run" / "metrics.jsonl")
               if "straggler/n_flagged" in r]
    assert [r["step"] for r in reports] == [3]
    wers = [r for r in _rows(tmp_path / "run" / "metrics.jsonl")
            if "train_wer" in r]
    assert [r["step"] for r in wers] == [2] and wers[0]["train_wer"] > 0


def test_evaluate_packed_matches_evaluate(tmp_path):
    man, texts = corpus(tmp_path, n=7, seed=6, lo=0.5, hi=6.0)
    tr = _trainer(man, texts, tmp_path / "run",
                  distill=PC.DistillationConfig())
    tr.init_state()
    want = tr.evaluate(man)
    got = tr.evaluate_packed(man, t_pack=160, row_multiple=2, utt_chunk=4)
    assert got["num_utts"] == want["num_utts"] == 7
    assert got["wer"] == want["wer"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    fm = _trainer(man, texts, tmp_path / "fm", distill=PC.DistillationConfig(
        use_flow_matching=True, flow=PC.FlowMatchingConfig(
            student_dim=32, teacher_dim=64, hidden_dim=16, time_embed_dim=8,
            training_sampling=2, inference_sampling=2)))
    fm.init_state()
    with pytest.raises(ValueError, match="flow"):
        fm.evaluate_packed(man)


@pytest.mark.parametrize("change", [dict(steps_per_dispatch=2,
                                         cache_teacher=True),
                                    dict(steps_per_dispatch=3,
                                         cache_teacher_all=True),
                                    dict(tp_size=2),
                                    dict(dp_size=2)])
def test_trainer_refuses(tmp_path, change):
    man, texts = corpus(tmp_path, n=2, seed=7)
    with pytest.raises(ValueError, match="does not run"):
        _trainer(man, texts, tmp_path / "run", **change)


def test_exp_manager(tmp_path):
    cfg = PC.OptimConfig()
    first = setup_experiment(tmp_path, cfg, project="p", name="n")
    assert json.loads((first / "config.json").read_text())["lr"] == 2.0
    again = setup_experiment(tmp_path, project="p", name="n")
    assert (first.name, again.name) == ("n", "n-v1")
    timer = StepTimer()
    for _ in range(5):
        timer.tick()
    s = timer.summary()
    assert s["steps_measured"] == 4 and s["step_time_p95"] >= \
        s["step_time_p50"] >= 0
    with profile_trace(tmp_path, enabled=True) as trace_dir:
        torch.ones(8).sum()
    assert (trace_dir / "trace.json").is_file()
    with profile_trace(tmp_path) as off:
        assert off is None
    maybe_inject_fault(None, 3)
    maybe_inject_fault("rank_killed:1:3", 3)        # another rank: no-op
    maybe_inject_fault("rank_killed:0:9", 3)        # another step: no-op
    with pytest.raises(ValueError, match="fault kind"):
        maybe_inject_fault("rank_slow:0:3", 3)


def test_sigterm_saves_then_exits(tmp_path):
    import os
    import signal

    man, texts = corpus(tmp_path, n=3, seed=8, lo=0.6, hi=1.0)
    tr = _trainer(man, texts, tmp_path / "run", epochs=3)
    step = tr._train_step

    def killed_after_two(state, batch, seed):
        state, m = step(state, batch, seed)
        if state.step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return state, m

    tr._train_step = killed_after_two
    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit) as exc:
        tr.fit(man)
    assert exc.value.code == 143
    assert signal.getsignal(signal.SIGTERM) is before
    saved = torch.load(tr.ckpt_dir / "last", weights_only=True)
    assert (saved["step"], saved["epoch"], saved["epoch_step"]) == (2, 1, 1)


def test_metrics_logger_passes_rows_to_wandb(monkeypatch, tmp_path):
    """MetricsLogger's W&B passthrough (JAX's, tpu_asr/train/loop.py), with
    a stand-in `wandb` module (the package is not installed): init on the
    main process with the project, name and workdir, every JSONL row
    logged at its step; without `wandb`, or when its init raises, the
    JSONL alone."""
    import sys
    import types

    from tpu_asr_torch.train.loop import MetricsLogger
    calls = []

    class Run:
        def log(self, row, step):
            calls.append(("log", row, step))

    def init(project=None, name=None, dir=None):
        calls.append(("init", project, name, dir))
        return Run()

    monkeypatch.setitem(sys.modules, "wandb", types.SimpleNamespace(init=init))
    logger = MetricsLogger(tmp_path / "a", project="p", name="n")
    logger.log({"loss": torch.tensor(1.5), "note": "x"}, 3)
    assert calls == [("init", "p", "n", str(tmp_path / "a")),
                     ("log", {"step": 3, "loss": 1.5}, 3)]
    assert json.loads((tmp_path / "a" / "metrics.jsonl").read_text()) == \
        {"step": 3, "loss": 1.5}

    def broken(**_):
        raise RuntimeError("no network")
    monkeypatch.setitem(sys.modules, "wandb",
                        types.SimpleNamespace(init=broken))
    MetricsLogger(tmp_path / "b").log({"loss": 2.0}, 1)
    monkeypatch.setitem(sys.modules, "wandb", None)
    MetricsLogger(tmp_path / "c").log({"loss": 2.0}, 1)
    for d in "bc":
        assert (tmp_path / d / "metrics.jsonl").read_text() == \
            '{"step": 1, "loss": 2.0}\n'
    assert len(calls) == 2
