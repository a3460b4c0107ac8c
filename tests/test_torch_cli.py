"""The port's CLIs (tpu_asr_torch/cli/) and its `.nemo` import, on the CPU:

- the `.nemo` of tests/test_cli.py (gzipped tar, yaml.safe_dump config)
  and the NGC-layout one of tests/test_nemo_real_format.py (plain tar of
  "./" members, a full training config with a vocabulary, a binary
  `<uniq>_tokenizer.model`) load into the port's CTCModel (config read by
  the port's YAML reader) and give JAX's log-probs and encoder output
  (its load_nemo_checkpoint and CTCModel) within 1e-4; the tokenizer
  artifact restores the same vocabulary;
- `assemble_distill_config` gives JAX's dataclasses for the flag sets of
  every entry point, and asr_inference_CV translates its CV flags as JAX's
  does;
- end to end with `--platform cpu`: asr_train (logit KD + flow matching)
  writes checkpoints/last, student and tokenizer.model and prints
  `[val] wer=.. loss=.. (n utts)`; asr_inference on `last` with the same
  flags prints the same numbers as `[librispeech/test] ...`; on the
  student export (CTC only) `--packed_eval` gives the bucketed WER and its
  loss within 1e-5; a run without a `.nemo` trains the fallback BPE and
  inference reads its sidecar; the diffm, GigaSpeech (with an int8
  teacher, --teacher_int8) and CommonVoice entry points run.
"""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import re
import sys
import tarfile
import uuid
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

import tpu_asr.config as JC
import tpu_asr_torch.config as PC
from nemo_oracle import TModel, randomize_bn_stats
from test_torch_fit import corpus
from tpu_asr.cli import common as jcommon
from tpu_asr.convert.nemo_import import \
    load_nemo_checkpoint as jax_load_nemo
from tpu_asr.data.tokenizer import train_bpe as jax_train_bpe
from tpu_asr.models.ctc_model import CTCModel as JaxCTCModel
from tpu_asr_torch.cli import (asr_inference, asr_inference_CV,
                               asr_inference_diffm, asr_train, asr_train_GS,
                               asr_train_diffm, asr_train_diffm_GS)
from tpu_asr_torch.cli import common
from tpu_asr_torch.convert.nemo_import import load_nemo_checkpoint
from tpu_asr_torch.data.tokenizer import SentencePieceBPETokenizer
from tpu_asr_torch.models.ctc_model import CTCModel

D, H, L, FEAT, K = 32, 4, 2, 24, 7
LINE = re.compile(r"^\[(\S+)\] wer=(\d+\.\d{4}) loss=(\d+\.\d{4}) "
                  r"\((\d+) utts\)$", re.M)


def _cli_nemo(root, vocab=32):
    """tests/test_cli.py's `.nemo`: a gzipped tar of model_config.yaml
    (yaml.safe_dump) and model_weights.ckpt."""
    torch.manual_seed(0)
    tm = TModel(FEAT, D, H, L, K, vocab).eval()
    pack = root / "pack"
    pack.mkdir()
    cfg = {"preprocessor": {"features": FEAT, "sample_rate": 16000},
           "encoder": {"feat_in": FEAT, "n_layers": L, "d_model": D,
                       "n_heads": H, "conv_kernel_size": K, "dropout": 0.0,
                       "dropout_pre_encoder": 0.0, "dropout_att": 0.0},
           "decoder": {"feat_in": D, "num_classes": vocab}}
    with open(pack / "model_config.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    torch.save(tm.state_dict(), pack / "model_weights.ckpt")
    nemo = root / "teacher.nemo"
    with tarfile.open(nemo, "w:gz") as tar:
        for p in pack.iterdir():
            tar.add(p, arcname=p.name)
    return nemo, tm


def _ngc_nemo(root, vocab=32):
    """tests/test_nemo_real_format.py's NGC-layout `.nemo`."""
    torch.manual_seed(7)
    tm = randomize_bn_stats(TModel(FEAT, D, H, L, K, vocab).eval())
    folder = root / "nemo_file_folder"
    folder.mkdir()
    corpus_txt = ["the quick brown fox", "jumps over the lazy dog",
                  "speech recognition distillation"] * 4
    tok = jax_train_bpe(corpus_txt, vocab_size=vocab)
    uniq = f"{uuid.uuid4().hex}_tokenizer.model"
    tok.save_proto(folder / uniq)
    cfg = {
        "target": "nemo.collections.asr.models.ctc_bpe_models."
                  "EncDecCTCModelBPE",
        "sample_rate": 16000, "log_prediction": True,
        "train_ds": {"manifest_filepath": "/data/train.json",
                     "batch_size": 32, "shuffle": True},
        "validation_ds": {"manifest_filepath": "/data/dev.json"},
        "tokenizer": {"dir": None, "type": "bpe",
                      "model_path": f"nemo:{uniq}"},
        "preprocessor": {"_target_": "nemo.collections.asr.modules."
                                     "AudioToMelSpectrogramPreprocessor",
                         "features": FEAT, "sample_rate": 16000,
                         "window_size": 0.025, "window_stride": 0.01,
                         "n_fft": 512},
        "spec_augment": {"_target_": "nemo.collections.asr.modules."
                                     "SpectrogramAugmentation",
                         "freq_masks": 2, "time_masks": 10},
        "encoder": {"_target_": "nemo.collections.asr.modules."
                                "ConformerEncoder",
                    "feat_in": FEAT, "n_layers": L, "d_model": D,
                    "n_heads": H, "conv_kernel_size": K,
                    "subsampling": "striding", "subsampling_factor": 4},
        "decoder": {"_target_": "nemo.collections.asr.modules."
                                "ConvASRDecoder",
                    "feat_in": D, "num_classes": vocab,
                    "vocabulary": list(tok.vocab)},
        "optim": {"name": "adamw", "lr": 2.0,
                  "sched": {"name": "NoamAnnealing", "warmup_steps": 10000}},
    }
    with open(folder / "model_config.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    torch.save(tm.state_dict(), folder / "model_weights.ckpt")
    nemo = root / "stt_en_tiny.nemo"
    with tarfile.open(nemo, "w:") as tar:
        tar.add(folder, arcname=".")
    return nemo, tok


@pytest.mark.parametrize("layout", ["cli", "ngc"])
def test_nemo_loads_into_the_port_with_jax_log_probs(tmp_path, layout):
    nemo, extra = (_cli_nemo if layout == "cli" else _ngc_nemo)(tmp_path)
    cfg, sd, tok_path = load_nemo_checkpoint(nemo, tmp_path / "port")
    jcfg, params, stats, jtok_path = jax_load_nemo(nemo, tmp_path / "jax")
    assert cfg == PC.ModelConfig(**{
        k: getattr(cfg, k) for k in ("sample_rate", "preprocessor",
                                     "spec_augment", "encoder", "decoder")})
    assert JC.ModelConfig(**{k: getattr(jcfg, k) for k in (
        "sample_rate", "preprocessor", "spec_augment", "encoder",
        "decoder")}) == jcfg
    import dataclasses
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    cfg.compute_dtype = jcfg.compute_dtype = "float32"
    model = CTCModel(cfg).eval()
    model.load_state_dict(sd, strict=True)
    rng = np.random.default_rng(0)
    b, t = 2, 50
    feats = rng.normal(size=(b, FEAT, t)).astype(np.float32)
    lens = np.asarray([t, t - 7], np.int64)
    with torch.no_grad():
        got = model.forward_features(torch.from_numpy(feats),
                                     torch.from_numpy(lens))
    jm = JaxCTCModel(jcfg)
    want = jm.apply({"params": params, "batch_stats": stats},
                    jax.numpy.asarray(feats), jax.numpy.asarray(lens),
                    train=False, method=jm.forward_features)
    np.testing.assert_allclose(got.log_probs.numpy(),
                               np.asarray(want.log_probs), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got.encoded.numpy(),
                               np.asarray(want.encoded), rtol=1e-4,
                               atol=1e-4)
    if layout == "ngc":
        restored = SentencePieceBPETokenizer.from_file(tok_path)
        assert list(restored.vocab) == list(extra.vocab)
        assert Path(jtok_path).name == Path(tok_path).name
    else:
        assert tok_path is None and jtok_path is None


TRAIN_FLAGS = [
    [], ["--use_logit_distillation", "true", "--kd_alpha", "0.1"],
    ["--use_flow_matching", "true", "--flow_steps", "4",
     "--meta_encoder_type", "cnn", "--flow_schedule", "vp_ode"],
    ["--use_flow_matching", "true", "--use_dynamic_steps", "true",
     "--router_strategy", "group", "--router_max_sampling_steps", "16"],
    ["--use_flow_matching", "true", "--sampling_steps_per_layer",
     "[1, 2, 4, 8, 1, 2, 4, 8, 1, 2, 4, 8, 1, 2, 4, 8]"],
    ["--use_diffkd", "true", "--diffkd_steps", "3"],
    ["--use_layerwise_distillation", "true", "--layer_kd_scope", "last",
     "--use_ctc", "false"],
]
ENTRY = [("train", {}, None), ("train", {"gigaspeech": True}, None),
         ("train", {"diffm": True}, ["--model_version", "ver5",
                                     "--latent_dim", "12"]),
         ("train", {"gigaspeech": True, "diffm": True},
          ["--model_version", "3"]),
         ("inference", {}, ["--ckpt_path", "x"]),
         ("inference", {"diffm": True}, ["--ckpt_path", "x", "--model_ver",
                                         "ver2", "--latent_dim", "24"])]


@pytest.mark.parametrize("entry", range(len(ENTRY)))
def test_assemble_distill_config_matches_jax(entry):
    import dataclasses
    kind, kw, extra = ENTRY[entry]
    build = {"train": (common.build_train_parser,
                       jcommon.build_train_parser),
             "inference": (common.build_inference_parser,
                           jcommon.build_inference_parser)}[kind]
    teacher, jteacher = PC.ModelConfig(), JC.ModelConfig()
    student = PC.make_student_config(teacher)
    jstudent = JC.make_student_config(jteacher)
    for flags in TRAIN_FLAGS:
        argv = flags + (extra or [])
        args = build[0]("x", **kw).parse_args(argv)
        jargs = build[1]("x", **kw).parse_args(argv)
        assert vars(args) == vars(jargs), argv
        version = (getattr(args, "model_version", None)
                   or getattr(args, "model_ver", None))
        got = common.assemble_distill_config(args, student, teacher,
                                             version)
        want = jcommon.assemble_distill_config(jargs, jstudent, jteacher,
                                               version)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), argv


def test_inference_cv_translates_flags_as_jax(monkeypatch):
    import asr_inference_CV as jax_cv
    seen = {}
    monkeypatch.setattr(asr_inference_CV, "run_inference",
                        lambda args: seen.update(port=vars(args)))
    monkeypatch.setattr(jax_cv, "run_inference",
                        lambda args: seen.update(jax=vars(args)))
    argv = ["--ckpt_path", "x.ckpt", "--cv_dataset_name",
            "mozilla-foundation/common_voice_7_0", "--cv_lang", "de",
            "--cv_splits", "validation,test", "--hf_token", "tok123"]
    asr_inference_CV.main(argv)
    monkeypatch.setattr(sys, "argv", ["asr_inference_CV.py"] + argv)
    jax_cv.main()
    assert seen["port"] == seen["jax"]
    assert seen["port"]["data_val_split"] == "validation"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    man, _ = corpus(root, n=6, seed=11, lo=0.7, hi=1.4)
    nemo, _ = _cli_nemo(root)
    return root, man, str(nemo)


def _lines(out):
    return {m[1]: (float(m[2]), float(m[3]), int(m[4]))
            for m in LINE.finditer(out)}


KD = ["--use_logit_distillation", "true", "--use_flow_matching", "true",
      "--flow_steps", "2"]


def test_train_then_inference(run, capsys):
    root, man, nemo = run
    out_dir = root / "out"
    asr_train.main(["--train_manifest", man, "--val_manifest", man,
                    "--teacher_nemo", nemo, "--output_dir", str(out_dir),
                    "--epochs", "2", "--batch_size", "3", "--platform",
                    "cpu", *KD])
    trained = _lines(capsys.readouterr().out)
    assert set(trained) == {"val"} and trained["val"][2] == 6
    ckpt = out_dir / "run" / "checkpoints"
    for name in ("last", "student", "tokenizer.model",
                 "student_config.json"):
        assert (ckpt / name).is_file(), name
    base = ["--test_manifest", man, "--teacher_nemo", nemo, "--output_dir",
            str(out_dir), "--batch_size", "3", "--platform", "cpu"]
    asr_inference.main(["--ckpt_path", str(ckpt / "last"), *base, *KD])
    assert _lines(capsys.readouterr().out) == {
        "librispeech/test": trained["val"]}

    plain = asr_inference.main(["--ckpt_path", str(ckpt / "student"),
                                *base])
    packed = asr_inference.main(["--ckpt_path", str(ckpt / "student"),
                                 *base, "--packed_eval"])
    assert packed["test"]["wer"] == plain["test"]["wer"]
    np.testing.assert_allclose(packed["test"]["loss"],
                               plain["test"]["loss"], rtol=1e-5)
    assert len(LINE.findall(capsys.readouterr().out)) == 2


def test_fallback_tokenizer_sidecar(run, tmp_path, capsys):
    root, man, _ = run
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(yaml.safe_dump({
        "preprocessor": {"features": FEAT},
        "encoder": {"feat_in": FEAT, "n_layers": L, "d_model": D,
                    "n_heads": H, "conv_kernel_size": K},
        "decoder": {"feat_in": D, "num_classes": 30}}))
    asr_train.main(["--train_manifest", man, "--config", str(cfg),
                    "--output_dir", str(tmp_path), "--epochs", "1",
                    "--batch_size", "3", "--platform", "cpu"])
    assert "training fallback BPE" in capsys.readouterr().err
    ckpt = tmp_path / "run" / "checkpoints"
    saved = SentencePieceBPETokenizer.from_file(ckpt / "tokenizer.model")
    assert saved.vocab_size == 30
    other = tmp_path / "other.jsonl"
    other.write_text('{"audio_filepath": "%s", "duration": 1.0, '
                     '"text": "zz qq"}\n' % sorted(root.glob("*.wav"))[0])
    res = asr_inference.main(["--ckpt_path", str(ckpt / "last"),
                              "--test_manifest", str(other), "--config",
                              str(cfg), "--output_dir", str(tmp_path),
                              "--platform", "cpu"])
    assert res["test"]["num_utts"] == 1
    assert "training fallback BPE" not in capsys.readouterr().err


def test_other_entry_points_run(run, capsys):
    root, man, nemo = run
    common_args = ["--train_manifest", man, "--val_manifest", man,
                   "--teacher_nemo", nemo, "--epochs", "1", "--batch_size",
                   "3", "--platform", "cpu"]
    out = root / "diffm"
    asr_train_diffm.main(common_args + [
        "--output_dir", str(out), "--model_version", "ver5", "--latent_dim",
        "12", "--flow_steps", "2"])
    asr_inference_diffm.main([
        "--ckpt_path", str(out / "run" / "checkpoints" / "last"),
        "--test_manifest", man, "--teacher_nemo", nemo, "--output_dir",
        str(out), "--platform", "cpu", "--model_ver", "ver5",
        "--latent_dim", "12", "--flow_steps", "2", "--eval_data",
        "tedlium2"])
    asr_train_GS.main(common_args + [
        "--output_dir", str(root / "gs"), "--use_layerwise_distillation",
        "true", "--data_script_path", "./gigaspeech.py", "--teacher_int8"])
    asr_train_diffm_GS.main(common_args + [
        "--output_dir", str(root / "dgs"), "--model_version", "2",
        "--latent_dim", "12", "--flow_steps", "2", "--data_script_path",
        "./tedlium_asr.py"])
    asr_inference_CV.main([
        "--ckpt_path", str(root / "gs" / "run" / "checkpoints" / "student"),
        "--test_manifest", f"dev_clean={man},test_clean={man}",
        "--teacher_nemo", nemo, "--output_dir", str(root / "cv"),
        "--platform", "cpu"])
    lines = _lines(capsys.readouterr().out)
    assert {"val", "tedlium2/test", "commonvoice/dev_clean",
            "commonvoice/test_clean"} <= set(lines)
    assert lines["commonvoice/dev_clean"] == lines["commonvoice/test_clean"]
