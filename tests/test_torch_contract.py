"""Contracts of the PyTorch port that hold without a GPU:

- no tpu_asr_torch module, and nothing chip_smoke.py imports, loads JAX,
  flax or the JAX package tpu_asr (the machine with the card has neither;
  the port keeps its own copies of the host code it needs);
- the port's config dataclasses have the JAX package's defaults, and its
  BPE trainer gives the JAX tokenizer's ids;
- the entry points (Transcriber, PackedTranscriber, ChunkedTranscriber,
  CacheAwareStreamer) run on the card unless told otherwise;
- chip_smoke.py refuses to run without a CUDA device and never prints its
  success line there;
- on CPU tensors the kernel wrappers run their plain versions: a CPU
  forward (also int8 with the conv kernel route), streaming step, student
  train step or KD train step (also with an int8 teacher) launches nothing
  and builds nothing;
- the eval-only wrappers (int8 FFN, conv module) refuse autograd;
- EncoderConfig options outside the port's slice raise;
- the CLIs (tpu_asr_torch/cli/): importing every module and running each
  entry point's --help loads none of jax, jaxlib, flax, tpu_asr, optax,
  orbax, yaml and datasets (the machine with the card has none of them);
  without a CUDA device and without --platform cpu they exit with an
  error; a --resume_ckpt that names no file exits naming it, and so does
  building Hugging Face manifests without the `datasets` package or
  without the dataset script;
- the copies of JAX host code that must stay the same: data/codecs.py is
  byte-equal to tpu_asr/data/codecs.py (the native C copies are held to
  theirs by the bit-equality tests of tests/test_torch_native.py);
- a CPU export of the serving artifact (convert/export.py) launches and
  builds nothing, its graph holds no custom op, and the export, codec and
  native modules load nothing of JAX (the fresh process that loads an
  artifact: tests/test_torch_export_cli.py);
- the data-parallel modules (tpu_asr_torch/parallel/) load none of JAX,
  flax or tpu_asr either.
"""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import ast
import dataclasses
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tpu_asr.config as jax_config
import tpu_asr_torch.config as port_config
from tpu_asr.config import DecoderConfig, EncoderConfig, ModelConfig
from tpu_asr.data.tokenizer import train_bpe as jax_train_bpe
from tpu_asr_torch.data.tokenizer import train_bpe
from tpu_asr_torch.models.conformer import ConformerEncoder
from tpu_asr_torch.models.ctc_model import CTCModel
from tpu_asr_torch.models.distil_model import DistilCTCModel
from tpu_asr_torch.models.streaming import CacheAwareStreamer
from tpu_asr_torch.models.transcribe import (ChunkedTranscriber,
                                             PackedTranscriber, Transcriber)
from tpu_asr_torch.ops import _kernels
from tpu_asr_torch.ops.cuda_attention import (
    fused_relpos_attention, fused_relpos_attention_block,
    fused_relpos_attention_block_bwd, fused_relpos_attention_bwd)
from tpu_asr_torch.ops.cuda_conv import fused_conv_module
from tpu_asr_torch.ops.cuda_ctc import ctc_nll, ctc_nll_bwd
from tpu_asr_torch.ops.cuda_features import fused_logmel
from tpu_asr_torch.ops.cuda_ffn import (fused_ffn_sublayer,
                                        fused_ffn_sublayer_bwd,
                                        fused_ffn_sublayer_int8)
from tpu_asr_torch.ops.cuda_fm import fused_fm_euler, fused_fm_euler_bwd
from tpu_asr_torch.ops.cuda_layer import fused_conformer_layer, layer_params
from tpu_asr_torch.ops.cuda_subsampling import fused_subsampling
from tpu_asr_torch.train.trainer import (DistilTrainState,
                                         make_distil_train_step)

ROOT = Path(__file__).resolve().parent.parent
WRAPPERS = (fused_logmel, fused_subsampling, fused_relpos_attention_block,
            fused_relpos_attention_block_bwd, fused_ffn_sublayer,
            fused_ffn_sublayer_bwd, fused_ffn_sublayer_int8,
            fused_conv_module, ctc_nll, ctc_nll_bwd, fused_fm_euler,
            fused_fm_euler_bwd, fused_relpos_attention,
            fused_relpos_attention_bwd, fused_conformer_layer)
IMPORT_ALL = """
import importlib, pkgutil, sys
import tpu_asr_torch
names = [m.name for m in pkgutil.walk_packages(tpu_asr_torch.__path__,
                                               "tpu_asr_torch.")]
names += sys.argv[1:]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "tpu_asr"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def _chip_smoke_imports():
    """chip_smoke itself and every module its source imports, at top level
    or inside a function."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    mods = {"chip_smoke"}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module != "__future__":
            mods.add(node.module)
        elif isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
    return sorted(mods)


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT), **extra)
    env.pop("XLA_FLAGS", None)
    return env


def test_port_imports_no_jax():
    extra = _chip_smoke_imports()
    assert "tpu_asr_torch.train.trainer" in extra
    proc = subprocess.run([sys.executable, "-c", "import json" + IMPORT_ALL,
                           *extra], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120,
                          check=True)
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("tpu_asr_torch.models.transcribe",
                 "tpu_asr_torch.convert.from_jax", "tpu_asr_torch.config",
                 "tpu_asr_torch.data.tokenizer", "tpu_asr_torch.data.audio",
                 "tpu_asr_torch.data.packing",
                 "tpu_asr_torch.train.trainer", "tpu_asr_torch.kd.schedules",
                 "tpu_asr_torch.kd.losses", "tpu_asr_torch.kd.meta_encoders",
                 "tpu_asr_torch.kd.flow_matching",
                 "tpu_asr_torch.ops.cuda_fm", "tpu_asr_torch.ops.quant",
                 "tpu_asr_torch.ops.cuda_conv", "tpu_asr_torch.ops.cuda_layer",
                 "tpu_asr_torch.ops.positions",
                 "tpu_asr_torch.models.streaming",
                 "tpu_asr_torch.models.vocab", "tpu_asr_torch.ops.decoding",
                 "tpu_asr_torch.ops.confidence",
                 "tpu_asr_torch.ops.beam_search",
                 "tpu_asr_torch.ops.ngram_lm",
                 "tpu_asr_torch.parallel.mesh",
                 "tpu_asr_torch.parallel.launch",
                 "tpu_asr_torch.parallel.sharding",
                 "tpu_asr_torch.parallel.pipeline",
                 "tpu_asr_torch.convert.export", "tpu_asr_torch.data.codecs",
                 "tpu_asr_torch.native", "chip_smoke"):
        assert name in out["modules"]
    assert "tpu_asr_torch.host" not in out["modules"]
    assert out["bad"] == []


@pytest.mark.parametrize("name", [
    n for n, obj in vars(jax_config).items()
    if dataclasses.is_dataclass(obj) and isinstance(obj, type)])
def test_config_defaults_equal_jax(name):
    assert dataclasses.asdict(getattr(port_config, name)()) == \
        dataclasses.asdict(getattr(jax_config, name)())


def test_student_config_equals_jax():
    assert dataclasses.asdict(port_config.make_student_config(
        port_config.ModelConfig())) == dataclasses.asdict(
        jax_config.make_student_config(jax_config.ModelConfig()))


def test_train_bpe_gives_jax_ids():
    corpus = ["the quick brown fox jumps over the lazy dog",
              "speech recognition on a graphics card",
              "connectionist temporal classification"] * 3
    got, want = train_bpe(corpus, vocab_size=48), jax_train_bpe(corpus,
                                                              vocab_size=48)
    for text in corpus[:3] + ["a lazy card jumps"]:
        ids = got.text_to_ids(text)
        assert ids == want.text_to_ids(text)
        assert got.ids_to_text(ids) == want.ids_to_text(ids)
    assert got.vocab_size == want.vocab_size


def test_transcriber_defaults_to_cuda():
    for cls in (Transcriber, PackedTranscriber, ChunkedTranscriber,
                CacheAwareStreamer):
        sig = inspect.signature(cls.__init__)
        assert sig.parameters["device"].default == "cuda"


def test_entry_points_raise_without_a_card():
    """Without a CUDA device and without device="cpu" each serving entry
    point raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    enc = port_config.EncoderConfig(
        n_layers=1, d_model=32, n_heads=2, conv_kernel_size=7,
        causal_downsampling=True, conv_context_size="causal",
        att_context_style="chunked_limited", att_context_size=(8, 3))
    cfg = port_config.ModelConfig(
        encoder=enc, decoder=port_config.DecoderConfig(feat_in=32,
                                                       num_classes=16))
    tok = train_bpe(["a b c"], vocab_size=8)
    for make in (lambda m: Transcriber(m, tok),
                 lambda m: PackedTranscriber(m, tok),
                 lambda m: ChunkedTranscriber(m, tok),
                 lambda m: CacheAwareStreamer(m, tok)):
        with pytest.raises((AssertionError, RuntimeError)):
            make(CTCModel(cfg))


def test_cpu_stream_step_launches_and_builds_nothing():
    """A streaming session on CPU tensors (the featurizer, then cached
    steps) runs the plain versions: nothing launched, nothing built."""
    enc = port_config.EncoderConfig(
        n_layers=2, d_model=32, n_heads=2, conv_kernel_size=7,
        causal_downsampling=True, conv_context_size="causal",
        att_context_style="chunked_limited", att_context_size=(8, 3))
    cfg = port_config.ModelConfig(
        spec_augment=None, encoder=enc,
        decoder=port_config.DecoderConfig(feat_in=32, num_classes=16),
        compute_dtype="float32")
    torch.manual_seed(0)
    streamer = CacheAwareStreamer(CTCModel(cfg), device="cpu")
    ids = streamer.stream(np.random.default_rng(0).normal(
        size=8000).astype(np.float32) * 0.1, return_ids=True)
    assert len(ids) == 13 and all(0 <= i <= 16 for i in ids)
    assert all(w.launches == 0 for w in WRAPPERS)
    assert _kernels.library.cache_info().currsize == 0


def test_cpu_train_step_launches_and_builds_nothing():
    cfg = port_config.ModelConfig(
        encoder=port_config.EncoderConfig(n_layers=1, d_model=32, n_heads=2,
                                          conv_kernel_size=7),
        decoder=port_config.DecoderConfig(feat_in=32, num_classes=16),
        compute_dtype="float32")
    torch.manual_seed(0)
    model = DistilCTCModel(cfg, cfg)
    state = DistilTrainState.create(model, port_config.OptimConfig())
    batch = {"signal": torch.randn(2, 8000), "signal_len":
             torch.tensor([8000, 5000]),
             "tokens": torch.randint(0, 16, (2, 4)),
             "token_len": torch.tensor([4, 2])}
    state, metrics = make_distil_train_step(model)(state, batch, 0)
    assert torch.isfinite(metrics["loss/total"]) and state.step == 1
    assert all(w.launches == 0 for w in WRAPPERS)
    assert _kernels.library.cache_info().currsize == 0


def test_cpu_kd_train_step_launches_and_builds_nothing():
    """The flowkd step (frozen teacher, logit KD, FM over all layers) on CPU
    tensors runs every wrapper's plain version."""
    _cpu_kd_step("none")


def test_cpu_int8_teacher_kd_step_launches_and_builds_nothing():
    """The same with the teacher's FFNs in int8."""
    _cpu_kd_step("int8")


def _cpu_kd_step(quantization):
    teacher = port_config.ModelConfig(
        encoder=port_config.EncoderConfig(n_layers=2, d_model=64, n_heads=4,
                                          conv_kernel_size=7),
        decoder=port_config.DecoderConfig(feat_in=64, num_classes=16),
        compute_dtype="float32")
    student = port_config.make_student_config(teacher)
    teacher = dataclasses.replace(teacher, encoder=dataclasses.replace(
        teacher.encoder, quantization=quantization))
    flow = port_config.FlowMatchingConfig(
        student_dim=32, teacher_dim=64, time_embed_dim=8, hidden_dim=16,
        training_sampling=2)
    distill = port_config.DistillationConfig(
        use_logit_distillation=True, use_flow_matching=True, flow=flow)
    torch.manual_seed(0)
    model = DistilCTCModel(student, teacher, distill)
    state = DistilTrainState.create(model, port_config.OptimConfig())
    batch = {"signal": torch.randn(2, 8000), "signal_len":
             torch.tensor([8000, 5000]),
             "tokens": torch.randint(0, 16, (2, 4)),
             "token_len": torch.tensor([4, 2])}
    state, metrics = make_distil_train_step(model)(state, batch, 0)
    assert {"loss/ctc", "loss/flow_matching", "loss/logit_kd",
            "loss/total"} <= set(metrics)
    assert all(torch.isfinite(v) for v in metrics.values())
    assert not model.teacher.training
    assert all(w.launches == 0 for w in WRAPPERS)
    assert _kernels.library.cache_info().currsize == 0


def test_chip_smoke_fails_without_cuda():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=_env(CUDA_VISIBLE_DEVICES=""),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_cpu_forward_launches_and_builds_nothing():
    cfg = ModelConfig(spec_augment=None,
                      encoder=EncoderConfig(n_layers=1, d_model=32, n_heads=2,
                                            conv_kernel_size=7),
                      decoder=DecoderConfig(feat_in=32, num_classes=16),
                      compute_dtype="float32")
    model = CTCModel(cfg).eval()
    sig = torch.randn(2, 8000, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = model(sig, torch.tensor([8000, 5000]))
    assert out.log_probs.shape[:2] == out.greedy.shape
    assert torch.isfinite(out.log_probs).all()
    assert all(w.launches == 0 for w in WRAPPERS)
    assert _kernels.library.cache_info().currsize == 0
    assert _kernels.library_path().parent.parent == _kernels.BUILD_ROOT
    assert all(k.startswith(("encoder.", "decoder."))
               for k in model.state_dict())


@pytest.mark.parametrize("option", [
    {"conv_norm_type": "layer_norm"}, {"conv_context_size": "causal"},
    {"quantization": "int8", "conv_backend": "pallas"},
    {"quantization": "int8", "ffn_backend": "pallas",
     "conv_norm_type": "layer_norm", "conv_context_size": "causal"},
])
def test_cpu_forward_with_slice_4_options_launches_nothing(option):
    """int8 serving, the conv kernel route, layer-norm and causal conv
    modules run on CPU tensors through the plain versions."""
    cfg = ModelConfig(spec_augment=None,
                      encoder=dataclasses.replace(EncoderConfig(
                          n_layers=1, d_model=32, n_heads=2,
                          conv_kernel_size=7), **option),
                      decoder=DecoderConfig(feat_in=32, num_classes=16),
                      compute_dtype="float32")
    model = CTCModel(cfg).eval()
    sig = torch.randn(2, 8000, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = model(sig, torch.tensor([8000, 5000]))
    assert torch.isfinite(out.log_probs).all()
    assert all(w.launches == 0 for w in WRAPPERS)
    assert _kernels.library.cache_info().currsize == 0


@pytest.mark.parametrize("wrapper", ["ffn_int8", "conv_module",
                                     "conformer_layer"])
def test_eval_only_wrappers_refuse_autograd(wrapper):
    x = torch.randn(1, 6, 8, requires_grad=True)
    if wrapper == "conformer_layer":
        from tpu_asr_torch.models.conformer import ConformerLayer
        prm = layer_params(ConformerLayer(port_config.EncoderConfig(
            d_model=8, n_heads=2, conv_kernel_size=3)))
        call = lambda: fused_conformer_layer(
            x, torch.ones(1, 6, dtype=torch.bool), prm, 2, 3, 1, "affine")
    elif wrapper == "ffn_int8":
        call = lambda: fused_ffn_sublayer_int8(
            x, torch.ones(8), torch.zeros(8), torch.randn(32, 8),
            torch.zeros(32), torch.randn(8, 32), torch.zeros(8))
    else:
        call = lambda: fused_conv_module(
            x, torch.ones(1, 6, dtype=torch.bool), torch.randn(16, 8),
            torch.zeros(16), torch.randn(8, 3), torch.zeros(8), torch.ones(8),
            torch.zeros(8), torch.randn(8, 8), torch.zeros(8), (1, 1))
    with pytest.raises(RuntimeError, match="no gradient"):
        call()
    with torch.no_grad():
        assert call().shape == x.shape


@pytest.mark.parametrize("option", [
    {"subsampling": "vggnet"}, {"subsampling_factor": 3},
    {"self_attention_model": "abs_pos"},
    {"conv_norm_type": "group_norm"}, {"quantization": "int4"},
    {"conv_backend": "triton"}, {"attention_backend": "triton"},
])
def test_options_outside_the_slice_raise(option):
    cfg = dataclasses.replace(EncoderConfig(n_layers=1, d_model=32,
                                            n_heads=2), **option)
    with pytest.raises(ValueError, match="does not implement"):
        ConformerEncoder(cfg)


@pytest.mark.parametrize("option", [
    {"att_context_style": "chunked_limited", "att_context_size": (8, 3)},
    {"att_context_size": (8, 8), "global_tokens": 2},
])
def test_pallas_attention_refuses_chunked_and_global(option):
    """As JAX: the block kernel implements the 'regular' window alone, so
    attention_backend='pallas' refuses the chunked and global routes,
    which 'auto' runs plain."""
    cfg = dataclasses.replace(EncoderConfig(
        n_layers=1, d_model=32, n_heads=2, attention_backend="pallas"),
        **option)
    enc = ConformerEncoder(cfg)
    feats, lens = torch.randn(1, 80, 40), torch.tensor([40])
    with pytest.raises(ValueError, match="attention_backend='pallas'"):
        enc(feats, lens)
    for layer in enc.layers:
        layer.self_attn.backend = "auto"
    assert torch.isfinite(enc(feats, lens)[0]).all()


CLI_ENTRY = ("asr_train", "asr_train_GS", "asr_train_diffm",
             "asr_train_diffm_GS", "asr_inference", "asr_inference_CV",
             "asr_inference_diffm")
CLI_HELP = """
import contextlib, importlib, io, json, pkgutil, sys
import tpu_asr_torch.cli
for m in pkgutil.walk_packages(tpu_asr_torch.cli.__path__,
                               "tpu_asr_torch.cli."):
    importlib.import_module(m.name)
codes = []
for name in sys.argv[1:]:
    mod = importlib.import_module("tpu_asr_torch.cli." + name)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        try:
            mod.main(["--help"])
        except SystemExit as e:
            codes.append((e.code, "--platform" in out.getvalue()))
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "tpu_asr", "optax", "orbax", "yaml",
    "datasets"))
print(json.dumps({"codes": codes, "bad": bad}))
"""


def test_cli_help_loads_no_jax_yaml_or_datasets():
    proc = subprocess.run([sys.executable, "-c", CLI_HELP, *CLI_ENTRY],
                          cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=120, check=True)
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["codes"] == [[0, True]] * len(CLI_ENTRY)
    assert out["bad"] == []
    proc = subprocess.run([sys.executable, "-m", "tpu_asr_torch.cli.asr_train",
                           "--help"], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "--teacher_int8" in proc.stdout


@pytest.mark.parametrize("entry", ["asr_train", "asr_inference"])
def test_cli_without_cuda_exits(monkeypatch, entry):
    import importlib
    mod = importlib.import_module(f"tpu_asr_torch.cli.{entry}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--test_manifest", "none.jsonl", "--ckpt_path", "none"] \
        if entry == "asr_inference" else ["--train_manifest", "none.jsonl"]
    with pytest.raises(SystemExit, match="no CUDA device"):
        mod.main(argv)


@pytest.mark.parametrize("entry,flags,what", [
    ("asr_train", ["--resume_ckpt", "no/such/last"],
     "no/such/last: no such checkpoint"),
])
def test_cli_refused_flags_exit(entry, flags, what):
    import importlib
    mod = importlib.import_module(f"tpu_asr_torch.cli.{entry}")
    with pytest.raises(SystemExit, match=what):
        mod.main(flags + ["--platform", "cpu", "--train_manifest", "t.jsonl"])


def test_cli_refuses_hugging_face_manifests(monkeypatch, tmp_path):
    """Without explicit manifests the CLI builds them from the Hugging Face
    dataset script: it exits naming `datasets` where that package does not
    import (here made so), and naming the script where its file is
    missing. Nothing is downloaded."""
    from tpu_asr_torch.cli import asr_train
    monkeypatch.setitem(sys.modules, "datasets", None)
    script = tmp_path / "librispeech_asr.py"
    script.write_text("")
    with pytest.raises(SystemExit, match="needs the `datasets` package"):
        asr_train.main(["--platform", "cpu", "--data_script_path",
                        str(script), "--data_dir", str(tmp_path)])
    with pytest.raises(SystemExit,
                       match="--data_script_path .*no_such.py: no such file"):
        asr_train.main(["--platform", "cpu", "--data_script_path",
                        str(tmp_path / "no_such.py")])


def test_codecs_copy_is_byte_equal():
    assert (ROOT / "tpu_asr_torch" / "data" / "codecs.py").read_bytes() == \
        (ROOT / "tpu_asr" / "data" / "codecs.py").read_bytes()


def test_cpu_export_launches_and_builds_nothing(monkeypatch, tmp_path):
    """export_inference and the loaded program on the CPU run the plain
    versions: no launch, no build (a build would raise here), and no
    `tpu_asr_torch::` op in the graph."""
    from tpu_asr_torch.convert.export import export_inference, load_exported

    def no_build():
        raise AssertionError("a CPU export built the kernels")
    monkeypatch.setattr(_kernels, "build", no_build)
    cfg = ModelConfig(spec_augment=None,
                      encoder=EncoderConfig(n_layers=1, d_model=32, n_heads=2,
                                            conv_kernel_size=7,
                                            quantization="int8",
                                            conv_backend="pallas"),
                      decoder=DecoderConfig(feat_in=32, num_classes=16),
                      compute_dtype="float32")
    art = export_inference(CTCModel(cfg), None, tmp_path / "a.tasrx",
                           buckets=[(2, 0.25)], device="cpu")
    ex = load_exported(art)
    prog = ex.buckets[0][1]
    assert not any(str(n.target).startswith(_kernels.OPS)
                   for n in prog.graph.nodes)
    sig = torch.randn(2, 4000, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        lp, _ = prog(sig, torch.tensor([4000, 2500], dtype=torch.int32))
    assert torch.isfinite(lp).all()
    assert all(w.launches == 0 for w in WRAPPERS)
    assert _kernels.library.cache_info().currsize == 0
