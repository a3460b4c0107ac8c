"""The port's serving artifact (tpu_asr_torch/convert/export.py:
torch.export of each bucket's eval program, the serving kernels as
`tpu_asr_torch::` custom ops) against the JAX package's
(tpu_asr/convert/export.py, jax.export), on the CPU, on one set of seeded
weights carried by the bridge (convert/from_jax.py).

The model is tests/test_export.py's: 2 layers, d32, 4 heads, 24 mels, a
BPE of 32 pieces, buckets (2, 0.2 s) and (2, 0.4 s). Tolerances: the
bucket program's log-probs within 1e-4 of JAX's (fp32), lengths and texts
equal. The custom ops themselves: tests/test_torch_export_ops.py."""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import io
import json
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_asr.config as JC
import tpu_asr_torch.config as pconfig
from tests.test_torch_streaming import seeded_params
from tpu_asr.convert.export import export_inference as jax_export
from tpu_asr.convert.export import load_exported as jax_load
from tpu_asr.data.tokenizer import train_bpe
from tpu_asr.models.ctc_model import CTCModel as JaxCTCModel
from tpu_asr_torch.convert.export import (ExportedTranscriber,
                                          export_inference, load_exported)
from tpu_asr_torch.convert.from_jax import jax_to_state_dict
from tpu_asr_torch.data.tokenizer import SentencePieceBPETokenizer
from tpu_asr_torch.models.ctc_model import CTCModel
from tpu_asr_torch.models.transcribe import Transcriber

FEAT, D_MODEL, LAYERS, HEADS = 24, 32, 2, 4
BUCKETS = [(2, 0.2), (2, 0.4)]
ENC = dict(feat_in=FEAT, n_layers=LAYERS, d_model=D_MODEL, n_heads=HEADS,
           conv_kernel_size=7, dropout=0.0, dropout_pre_encoder=0.0,
           dropout_att=0.0)


def _cfg(pkg, tok, **enc):
    return pkg.ModelConfig(
        preprocessor=pkg.PreprocessorConfig(features=FEAT),
        spec_augment=None, encoder=pkg.EncoderConfig(**{**ENC, **enc}),
        decoder=pkg.DecoderConfig(feat_in=D_MODEL,
                                  num_classes=tok.vocab_size),
        compute_dtype="float32")


def _signals(lens=(1400, 2500, 4700, 900, 6000), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(scale=0.1, size=n).astype(np.float32) for n in lens]


CROSSING = _signals((1400, 4700), seed=2)   # bucket 0 (3200), bucket 1 (6400)


def _bucket_inputs(bs, pad):
    sig = np.random.default_rng(bs + pad).normal(
        scale=0.1, size=(bs, pad)).astype(np.float32)
    return sig, np.asarray([pad, pad // 2], np.int32)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The port's model and tokenizer, its artifact and JAX's, and what
    JAX's loaded artifact gives: texts of `_signals()` and of CROSSING, and
    each bucket program's (log_probs, encoded_len) on `_bucket_inputs`."""
    tok = train_bpe(["a quick brown fox", "jumps over lazy dogs"] * 3,
                    vocab_size=32)
    cfg = _cfg(JC, tok)
    jmodel = JaxCTCModel(cfg)
    v = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 1600)),
        jnp.asarray([1600], jnp.int32)))
    params = seeded_params(v["params"], np.random.default_rng(0))
    head = params["decoder"]["decoder_layers_0"]   # varied tokens: texts
    head["kernel"] = np.random.default_rng(5).normal(
        size=head["kernel"].shape).astype(np.float32)
    rng = np.random.default_rng(1)
    bn = v["batch_stats"]["encoder"]["layers"]["conv"]["batch_norm"]
    stats = {"encoder": {"layers": {"conv": {"batch_norm": {
        "mean": rng.uniform(-0.3, 0.3, bn["mean"].shape).astype(np.float32),
        "var": rng.uniform(0.7, 1.5, bn["var"].shape).astype(np.float32)}}}}}
    variables = {"params": params, "batch_stats": stats}
    port = CTCModel(_cfg(pconfig, tok)).eval()
    port.load_state_dict(jax_to_state_dict(params, stats, cfg), strict=True)
    ptok = SentencePieceBPETokenizer.from_bytes(tok.serialized_proto())
    tmp = tmp_path_factory.mktemp("exp")
    art = export_inference(port, ptok, tmp / "port.tasrx", buckets=BUCKETS,
                           device="cpu")
    jart = jax_export(jmodel, variables, tok, tmp / "jax.tasrx",
                      buckets=BUCKETS)
    jex = jax_load(jart)
    jax_out = {"texts": jex.transcribe(_signals()),
               "crossing": jex.transcribe(CROSSING),
               "programs": [tuple(np.asarray(z) for z in prog.call(
                   *_bucket_inputs(e["batch_size"], e["pad_samples"])))
                   for e, prog in jex.buckets]}
    return dict(tok=tok, port=port, ptok=ptok, art=art, jart=jart,
                jax=jax_out)


@pytest.fixture(scope="module")
def loaded(models):
    """The port's artifact, loaded once (torch.export.load takes seconds a
    program)."""
    return load_exported(models["art"])


def _transcriber(models):
    return Transcriber(models["port"], models["ptok"], batch_size=2,
                       bucket_seconds=0.2, device="cpu")


def test_artifact_text_equals_transcriber_and_jax(models, loaded):
    """ExportedTranscriber's texts == the port's Transcriber's == JAX's
    loaded artifact's, on clips of both buckets (4700 and 6000 samples
    take the 0.4 s one)."""
    sigs = _signals()
    assert isinstance(loaded, ExportedTranscriber)
    got = loaded.transcribe(sigs)
    assert got == _transcriber(models).transcribe(sigs) == \
        models["jax"]["texts"]
    assert all(got)


def test_no_crop_across_bucket_boundary(models, loaded):
    """A short and a long clip never share the short bucket (JAX's
    tests/test_export.py case): 1400 samples fit bucket 0 (3200), 4700
    only bucket 1 (6400)."""
    assert loaded._pick(1400) != loaded._pick(4700)
    assert loaded.transcribe(CROSSING) == \
        _transcriber(models).transcribe(CROSSING) == \
        models["jax"]["crossing"]


def test_program_log_probs_match_jax(models, loaded):
    """Each bucket program's log-probs within 1e-4 of JAX's program's, on
    a full and a half-length row; encoded lengths equal."""
    for (entry, prog), (want_lp, want_len) in zip(
            loaded.buckets, models["jax"]["programs"], strict=True):
        sig, ln = _bucket_inputs(entry["batch_size"], entry["pad_samples"])
        with torch.no_grad():
            lp, enc_len = prog(torch.from_numpy(sig), torch.from_numpy(ln))
        np.testing.assert_array_equal(enc_len.numpy(), want_len)
        np.testing.assert_allclose(lp.numpy(), want_lp, rtol=1e-4,
                                   atol=1e-4)


def test_manifest_has_jax_keys_and_tokenizer(models, loaded):
    art, jart = models["art"], models["jart"]
    with tarfile.open(art) as t, tarfile.open(jart) as j:
        m = json.loads(t.extractfile("manifest.json").read())
        jm = json.loads(j.extractfile("manifest.json").read())
        assert sorted(t.getnames()) == ["manifest.json", "program_0.pt2",
                                        "program_1.pt2", "tokenizer.model"]
        assert t.extractfile("tokenizer.model").read() == \
            j.extractfile("tokenizer.model").read()
    assert m.keys() == jm.keys()
    assert [b.keys() for b in m["buckets"]] == [b.keys()
                                                for b in jm["buckets"]]
    for k in m:
        if k not in ("platforms", "buckets"):
            assert m[k] == jm[k], k
    assert [(b["batch_size"], b["seconds"], b["pad_samples"])
            for b in m["buckets"]] == [(b["batch_size"], b["seconds"],
                                        b["pad_samples"])
                                       for b in jm["buckets"]]
    assert m["platforms"] == ["cpu"]
    assert list(loaded.tokenizer.vocab) == \
        list(models["tok"].vocab)


def test_loader_rejects_newer_format(models, tmp_path):
    art = models["art"]
    new = tmp_path / "future.tasrx"
    with tarfile.open(art) as src, tarfile.open(new, "w") as dst:
        for mem in src.getmembers():
            data = src.extractfile(mem).read()
            if mem.name == "manifest.json":
                obj = json.loads(data)
                obj["format_version"] = 999
                data = json.dumps(obj).encode()
            ti = tarfile.TarInfo(mem.name)
            ti.size = len(data)
            dst.addfile(ti, io.BytesIO(data))
    with pytest.raises(ValueError, match="newer"):
        load_exported(new)
