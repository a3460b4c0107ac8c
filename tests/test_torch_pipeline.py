"""The port's data pipeline and text tools against the JAX package's, on
the CPU, from seeded numpy audio:

- the text normalizers and WER (edit distance, detail, per utterance, the
  accumulating metric, CER) on fixed strings: exactly equal;
- FLAC (written with tests/flac_writer.py: every subframe mode, stereo
  decorrelation, 24 bit, wasted bits) and NIST SPHERE (mono and stereo)
  decoded by the port's `load_audio` against JAX's `load_audio`, within
  1e-6 (bit-equal where both are exact);
- `make_dataloader` (shuffle, bucketing_batch_size as an int and a list,
  shards, pad_batch_to, two epochs, 4 worker threads, WAV and FLAC clips at
  16 kHz and a resampled 22.05 kHz one) and the tarred loader (two shards,
  two epochs) yield batches bit-equal to JAX's;
- the decode cache: a stale entry without its sidecar is decoded again by
  the port, while JAX's dataset still serves it (its pre-sidecar trust);
- the manifests read and written across the two packages, and
  build_manifest_from_hf on in-memory rows writing JAX's bytes for each
  corpus;
- the YAML reader (utils/yaml_subset.py) equal to `yaml.safe_load` on
  configs/conformer_ctc_small.yaml, on the configs of the `.nemo` fixtures
  of tests/test_cli.py and tests/test_nemo_real_format.py (vocabularies with
  '▁' and quotes included) and on crafted documents, and raising on what
  it does not read.
"""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import io
import tarfile

import numpy as np
import pytest
import yaml

import tpu_asr.config as JC
import tpu_asr.data.audio as jaudio
import tpu_asr.data.dataset as jds
import tpu_asr.data.manifest as jman
import tpu_asr.data.normalizers as jnorm
import tpu_asr.data.tarred as jtar
import tpu_asr.utils.wer as jwer
import tpu_asr_torch.config as PC
import tpu_asr_torch.data.audio as paudio
import tpu_asr_torch.data.dataset as pds
import tpu_asr_torch.data.manifest as pman
import tpu_asr_torch.data.normalizers as pnorm
import tpu_asr_torch.data.tarred as ptar
import tpu_asr_torch.utils.wer as pwer
from flac_writer import encode_flac
from tpu_asr.data.tokenizer import train_bpe as jax_train_bpe
from tpu_asr_torch.data.tokenizer import train_bpe
from tpu_asr_torch.utils.yaml_subset import safe_load

TEXTS = [
    "Hello, World!  It's “quoted” – okay… ",
    '"wrapped in quotes"', "men 's shoes",
    "ALL CAPS AND 123 numbers-with-hyphen",
    "français déjà vu ⁇ weird«»", "", "{COUGH} the <sil> talk {NOISE}",
    "<MUSIC> <NOISE>", "hello <COMMA> world <PERIOD>", "ends with a question?",
]


@pytest.mark.parametrize("fn", ["normalize_text_cv", "clean_tedlium_text",
                                "clean_text_commonvoice",
                                "strip_gigaspeech_tags",
                                "normalize_text_gigaspeech"])
def test_normalizers_match_jax(fn):
    for s in TEXTS:
        assert getattr(pnorm, fn)(s) == getattr(jnorm, fn)(s), repr(s)
        if fn == "normalize_text_cv":
            assert pnorm.normalize_text_cv(s, keep_punct=True) == \
                jnorm.normalize_text_cv(s, keep_punct=True), repr(s)


def test_wer_matches_jax():
    hyps = ["the cat sat on mat", "a dog", "", "hello world extra words",
            "speech is fun"]
    refs = ["the cat sat on the mat", "a dog ran", "nothing here",
            "hello world", "speech is fun"]
    for cer in (False, True):
        assert pwer.word_error_rate(hyps, refs, cer) == \
            jwer.word_error_rate(hyps, refs, cer)
        assert pwer.word_error_rate_detail(hyps, refs, cer) == \
            jwer.word_error_rate_detail(hyps, refs, cer)
        assert pwer.word_error_rate_per_utt(hyps, refs, cer) == \
            jwer.word_error_rate_per_utt(hyps, refs, cer)
        got, want = pwer.WERMetric(use_cer=cer), jwer.WERMetric(use_cer=cer)
        for m in (got, want):
            m.update(hyps[:2], refs[:2])
            m.update(hyps[2:], refs[2:])
        assert (got.scores, got.words, got.compute()) == \
            (want.scores, want.words, want.compute())
    for a, b in [("kitten", "sitting"), ("", "abc"), ("abc", "abc")]:
        assert pwer.edit_distance(a, b) == jwer.edit_distance(a, b)


def _pcm(n, bps, ch=1, seed=0):
    rng = np.random.default_rng(seed)
    lim = (1 << (bps - 1)) - 1
    t = np.arange(n)
    x = 0.5 * np.sin(2 * np.pi * 440 * t / 16000)[:, None] \
        + 0.1 * rng.normal(size=(n, ch))
    return np.clip(np.round(x * lim), -lim, lim).astype(np.int64)[:, :ch] \
        if ch > 1 else np.clip(np.round(x[:, 0] * lim), -lim, lim).astype(
            np.int64)


@pytest.mark.parametrize("kw", [
    dict(subframe_mode="constant"), dict(subframe_mode="verbatim"),
    dict(subframe_mode="fixed1"), dict(subframe_mode="fixed4"),
    dict(subframe_mode="lpc1"), dict(ch=2, stereo_mode="mid_side"),
    dict(ch=2, stereo_mode="left_side"), dict(bps=24),
    dict(wasted=2, partition_order=2)])
def test_flac_matches_jax(tmp_path, kw):
    kw = dict(kw)
    ch, bps = kw.pop("ch", 1), kw.get("bps", 16)
    n = 500 if bps == 24 else 3000     # 24-bit residuals decode slowly
    x = _pcm(n, bps, ch, seed=len(kw))
    if kw.get("subframe_mode") == "constant":
        x = np.full(n, -123, np.int64)
    if kw.get("wasted"):
        x = (x >> 2) << 2
    p = tmp_path / "a.flac"
    p.write_bytes(encode_flac(x, 16000, blocksize=512, **kw))
    got, want = paudio.load_audio(p), jaudio.load_audio(p)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    got22 = paudio.load_audio(p, 22050)
    np.testing.assert_allclose(got22, jaudio.load_audio(p, 22050), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("channels", [1, 2])
def test_sphere_matches_jax(tmp_path, channels):
    s = _pcm(1600 * channels, 16, seed=channels).astype("<i2")
    header = (f"NIST_1A\n   1024\nsample_rate -i 8000\nchannel_count -i "
              f"{channels}\nsample_coding -s3 pcm\nend_head\n").encode()
    p = tmp_path / "talk.sph"
    p.write_bytes(header + b" " * (1024 - len(header)) + s.tobytes())
    for sr in (8000, 16000):
        np.testing.assert_allclose(paudio.load_audio(p, sr),
                                   jaudio.load_audio(p, sr), rtol=0,
                                   atol=1e-6)


def _corpus(root, n=23, seed=0):
    """WAV clips of 0.2-3.9 s (every 7th at 22.05 kHz) and FLAC clips of
    0.2-0.6 s (every 5th; the port's decoder is pure Python), texts, and
    the manifest; returns (manifest path, entries)."""
    rng = np.random.default_rng(seed)
    words = ["the", "cat", "sat", "on", "a", "mat", "dog", "ran", "far"]
    entries = []
    for i in range(n):
        flac = i % 5 == 1
        dur = float(np.round(rng.uniform(0.2, 0.6 if flac else 3.9), 3))
        sr = 22050 if i % 7 == 3 else 16000
        x = np.clip(rng.normal(size=int(sr * dur)) * 0.1, -1, 1)
        if flac:
            p = root / f"u{i}.flac"
            p.write_bytes(encode_flac(np.round(x * 32767).astype(np.int64),
                                      sr, blocksize=1024))
        else:
            p = root / f"u{i}.wav"
            jaudio.write_wav(p, x.astype(np.float32), sr)
        text = " ".join(rng.choice(words, size=rng.integers(1, 6)))
        entries.append(jman.ManifestEntry(str(p), dur, text))
    man = root / "m.jsonl"
    jman.write_manifest(man, entries)
    return str(man), entries


def _tokenizers(entries):
    texts = [e.text for e in entries]
    tok, jtok = train_bpe(texts, 24), jax_train_bpe(texts, 24)
    assert list(tok.vocab) == list(jtok.vocab)
    return tok, jtok


def _equal_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k == "texts":
                assert g[k] == w[k]
            else:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("case", [
    dict(), dict(shuffle=False), dict(bucketing_batch_size=3),
    dict(bucketing_batch_size=[5, 4, 4, 3, 3, 2, 2, 2]),
    dict(num_shards=2, shard_index=1), dict(pad_batch_to=4, epoch=1),
    dict(drop_last=True, token_quantum=8)])
def test_dataloader_matches_jax(tmp_path, case):
    man, entries = _corpus(tmp_path)
    tok, jtok = _tokenizers(entries)
    case = dict(case)
    dcfg = {k: case.pop(k) for k in ("shuffle", "bucketing_batch_size")
            if k in case}
    kw = dict(batch_size=4, max_duration=4.0, **dcfg)
    for epoch in (case.pop("epoch", 0), 2):
        got = pds.make_dataloader(
            pds.AudioToBPEDataset(man, tok, max_duration=4.0),
            PC.DataConfig(**kw), epoch=epoch, **case)
        want = jds.make_dataloader(
            jds.AudioToBPEDataset(man, jtok, max_duration=4.0),
            JC.DataConfig(**kw), epoch=epoch, **case)
        _equal_batches(got, want)


def test_tarred_loader_matches_jax(tmp_path):
    man, entries = _corpus(tmp_path, n=12, seed=1)
    tok, jtok = _tokenizers(entries)
    wav = [e for e in entries if e.audio_filepath.endswith(".wav")]
    for shard in (0, 1):
        with tarfile.open(tmp_path / f"audio_{shard}.tar", "w") as tar:
            for e in wav[shard::2]:
                tar.add(e.audio_filepath,
                        arcname=e.audio_filepath.split("/")[-1])
    tman = tmp_path / "t.jsonl"
    jman.write_manifest(tman, [jman.ManifestEntry(
        e.audio_filepath.split("/")[-1], e.duration, e.text) for e in wav])
    shards = str(tmp_path / "audio_{0..1}.tar")
    for epoch in (0, 1):
        cfg = dict(batch_size=2, max_duration=4.0)
        got = ptar.make_tarred_dataloader(
            ptar.TarredAudioToBPEDataset(str(tman), shards, tok,
                                         max_duration=4.0),
            PC.DataConfig(**cfg), epoch=epoch)
        want = jtar.make_tarred_dataloader(
            jtar.TarredAudioToBPEDataset(str(tman), shards, jtok,
                                         max_duration=4.0),
            JC.DataConfig(**cfg), epoch=epoch)
        _equal_batches(got, want)


def test_pre_sidecar_cache_entry_is_decoded_again(tmp_path):
    man, entries = _corpus(tmp_path, n=2)
    tok, jtok = _tokenizers(entries)
    cache = tmp_path / "cache"
    port = pds.AudioToBPEDataset(man, tok, max_duration=4.0,
                                 decode_cache_dir=str(cache))
    true = np.array(port[0].signal)
    np.testing.assert_array_equal(port[0].signal, true)   # a fresh hit
    npy = [p for p in cache.glob("*.npy")]
    meta = [p for p in cache.glob("*.meta")]
    assert len(npy) == 1 and len(meta) == 1
    meta[0].unlink()                                     # pre-sidecar entry
    np.save(npy[0], np.zeros_like(true))                 # and stale
    jax_ds = jds.AudioToBPEDataset(man, jtok, max_duration=4.0,
                                   decode_cache_dir=str(cache))
    assert not np.any(jax_ds[0].signal)                  # JAX trusts it
    np.testing.assert_array_equal(port[0].signal, true)  # the port decodes
    assert len(list(cache.glob("*.meta"))) == 1          # and re-stamps


def test_manifests_across_packages(tmp_path):
    entries = [pman.ManifestEntry("a.wav", 1.5, "ein ▁ \"text\"",
                                  {"lang": "de"}),
               pman.ManifestEntry("b.flac", 0.25, "")]
    pman.write_manifest(tmp_path / "p.jsonl", entries)
    assert [vars(e) for e in jman.read_manifest(tmp_path / "p.jsonl")] == \
        [vars(e) for e in entries]
    jman.write_manifest(tmp_path / "j.jsonl", [
        jman.ManifestEntry(**vars(e)) for e in entries])
    assert (tmp_path / "j.jsonl").read_bytes() == \
        (tmp_path / "p.jsonl").read_bytes()
    assert [vars(e) for e in pman.read_manifest(tmp_path / "j.jsonl")] == \
        [vars(e) for e in entries]


def _hf_rows(tmp_path, corpus):
    """In-memory Hugging Face rows (tests/test_data.py's schema) over every
    rung of the path ladder: an existing audio.path, a `file` found under
    cache/extracted, an array written to a tmp WAV (named by `file`, then
    by `id`), a row with neither path nor array; durations around
    gigaspeech's 1 s floor; texts with tags, tag-only ones and a
    `sentence` field."""
    sr = 16000
    rng = np.random.default_rng(len(corpus))
    arr = lambda s: (0.1 * rng.normal(size=int(sr * s))).astype(np.float32)
    real = tmp_path / "audio" / "real.flac"
    real.parent.mkdir(parents=True, exist_ok=True)
    real.write_bytes(b"fLaC")
    found = tmp_path / "cache" / "extracted" / "x" / "deep.flac"
    found.parent.mkdir(parents=True, exist_ok=True)
    found.write_bytes(b"fLaC")
    texts = ["Hello {COUGH} <COMMA> World <sil> It's", "<MUSIC> <NOISE>",
             "a “quoted” clip – okay… <PERIOD>", "ALL CAPS 123",
             "short one", "français déjà vu?"]
    rows = [
        {"audio": {"path": str(real), "array": arr(1.5),
                   "sampling_rate": sr}, "text": texts[0]},
        {"audio": {"path": "gone/deep.flac", "array": arr(2.0),
                   "sampling_rate": sr}, "file": "deep.flac",
         "text": texts[1]},
        {"audio": {"path": None, "array": arr(1.25), "sampling_rate": sr},
         "file": "utt7.flac", "id": "u7", "text": texts[2]},
        {"audio": {"path": None, "array": arr(1.1), "sampling_rate": 8000},
         "id": "u8", "sentence": texts[3], "text": "ignored"},
        {"audio": {"path": None, "array": arr(0.5), "sampling_rate": sr},
         "id": "u9", "text": texts[4]},
        {"audio": {"path": None, "array": None}, "id": "u10",
         "text": texts[5]},
        {"audio": {"path": None, "array": arr(1.0), "sampling_rate": sr},
         "id": "u11", "sentence": texts[5]},
    ]
    return rows


@pytest.mark.parametrize("corpus", ["librispeech", "tedlium", "gigaspeech",
                                    "commonvoice"])
def test_build_manifest_from_hf_writes_jax_bytes(tmp_path, corpus):
    """build_manifest_from_hf on in-memory rows writes JAX's manifest byte
    for byte, and its tmp WAVs' bytes: each corpus's normalizer,
    gigaspeech's 1 s floor and tag-only skips, the path ladder. Both run
    in one cache directory, JAX's tmp WAVs removed before the port runs
    (a second writer of a name takes a random suffix)."""
    import shutil
    rows = _hf_rows(tmp_path, corpus)
    cache = tmp_path / "cache"
    out = {}
    for name, build in (("jax", jman.build_manifest_from_hf),
                        ("port", pman.build_manifest_from_hf)):
        man = tmp_path / f"{name}.jsonl"
        n = build(rows, str(man), str(cache), corpus=corpus)
        wavs = sorted(cache.glob("tmp_audio/**/*.wav"))
        out[name] = (n, man.read_bytes(),
                     [(w.relative_to(cache), w.read_bytes()) for w in wavs])
        shutil.rmtree(cache / "tmp_audio", ignore_errors=True)
    assert out["port"] == out["jax"]
    n, lines = out["port"][0], out["port"][1].decode().splitlines()
    assert n == len(lines) == (4 if corpus == "gigaspeech" else 6)
    with pytest.raises(ValueError, match="unknown corpus"):
        pman.build_manifest_from_hf(rows, str(tmp_path / "x"), str(cache),
                                    corpus="wsj")


def _fixture_configs():
    """The model_config.yaml dicts of tests/test_cli.py's `.nemo` and
    tests/test_nemo_real_format.py's NGC-layout `.nemo`."""
    tok = jax_train_bpe(["the quick brown fox", "jumps over the lazy dog",
                         "speech recognition distillation", "it's \"x\""]
                        * 4, vocab_size=40)
    cli = {"preprocessor": {"features": 24, "sample_rate": 16000},
           "encoder": {"feat_in": 24, "n_layers": 2, "d_model": 32,
                       "n_heads": 4, "conv_kernel_size": 7, "dropout": 0.0,
                       "dropout_pre_encoder": 0.0, "dropout_att": 0.0},
           "decoder": {"feat_in": 32, "num_classes": 32}}
    ngc = {
        "target": "nemo.collections.asr.models.ctc_bpe_models."
                  "EncDecCTCModelBPE",
        "sample_rate": 16000, "log_prediction": True,
        "train_ds": {"manifest_filepath": "/data/train.json",
                     "batch_size": 32, "shuffle": True},
        "validation_ds": {"manifest_filepath": "/data/dev.json"},
        "tokenizer": {"dir": None, "type": "bpe",
                      "model_path": "nemo:0123abcd_tokenizer.model"},
        "preprocessor": {"_target_": "nemo.collections.asr.modules."
                                     "AudioToMelSpectrogramPreprocessor",
                         "features": 24, "sample_rate": 16000,
                         "window_size": 0.025, "window_stride": 0.01,
                         "n_fft": 512, "dither": 1.0e-5},
        "spec_augment": {"freq_masks": 2, "time_masks": 10,
                         "time_width": 0.05},
        "encoder": {"feat_in": 24, "n_layers": 2, "d_model": 32,
                    "n_heads": 4, "conv_kernel_size": 7,
                    "subsampling": "striding", "subsampling_factor": 4,
                    "att_context_size": [-1, -1]},
        "decoder": {"feat_in": 32, "num_classes": 40,
                    "vocabulary": list(tok.vocab)},
        "optim": {"name": "adamw", "lr": 2.0, "betas": [0.9, 0.98],
                  "sched": {"name": "NoamAnnealing", "warmup_steps": 10000,
                            "min_lr": 1.0e-6, "last_epoch": None}},
        "missing": "???", "empty": {}, "none_list": [],
    }
    return cli, ngc


CRAFTED = [
    "# comment\na: 1  # trailing\nb:\n  - x\n  - 'it''s'\n  - \"q\\\"\\u2581\"\n",
    "a:\n- 1\n- - 2\n  - 3\n- k: v\n  j: [1, {x: y}]\nb: {}\nc: []\n",
    "x: yes\ny: Off\nz: ~\nw: .inf\nv: -.5e+3\nu: 1e-5\nt: 0\ns: +7\n",
    "long: a plain scalar\n  continued here\nq: 'folded\n\n  quote'\n",
    "k: 'a # not a comment'\nurl: http://x.y/z#frag\n",
]


def test_yaml_reader_matches_pyyaml():
    with open("configs/conformer_ctc_small.yaml") as f:
        text = f.read()
    assert safe_load(text) == yaml.safe_load(text)
    for cfg in _fixture_configs():
        for flow in (False, None):
            for uni in (True, False):
                text = yaml.safe_dump(cfg, default_flow_style=flow,
                                      allow_unicode=uni)
                assert safe_load(text) == yaml.safe_load(text)
                assert safe_load(io.StringIO(text)) == cfg
    for text in CRAFTED:
        assert safe_load(text) == yaml.safe_load(text), text


@pytest.mark.parametrize("text", [
    "a: &x 1\nb: *x\n", "a: !!str 1\n", "a: |\n  block\n", "a: >\n  fold\n",
    "a: 0x1F\n", "a: 0755\n", "a: 2001-12-14\n", "a: 1:30\n",
    "%YAML 1.1\n---\na: 1\n", "a: 1\n---\nb: 2\n", "a: [1, 2\n",
    "a:\n\tb: 1\n"])
def test_yaml_reader_refuses(text):
    with pytest.raises(ValueError):
        safe_load(text)
