"""The port's compressed-audio decode: tpu_asr_torch/data/codecs.py (a
byte-for-byte copy of tpu_asr/data/codecs.py, held so in
tests/test_torch_contract.py) and its routes in the port's read_audio /
load_audio, against the JAX package's, on the CPU. Fixtures are encoded
here with the image's libmp3lame and libopus (no binary files); each test
skips with JAX's HAVE_* guards (tests/test_codecs.py) where a library is
missing. Decoded PCM is bit-equal to JAX's, file routes included; a
missing decoder library raises, naming it, and nothing decodes in its
place."""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import numpy as np
import pytest

import tpu_asr.data.audio as jaudio
from tpu_asr.data import codecs as jcodecs
from tpu_asr_torch.data import audio as paudio
from tpu_asr_torch.data import codecs

MP3 = pytest.mark.skipif(not (codecs.HAVE_MP3 and codecs.HAVE_MP3_ENCODE),
                         reason="libmpg123/libmp3lame missing")
OPUS = pytest.mark.skipif(not codecs.HAVE_OPUS, reason="libopus missing")


def _speech_like(sr: int, seconds: float, seed: int = 0) -> np.ndarray:
    """tests/test_codecs.py's band-limited multi-tone burst."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    x = sum(a * np.sin(2 * np.pi * f * t + p) for a, f, p in
            zip([0.3, 0.2, 0.15, 0.1], [220.0, 447.0, 991.0, 1723.0],
                rng.uniform(0, 2 * np.pi, 4)))
    env = np.minimum(1.0, 10.0 * t) * np.minimum(1.0, 10.0 * (t[-1] - t))
    return (x * env).astype(np.float32)


@MP3
@pytest.mark.parametrize("sr", [48000, 16000])
def test_mp3_decode_bit_equal_to_jax(sr, tmp_path):
    """CommonVoice-style MP3: the port's decode_mp3, read_audio (sniffed by
    magic, no extension) and load_audio at 16 kHz equal JAX's bit for
    bit."""
    mp3 = codecs.encode_mp3(_speech_like(sr, 1.2, seed=sr), sr)
    assert mp3 == jcodecs.encode_mp3(_speech_like(sr, 1.2, seed=sr), sr)
    y, rate = codecs.decode_mp3(mp3)
    jy, jrate = jcodecs.decode_mp3(mp3)
    assert rate == jrate == sr and y.dtype == np.float32
    np.testing.assert_array_equal(y, jy)
    p = tmp_path / "clip"
    p.write_bytes(mp3)
    z, zr = paudio.read_audio(p)
    jz, jzr = jaudio.read_audio(p)
    assert zr == jzr == sr
    np.testing.assert_array_equal(z, jz)
    np.testing.assert_array_equal(paudio.load_audio(p, 16000),
                                  jaudio.load_audio(p, 16000))


@OPUS
def test_ogg_opus_decode_bit_equal_to_jax(tmp_path):
    """GigaSpeech-style Ogg/Opus at 48 kHz: decode_ogg_opus, read_audio and
    load_audio equal JAX's bit for bit; the length is the input's."""
    x = _speech_like(48000, 1.3, seed=1)
    ogg = codecs.encode_ogg_opus(x, 48000)
    y, rate = codecs.decode_ogg_opus(ogg)
    jy, jrate = jcodecs.decode_ogg_opus(ogg)
    assert rate == jrate == 48000 and len(y) == len(x)
    np.testing.assert_array_equal(y, jy)
    p = tmp_path / "seg.opus"
    p.write_bytes(ogg)
    np.testing.assert_array_equal(paudio.read_audio(p)[0],
                                  jaudio.read_audio(p)[0])
    np.testing.assert_array_equal(paudio.load_audio(p, 16000),
                                  jaudio.load_audio(p, 16000))


@OPUS
def test_ogg_crc_detects_corruption():
    ogg = bytearray(codecs.encode_ogg_opus(_speech_like(48000, 0.3, 2),
                                           48000))
    ogg[len(ogg) // 2] ^= 0xFF
    with pytest.raises(ValueError, match="CRC"):
        paudio.read_audio_bytes(bytes(ogg))


@pytest.mark.parametrize("lib,magic,what", [
    ("_mpg123", b"ID3\x04\0\0\0\0\0\0", "libmpg123"),
    ("_mpg123", b"\xff\xfb\x90\x00", "libmpg123"),
    ("_opus", b"OggS" + b"\0" * 40, "libopus")])
def test_missing_library_raises_naming_it(monkeypatch, lib, magic, what):
    """read_audio routes MP3 (ID3 tag or frame sync) and Ogg by magic; a
    missing decoder library raises JAX's error, naming it."""
    monkeypatch.setattr(codecs, lib, None)
    with pytest.raises(RuntimeError, match=what):
        paudio.read_audio_bytes(magic + b"\0" * 64)
