"""The port's own WAV loader (tpu_asr_torch/data/audio.py) against the JAX
package's load_audio, on PCM files written with the standard library's
`wave` module from seeded numpy audio: 8, 16, 24 and 32 bit, mono and
stereo, at the model rate and resampled (polyphase, as both use scipy's
resample_poly). MP3 and Ogg/Opus go to their decoders (data/codecs.py),
which refuse bytes that are not such a stream as JAX's do (decodes are
held to JAX in tests/test_torch_codecs.py; FLAC and NIST SPHERE in
tests/test_torch_pipeline.py)."""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import wave

import numpy as np
import pytest

from tpu_asr.data.audio import load_audio as jax_load_audio
from tpu_asr_torch.data.audio import load_audio


def _write(path, x, sr, width, channels):
    """x in [-1, 1) (frames, channels) -> PCM `width`-byte WAV."""
    if width == 1:
        raw = np.clip(np.round(x * 128 + 128), 0, 255).astype(np.uint8)
        data = raw.tobytes()
    else:
        scale = float(1 << (8 * width - 1))
        ints = np.clip(np.round(x * scale), -scale, scale - 1).astype(np.int64)
        data = b"".join(int(v).to_bytes(width, "little", signed=True)
                        for v in ints.reshape(-1))
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(data)


@pytest.mark.parametrize("width,channels,sr", [
    (2, 1, 16000), (2, 2, 22050), (1, 1, 8000), (3, 1, 44100),
    (4, 2, 16000)])
def test_load_audio_matches_jax(tmp_path, width, channels, sr):
    rng = np.random.default_rng(width * 10 + channels)
    x = rng.uniform(-0.9, 0.9, size=(sr // 4, channels))
    path = tmp_path / "a.wav"
    _write(path, x, sr, width, channels)
    got, want = load_audio(path), jax_load_audio(path)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_other_containers_raise(tmp_path):
    """An ID3 tag or an Ogg page without a stream behind it raises the
    codec's ValueError, JAX's message."""
    from tpu_asr.data import codecs as jcodecs
    if not (jcodecs.HAVE_MP3 and jcodecs.HAVE_OPUS):
        pytest.skip("libmpg123/libopus missing")
    for name, head, what in (("a.mp3", b"ID3\x04", "no decodable MP3"),
                             ("b.opus", b"OggS", "Ogg page CRC")):
        path = tmp_path / name
        path.write_bytes(head + bytes(64))
        with pytest.raises(ValueError, match=what) as got:
            load_audio(path)
        with pytest.raises(ValueError) as want:
            jax_load_audio(path)
        assert str(got.value) == str(want.value)
