"""The port's native host code (tpu_asr_torch/native: copies of native/
wavio.c, flacio.c and editdistance.c with a plain C interface, built with
the host C compiler) against its plain Python versions and against the JAX
package's C extensions and Python decoders, on fixtures written here:

- WAV in every format wavio.c takes (PCM 8, 16, 24 and 32 bit, IEEE float
  32 and 64, WAVE_FORMAT_EXTENSIBLE), mono and stereo: bit-equal PCM;
- FLAC (tests/flac_writer.py: subframe modes, stereo decorrelation, bit
  depths, wasted bits, an unknown total): bit-equal PCM;
- edit distance on seeded word and token-id sequences: equal;
- read_audio and the WER metric take the native routes; a failed build
  raises with the compiler's log instead of falling back.
"""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import struct

import numpy as np
import pytest

import tpu_asr.data.audio as jaudio
import tpu_asr.utils.wer as jwer
import tpu_asr_torch.native as native
from tests.flac_writer import encode_flac
from tpu_asr.data.flac import decode_flac as jax_decode_flac
from tpu_asr_torch.data import audio as paudio
from tpu_asr_torch.data.flac import decode_flac
from tpu_asr_torch.utils import wer as pwer

jax_wavio = pytest.importorskip("tpu_asr.data._wavio")
jax_flacio = pytest.importorskip("tpu_asr.data._flacio")
jax_editdistance = pytest.importorskip("tpu_asr.utils._editdistance")


def wav_bytes(fmt_code, bits, channels, payload, sr=16000,
              extensible=False):
    """RIFF/WAVE bytes; `extensible` writes a WAVE_FORMAT_EXTENSIBLE fmt
    chunk whose subformat GUID starts with `fmt_code`."""
    if extensible:
        guid = struct.pack("<H", fmt_code) + bytes.fromhex(
            "000000001000800000aa00389b71")
        fmt = struct.pack("<HHIIHHHHI", 0xFFFE, channels, sr,
                          sr * channels * bits // 8, channels * bits // 8,
                          bits, 22, bits, (1 << channels) - 1) + guid
    else:
        fmt = struct.pack("<HHIIHH", fmt_code, channels, sr,
                          sr * channels * bits // 8, channels * bits // 8,
                          bits)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(payload)) + payload)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _payload(fmt_code, bits, channels, rng, n=300):
    shape = (n, channels)
    if fmt_code == 3:
        return (rng.normal(size=shape) * 0.4).astype(
            "<f4" if bits == 32 else "<f8").tobytes()
    if bits == 8:
        return rng.integers(0, 256, shape).astype(np.uint8).tobytes()
    if bits == 24:
        v = rng.integers(-(1 << 23), 1 << 23, shape).astype("<i4")
        return b"".join(int(x).to_bytes(3, "little", signed=True)
                        for x in v.reshape(-1))
    lim = 1 << (bits - 1)
    x = rng.integers(-lim, lim, shape)
    x[:4] = [[-lim] * channels, [lim - 1] * channels, [0] * channels,
             [lim - 2] * channels]
    return x.astype(f"<i{bits // 8}").tobytes()


WAV_CASES = [(f, b, c, e) for f, b in ((1, 8), (1, 16), (1, 24), (1, 32),
                                       (3, 32), (3, 64))
             for c in (1, 2) for e in (False, True)]


@pytest.mark.parametrize("fmt_code,bits,channels,extensible", WAV_CASES,
                         ids=[f"{'pcm' if f == 1 else 'float'}{b}_{c}ch"
                              f"{'_ext' if e else ''}"
                              for f, b, c, e in WAV_CASES])
def test_native_wav_bit_equal(fmt_code, bits, channels, extensible):
    """Native PCM == the plain Python reader == JAX's C extension, bit for
    bit, and the same sample rate; == JAX's Python reader too, but where
    that reader departs from both C decoders (the reference's fault, see
    `read_wav_bytes`): the float32 channel mean of stereo 32-bit and
    float64 PCM (within one float32 ulp at 1.0) and the format of an
    extensible float32 file (read as 32-bit PCM)."""
    rng = np.random.default_rng(bits * 10 + channels)
    raw = wav_bytes(fmt_code, bits, channels,
                    _payload(fmt_code, bits, channels, rng), sr=22050,
                    extensible=extensible)
    got, sr = native.wav_decode(raw)
    plain, sr_p = paudio.read_wav_bytes(raw)
    pcm, sr_j, n = jax_wavio.decode(raw)
    jax_py, sr_jp = jaudio.read_wav_python(raw)
    assert sr == sr_p == sr_j == sr_jp == 22050
    assert got.dtype == np.float32 and got.shape == (300,)
    np.testing.assert_array_equal(got, np.frombuffer(pcm, np.float32,
                                                     count=n))
    np.testing.assert_array_equal(got, plain)
    delta = np.abs(got - jax_py).max()
    if extensible and (fmt_code, bits) == (3, 32):
        assert delta > 0.1
    elif channels == 2 and (fmt_code, bits) in ((1, 32), (3, 64)):
        assert 0 < delta <= 2.0 ** -24          # one float32 ulp at 1.0
    else:
        np.testing.assert_array_equal(got, jax_py)


def test_native_wav_refuses_what_jax_refuses():
    for raw in (b"RIFF\0\0\0\0WAVX", b"junk",
                wav_bytes(1, 12, 1, b"\0" * 30), wav_bytes(2, 16, 1, b"")):
        with pytest.raises(ValueError) as got:
            native.wav_decode(raw)
        with pytest.raises(ValueError) as want:
            jax_wavio.decode(raw)
        assert str(got.value) == str(want.value)


def _flac_cases():
    rng = np.random.default_rng(0)
    t = np.arange(5000)
    tone = np.round(9000 * np.sin(t / 9.0)).astype(np.int64)
    noisy = np.clip(tone + rng.integers(-300, 300, t.size), -32768, 32767)
    stereo = np.stack([noisy, np.clip(noisy // 2 + rng.integers(
        -50, 50, t.size), -32768, 32767)], axis=1)
    cases = {f"mono_{m}": encode_flac(noisy, 16000, subframe_mode=m)
             for m in ("constant", "verbatim", "fixed0", "fixed2",
                       "fixed4", "lpc1")
             if m != "constant"}
    cases["mono_constant"] = encode_flac(np.full(3000, 123), 16000,
                                         subframe_mode="constant")
    for mode in ("independent", "left_side", "right_side", "mid_side"):
        cases[f"stereo_{mode}"] = encode_flac(stereo, 44100,
                                              stereo_mode=mode)
    for bps in (8, 12, 20, 24):
        x = rng.integers(-(1 << (bps - 1)), 1 << (bps - 1), 2000)
        cases[f"bps{bps}"] = encode_flac(x, 16000, bps=bps,
                                         subframe_mode="verbatim")
    cases["wasted_bits"] = encode_flac((noisy // 8) * 8, 16000, wasted=3)
    cases["rice_partitions"] = encode_flac(noisy, 16000, partition_order=3)
    cases["unknown_total"] = encode_flac(noisy[:4321], 16000,
                                         total_in_streaminfo=False)
    return cases


FLAC = _flac_cases()


@pytest.mark.parametrize("name", sorted(FLAC))
def test_native_flac_bit_equal(name):
    """Native PCM == the plain Python decoder == JAX's C extension == JAX's
    Python decoder, bit for bit."""
    data = FLAC[name]
    got, sr = native.flac_decode(data)
    plain, sr_p = decode_flac(data)
    pcm, sr_j, n = jax_flacio.decode(data)
    jax_py, sr_jp = jax_decode_flac(data)
    assert sr == sr_p == sr_j == sr_jp
    np.testing.assert_array_equal(got, np.frombuffer(pcm, np.float32,
                                                     count=n))
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, jax_py)


def test_native_flac_garbage_raises_as_jax():
    for data in (b"fLaC" + b"\0" * 10, b"fLaC"):
        with pytest.raises(ValueError, match="FLAC") as got:
            native.flac_decode(data)
        with pytest.raises(ValueError) as want:
            jax_flacio.decode(data)
        assert str(got.value) == str(want.value)


def test_native_edit_distance_equals_python_and_jax():
    rng = np.random.default_rng(7)
    words = ["the", "a", "cat", "sat", "on", "mat", "dog", "ran"]
    pairs = [([], []), ([], ["x"]), (["x"], []), ("kitten", "sitting")]
    for _ in range(60):
        n, m = rng.integers(0, 25, 2)
        pairs.append((list(rng.choice(words, n)), list(rng.choice(words, m))))
        pairs.append((rng.integers(0, 6, n).tolist(),
                      rng.integers(0, 6, m).tolist()))
    for a, b in pairs:
        d = native.edit_distance(a, b)
        assert d == pwer.edit_distance_plain(a, b) == \
            jax_editdistance.eval(list(a), list(b)) == \
            jwer.edit_distance(a, b)
        assert pwer.edit_distance(a, b) == d


def test_routes_take_the_native_library(monkeypatch, tmp_path):
    """read_audio decodes WAV and FLAC, and the WER metric counts edits,
    through the native library."""
    calls = []
    for name in ("wav_decode", "flac_decode", "edit_distance"):
        real = getattr(native, name)
        monkeypatch.setattr(native, name, lambda *a, _r=real, _n=name: (
            calls.append(_n), _r(*a))[1])
    (tmp_path / "a.wav").write_bytes(wav_bytes(1, 16, 1, b"\1\0" * 40))
    (tmp_path / "a.flac").write_bytes(FLAC["mono_fixed2"])
    paudio.read_audio(tmp_path / "a.wav")
    paudio.read_audio(tmp_path / "a.flac")
    assert pwer.word_error_rate(["a b c"], ["a c"]) == 0.5
    assert calls == ["wav_decode", "flac_decode", "edit_distance"]


def test_failed_build_raises_with_the_log(monkeypatch, tmp_path):
    """A compiler that fails raises with its log; nothing falls back."""
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setenv("CC", "false")
    with pytest.raises(RuntimeError, match="failed .code 1.:\nfalse -O3"):
        native.build()
    assert not list(tmp_path.rglob("*.so"))
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    with pytest.raises(RuntimeError, match="no-such-cc"):
        native.build()


def test_first_use_from_many_threads_builds_once(monkeypatch, tmp_path):
    """The data loader's threads decode at once: their first calls build
    the library once and all of them decode (the card's CLI phase found
    two threads renaming one temporary file)."""
    from concurrent.futures import ThreadPoolExecutor
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    native.library.cache_clear()
    raw = wav_bytes(1, 16, 1, b"\1\0" * 40)
    try:
        with ThreadPoolExecutor(8) as pool:
            outs = list(pool.map(lambda _: native.wav_decode(raw), range(16)))
    finally:
        native.library.cache_clear()
    assert all(np.array_equal(o[0], outs[0][0]) for o in outs)
    assert [p.name for p in tmp_path.rglob("*.so")] == [native.LIB_NAME]
    assert not list(tmp_path.rglob("*.tmp"))
