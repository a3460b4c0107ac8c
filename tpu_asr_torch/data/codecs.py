"""MP3 and Ogg/Opus decode via the image's system codec libraries.

Closes the two reference eval suites that ship compressed audio:
- CommonVoice is mp3 @ 48 kHz (reference asr_inference_CV.py:218) -> libmpg123
- GigaSpeech ships Ogg/Opus (reference gigaspeech.py:124-165)     -> libopus

The reference got these through libsndfile/audioread/soundfile; this image has
no such Python wrappers, but the codec shared libraries themselves ARE present
(/lib/x86_64-linux-gnu/libmpg123.so.0, libopus.so.0, libogg.so.0, plus the
encoders libmp3lame.so.0 and the Opus encoder entry points inside libopus).
No dev headers are installed, so the bindings are ctypes with hand-declared
prototypes (the VERDICT-sanctioned route); the per-sample work happens inside
the C codecs either way, ctypes only pays per-call overhead (one call per
file for mp3, one per ~20 ms packet for opus).

The Ogg container layer (demux for decode, mux for test fixtures) is
implemented here in pure Python — it is cheap framing logic (~50 packets per
second of audio), and libogg's struct-heavy API is awkward through ctypes.
CRC verification uses the Ogg polynomial (0x04c11db7, unreflected).

Encoders (`encode_mp3`, `encode_ogg_opus`) exist so tests can generate real
compressed fixtures offline and round-trip them — no binary files in-repo.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct
from typing import Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# library loading


def _load(*names) -> Optional[ctypes.CDLL]:
    for n in names:
        try:
            return ctypes.CDLL(n)
        except OSError:
            continue
    return None


_mpg123 = _load("libmpg123.so.0", "libmpg123.so")
_lame = _load("libmp3lame.so.0", "libmp3lame.so")
_opus = _load("libopus.so.0", "libopus.so")

HAVE_MP3 = _mpg123 is not None
HAVE_MP3_ENCODE = _lame is not None
HAVE_OPUS = _opus is not None

# ---------------------------------------------------------------------------
# MP3 decode (libmpg123 feed API)

# mpg123 return codes / enums (public ABI, stable since 1.x)
_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_NEED_MORE = -10
_MPG123_ENC_SIGNED_16 = 0xD0
_MPG123_ADD_FLAGS = 2          # enum mpg123_parms
_MPG123_QUIET = 0x20           # param flag: no stderr chatter

if _mpg123 is not None:
    _mpg123.mpg123_new.restype = ctypes.c_void_p
    _mpg123.mpg123_new.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_int)]
    _mpg123.mpg123_open_feed.argtypes = [ctypes.c_void_p]
    _mpg123.mpg123_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_size_t]
    _mpg123.mpg123_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_size_t,
                                    ctypes.POINTER(ctypes.c_size_t)]
    _mpg123.mpg123_getformat.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    _mpg123.mpg123_delete.argtypes = [ctypes.c_void_p]
    if hasattr(_mpg123, "mpg123_param"):
        _mpg123.mpg123_param.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_long, ctypes.c_double]


def decode_mp3(data: bytes) -> Tuple[np.ndarray, int]:
    """MP3 bytes -> (mono float32 in [-1, 1], native sample_rate).

    Uses libmpg123's feed API: the whole buffer is fed once, frames are
    drained as signed-16 PCM at the stream's native rate/channel count, then
    converted to mono float32 (channel mean, matching the wav/flac readers).
    """
    if _mpg123 is None:  # pragma: no cover - present in this image
        raise RuntimeError("libmpg123 not found; cannot decode MP3")
    # mpg123_init is required <1.27 and a no-op after; call when exported
    if hasattr(_mpg123, "mpg123_init"):
        _mpg123.mpg123_init()
    err = ctypes.c_int(0)
    h = _mpg123.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError(f"mpg123_new failed (err={err.value})")
    try:
        if hasattr(_mpg123, "mpg123_param"):
            _mpg123.mpg123_param(h, _MPG123_ADD_FLAGS, _MPG123_QUIET, 0.0)
        if _mpg123.mpg123_open_feed(h) != _MPG123_OK:
            raise RuntimeError("mpg123_open_feed failed")
        if _mpg123.mpg123_feed(h, data, len(data)) != _MPG123_OK:
            raise RuntimeError("mpg123_feed failed")

        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        encoding = ctypes.c_int(0)
        out = ctypes.create_string_buffer(1 << 18)
        done = ctypes.c_size_t(0)
        chunks = []
        while True:
            ret = _mpg123.mpg123_read(h, out, len(out), ctypes.byref(done))
            if done.value:
                chunks.append(out.raw[:done.value])
            if ret == _MPG123_NEW_FORMAT:
                _mpg123.mpg123_getformat(h, ctypes.byref(rate),
                                         ctypes.byref(channels),
                                         ctypes.byref(encoding))
                if encoding.value != _MPG123_ENC_SIGNED_16:
                    raise RuntimeError(
                        f"unexpected mpg123 encoding {encoding.value:#x} "
                        "(expected signed-16 default)")
            elif ret in (_MPG123_DONE, _MPG123_NEED_MORE):
                # NEED_MORE after the full feed == end of stream
                break
            elif ret != _MPG123_OK:
                raise RuntimeError(f"mpg123_read error {ret}")
        if not chunks or rate.value == 0:
            raise ValueError("no decodable MP3 frames found")
        pcm = np.frombuffer(b"".join(chunks), dtype="<i2")
        n_ch = max(channels.value, 1)
        if n_ch > 1:
            pcm = pcm[: len(pcm) - len(pcm) % n_ch]
            x = pcm.reshape(-1, n_ch).mean(axis=1).astype(np.float32) / 32768.0
        else:
            x = pcm.astype(np.float32) / 32768.0
        return x, int(rate.value)
    finally:
        _mpg123.mpg123_delete(h)


# ---------------------------------------------------------------------------
# MP3 encode (libmp3lame) — test-fixture generation only

if _lame is not None:
    _lame.lame_init.restype = ctypes.c_void_p
    for _f in ("lame_set_in_samplerate", "lame_set_out_samplerate",
               "lame_set_num_channels", "lame_set_mode", "lame_set_brate"):
        getattr(_lame, _f).argtypes = [ctypes.c_void_p, ctypes.c_int]
    _lame.lame_init_params.argtypes = [ctypes.c_void_p]
    _lame.lame_encode_buffer.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int]
    _lame.lame_encode_flush.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_int]
    _lame.lame_close.argtypes = [ctypes.c_void_p]


def encode_mp3(x: np.ndarray, sample_rate: int, bitrate_kbps: int = 64) -> bytes:
    """Mono float32 -> MP3 bytes (libmp3lame). For offline test fixtures."""
    if _lame is None:  # pragma: no cover - present in this image
        raise RuntimeError("libmp3lame not found; cannot encode MP3")
    pcm = (np.clip(np.asarray(x, np.float32), -1, 1) * 32767.0).astype("<i2")
    g = _lame.lame_init()
    try:
        _lame.lame_set_in_samplerate(g, sample_rate)
        _lame.lame_set_out_samplerate(g, sample_rate)
        _lame.lame_set_num_channels(g, 1)
        _lame.lame_set_mode(g, 3)                     # MONO
        _lame.lame_set_brate(g, bitrate_kbps)
        if _lame.lame_init_params(g) < 0:
            raise RuntimeError("lame_init_params failed")
        buf = ctypes.create_string_buffer(int(1.25 * len(pcm)) + 7200)
        n = _lame.lame_encode_buffer(
            g, pcm.ctypes.data_as(ctypes.c_void_p),
            pcm.ctypes.data_as(ctypes.c_void_p), len(pcm), buf, len(buf))
        if n < 0:
            raise RuntimeError(f"lame_encode_buffer error {n}")
        out = bytes(buf.raw[:n])
        n = _lame.lame_encode_flush(g, buf, len(buf))
        if n < 0:
            raise RuntimeError(f"lame_encode_flush error {n}")
        return out + bytes(buf.raw[:n])
    finally:
        _lame.lame_close(g)


# ---------------------------------------------------------------------------
# Ogg container (pure-Python framing; CRC32 with the Ogg polynomial)

_OGG_CRC_TABLE = None


def _ogg_crc_table():
    global _OGG_CRC_TABLE
    if _OGG_CRC_TABLE is None:
        tab = np.zeros(256, np.uint32)
        for i in range(256):
            r = np.uint32(i << 24)
            for _ in range(8):
                r = np.uint32((r << 1) ^ 0x04C11DB7) if r & 0x80000000 \
                    else np.uint32(r << 1)
            tab[i] = r
        _OGG_CRC_TABLE = tab
    return _OGG_CRC_TABLE


def ogg_crc(data: bytes) -> int:
    tab = _ogg_crc_table()
    crc = np.uint32(0)
    for b in data:
        crc = np.uint32((crc << 8) ^ tab[((crc >> 24) ^ b) & 0xFF])
    return int(crc)


def ogg_demux(data: bytes, verify_crc: bool = True):
    """Parse an Ogg stream -> (packets: list[bytes], last_granulepos: int).

    Handles packet continuation across pages (lacing value 255 at page end +
    header_type continuation flag). Single logical stream assumed (the
    GigaSpeech .opus files are single-stream)."""
    packets = []
    partial = b""
    last_gp = 0
    pos = 0
    n = len(data)
    while pos + 27 <= n:
        if data[pos:pos + 4] != b"OggS":
            raise ValueError(f"bad Ogg page magic at offset {pos}")
        (version, htype, gp, _serial, _seq, crc, nseg) = struct.unpack_from(
            "<BBqIIIB", data, pos + 4)
        if version != 0:
            raise ValueError(f"unsupported Ogg version {version}")
        seg_tab = data[pos + 27:pos + 27 + nseg]
        body_len = sum(seg_tab)
        page_end = pos + 27 + nseg + body_len
        if page_end > n:
            raise ValueError("truncated Ogg page")
        if verify_crc:
            page = bytearray(data[pos:page_end])
            page[22:26] = b"\0\0\0\0"
            if ogg_crc(bytes(page)) != crc:
                raise ValueError(f"Ogg page CRC mismatch at offset {pos}")
        if not (htype & 0x01):          # not a continuation: drop any partial
            partial = b""
        body_pos = pos + 27 + nseg
        for lace in seg_tab:
            partial += data[body_pos:body_pos + lace]
            body_pos += lace
            if lace < 255:
                packets.append(partial)
                partial = b""
        if gp >= 0:
            last_gp = gp
        pos = page_end
    return packets, last_gp


def _ogg_page(serial: int, seq: int, granulepos: int, packet: bytes,
              header_type: int = 0) -> bytes:
    """One packet -> one Ogg page (fixture muxer; lacing splits >255 bytes)."""
    laces = []
    rem = len(packet)
    while rem >= 255:
        laces.append(255)
        rem -= 255
    laces.append(rem)                    # final lace < 255 terminates packet
    header = struct.pack("<4sBBqIIIB", b"OggS", 0, header_type, granulepos,
                         serial, seq, 0, len(laces)) + bytes(laces)
    page = bytearray(header + packet)
    crc = ogg_crc(bytes(page))
    page[22:26] = struct.pack("<I", crc)
    return bytes(page)


# ---------------------------------------------------------------------------
# Opus decode / encode (libopus); Ogg/Opus = RFC 7845

_OPUS_APPLICATION_AUDIO = 2049
_OPUS_GET_LOOKAHEAD_REQUEST = 4027
_OPUS_SET_BITRATE_REQUEST = 4002
_MAX_OPUS_FRAME = 5760                  # 120 ms @ 48 kHz, per channel

if _opus is not None:
    _opus.opus_decoder_create.restype = ctypes.c_void_p
    _opus.opus_decoder_create.argtypes = [ctypes.c_int32, ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_int)]
    _opus.opus_decode_float.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int]
    _opus.opus_decoder_destroy.argtypes = [ctypes.c_void_p]
    _opus.opus_encoder_create.restype = ctypes.c_void_p
    _opus.opus_encoder_create.argtypes = [ctypes.c_int32, ctypes.c_int,
                                          ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_int)]
    _opus.opus_encode_float.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int32]
    _opus.opus_encoder_destroy.argtypes = [ctypes.c_void_p]
    # opus_encoder_ctl is cdecl varargs: argtypes must cover the FIXED args
    # (handle + request) or ctypes truncates the 64-bit handle to c_int
    _opus.opus_encoder_ctl.argtypes = [ctypes.c_void_p, ctypes.c_int]


def decode_ogg_opus(data: bytes) -> Tuple[np.ndarray, int]:
    """Ogg/Opus bytes -> (mono float32, 48000).

    Demuxes the Ogg layer in Python, decodes each packet with libopus at
    48 kHz (the Opus canonical rate — decoders always run at 48 k regardless
    of the encoder input rate, RFC 7845 §5.1), drops the OpusHead pre-skip,
    and trims to the final granule position."""
    if _opus is None:  # pragma: no cover - present in this image
        raise RuntimeError("libopus not found; cannot decode Ogg/Opus")
    packets, last_gp = ogg_demux(data)
    if not packets or not packets[0].startswith(b"OpusHead"):
        raise ValueError("not an Ogg/Opus stream (no OpusHead)")
    head = packets[0]
    version, channels = head[8], head[9]
    if version >> 4 != 0:               # major version must be 0 (RFC 7845)
        raise ValueError(f"unsupported OpusHead version {version}")
    pre_skip = struct.unpack_from("<H", head, 10)[0]
    audio_packets = packets[1:]
    if audio_packets and audio_packets[0].startswith(b"OpusTags"):
        audio_packets = audio_packets[1:]

    err = ctypes.c_int(0)
    dec = _opus.opus_decoder_create(48000, channels, ctypes.byref(err))
    if err.value != 0:
        raise RuntimeError(f"opus_decoder_create error {err.value}")
    try:
        frame = np.empty(_MAX_OPUS_FRAME * channels, np.float32)
        fptr = frame.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        chunks = []
        for pkt in audio_packets:
            got = _opus.opus_decode_float(dec, pkt, len(pkt), fptr,
                                          _MAX_OPUS_FRAME, 0)
            if got < 0:
                raise RuntimeError(f"opus_decode_float error {got}")
            chunks.append(frame[:got * channels].copy())
    finally:
        _opus.opus_decoder_destroy(dec)
    x = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    x = x[pre_skip:]
    if last_gp > pre_skip:              # granulepos-based end trim
        x = x[: last_gp - pre_skip]
    return np.ascontiguousarray(x, np.float32), 48000


def encode_ogg_opus(x: np.ndarray, sample_rate: int = 48000,
                    bitrate: int = 64000) -> bytes:
    """Mono float32 @ 48 kHz -> Ogg/Opus bytes (fixture generation).

    Input must be 48 kHz (resample first); 20 ms frames, one packet per page
    (valid, if chatty, Ogg). OpusHead pre-skip is the encoder lookahead; the
    final page's granulepos encodes the true length for decoder-side trim."""
    if _opus is None:  # pragma: no cover - present in this image
        raise RuntimeError("libopus not found; cannot encode Ogg/Opus")
    if sample_rate != 48000:
        raise ValueError("encode_ogg_opus expects 48 kHz input")
    x = np.ascontiguousarray(np.clip(np.asarray(x, np.float32), -1, 1))
    err = ctypes.c_int(0)
    enc = _opus.opus_encoder_create(48000, 1, _OPUS_APPLICATION_AUDIO,
                                    ctypes.byref(err))
    if err.value != 0:
        raise RuntimeError(f"opus_encoder_create error {err.value}")
    try:
        _opus.opus_encoder_ctl(enc, _OPUS_SET_BITRATE_REQUEST,
                               ctypes.c_int32(bitrate))
        look = ctypes.c_int32(0)
        _opus.opus_encoder_ctl(enc, _OPUS_GET_LOOKAHEAD_REQUEST,
                               ctypes.byref(look))
        pre_skip = int(look.value)

        frame = 960                      # 20 ms @ 48 kHz
        n_in = len(x)
        pad = (-n_in) % frame
        xpad = np.concatenate([x, np.zeros(pad + frame, np.float32)])
        out = ctypes.create_string_buffer(4000)
        pkts = []
        # enough frames to flush pre_skip lookahead past the true audio end
        total_frames = (n_in + pad) // frame + (pre_skip + frame - 1) // frame
        for i in range(total_frames):
            seg = xpad[i * frame:(i + 1) * frame]
            if len(seg) < frame:
                seg = np.concatenate([seg,
                                      np.zeros(frame - len(seg), np.float32)])
                seg = np.ascontiguousarray(seg)
            n = _opus.opus_encode_float(
                enc, seg.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                frame, out, len(out))
            if n < 0:
                raise RuntimeError(f"opus_encode_float error {n}")
            pkts.append(bytes(out.raw[:n]))
    finally:
        _opus.opus_encoder_destroy(enc)

    serial = 0x54505541               # arbitrary stream serial ("TPUA")
    head = (b"OpusHead" + bytes([1, 1]) + struct.pack("<H", pre_skip)
            + struct.pack("<I", 48000) + struct.pack("<h", 0) + bytes([0]))
    tags = (b"OpusTags" + struct.pack("<I", 7) + b"tpu_asr"
            + struct.pack("<I", 0))
    pages = [_ogg_page(serial, 0, 0, head, header_type=0x02),   # BOS
             _ogg_page(serial, 1, 0, tags)]
    for i, pkt in enumerate(pkts):
        gp = pre_skip + n_in if i == len(pkts) - 1 else (i + 1) * 960
        ht = 0x04 if i == len(pkts) - 1 else 0                  # EOS
        pages.append(_ogg_page(serial, 2 + i, gp, pkt, header_type=ht))
    return b"".join(pages)
