"""Pure-Python FLAC decoder: the port's own copy of tpu_asr/data/flac.py,
the plain version of the native decoder (tpu_asr_torch/native, a copy of
native/flacio.c), which `read_audio` takes. Implements the
FLAC bitstream format (RFC 9639) from the spec: CONSTANT / VERBATIM / FIXED(0-4) / LPC(1-32) subframes,
partitioned Rice/Rice2 residuals with escape codes, wasted bits, and
left-side / right-side / mid-side stereo decorrelation.

The reference decodes .flac via soundfile/libsndfile (asr_train.py:14,141);
LibriSpeech ships .flac (librispeech_asr.py:264-300). Host-side, off the hot
path (SURVEY.md §2.3).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

_BLOCKSIZE_TABLE = [0, 192, 576, 1152, 2304, 4608, 0, 0,
                    256, 512, 1024, 2048, 4096, 8192, 16384, 32768]


class _BitReader:
    __slots__ = ("data", "len", "pos", "acc", "nbits")

    def __init__(self, data: bytes):
        self.data = data
        self.len = len(data)
        self.pos = 0
        self.acc = 0
        self.nbits = 0

    def _fill(self):
        while self.nbits <= 56 and self.pos < self.len:
            self.acc = (self.acc << 8) | self.data[self.pos]
            self.pos += 1
            self.nbits += 8

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        if self.nbits < n:
            self._fill()
            if self.nbits < n:
                raise EOFError("truncated FLAC stream")
        self.nbits -= n
        v = (self.acc >> self.nbits) & ((1 << n) - 1)
        return v

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        if n and v & (1 << (n - 1)):
            v -= 1 << n
        return v

    def read_unary(self) -> int:
        q = 0
        while True:
            if self.nbits == 0:
                self._fill()
                if self.nbits == 0:
                    raise EOFError("truncated FLAC stream")
            while self.nbits > 0:
                self.nbits -= 1
                if (self.acc >> self.nbits) & 1:
                    return q
                q += 1

    def align_byte(self):
        self.nbits -= self.nbits & 7

    def bytepos(self) -> int:
        return self.pos - (self.nbits >> 3)

    def at_eof(self) -> bool:
        return self.bytepos() >= self.len


def _skip_utf8(br: _BitReader) -> None:
    b0 = br.read(8)
    if b0 < 0x80:
        extra = 0
    elif (b0 & 0xE0) == 0xC0:
        extra = 1
    elif (b0 & 0xF0) == 0xE0:
        extra = 2
    elif (b0 & 0xF8) == 0xF0:
        extra = 3
    elif (b0 & 0xFC) == 0xF8:
        extra = 4
    elif (b0 & 0xFE) == 0xFC:
        extra = 5
    elif b0 == 0xFE:
        extra = 6
    else:
        raise ValueError("bad UTF-8 frame number")
    for _ in range(extra):
        br.read(8)


def _decode_residual(br: _BitReader, blocksize: int, order: int) -> List[int]:
    method = br.read(2)
    if method > 1:
        raise ValueError("reserved residual method")
    plen, escape = (4, 0xF) if method == 0 else (5, 0x1F)
    porder = br.read(4)
    if blocksize >> porder == 0:
        raise ValueError("bad partition order")
    out: List[int] = []
    for p in range(1 << porder):
        count = blocksize >> porder
        if p == 0:
            count -= order
        if count < 0:
            raise ValueError("bad partition layout")
        param = br.read(plen)
        if param == escape:
            nbits = br.read(5)
            out.extend(br.read_signed(nbits) if nbits else 0
                       for _ in range(count))
        else:
            for _ in range(count):
                q = br.read_unary()
                r = br.read(param) if param else 0
                v = (q << param) | r
                out.append((v >> 1) ^ -(v & 1))
    return out


def _decode_subframe(br: _BitReader, blocksize: int, bps: int) -> List[int]:
    if br.read(1) != 0:
        raise ValueError("bad subframe padding bit")
    stype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = br.read_unary() + 1
    bps -= wasted
    if bps <= 0 or bps > 33:
        raise ValueError("bad subframe bit depth")

    if stype == 0:                              # CONSTANT
        out = [br.read_signed(bps)] * blocksize
    elif stype == 1:                            # VERBATIM
        out = [br.read_signed(bps) for _ in range(blocksize)]
    elif (stype & 0x38) == 0x08 and (stype & 0x07) <= 4:   # FIXED
        order = stype & 0x07
        out = [br.read_signed(bps) for _ in range(order)]
        out.extend(_decode_residual(br, blocksize, order))
        if order == 1:
            for i in range(order, blocksize):
                out[i] += out[i - 1]
        elif order == 2:
            for i in range(order, blocksize):
                out[i] += 2 * out[i - 1] - out[i - 2]
        elif order == 3:
            for i in range(order, blocksize):
                out[i] += 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3]
        elif order == 4:
            for i in range(order, blocksize):
                out[i] += (4 * out[i - 1] - 6 * out[i - 2]
                           + 4 * out[i - 3] - out[i - 4])
    elif stype >= 0x20:                         # LPC
        order = (stype & 0x1F) + 1
        out = [br.read_signed(bps) for _ in range(order)]
        prec = br.read(4)
        if prec == 0xF:
            raise ValueError("invalid LPC precision")
        prec += 1
        shift = br.read_signed(5)
        if shift < 0:
            raise ValueError("negative LPC shift")
        coef = [br.read_signed(prec) for _ in range(order)]
        out.extend(_decode_residual(br, blocksize, order))
        for i in range(order, blocksize):
            acc = sum(coef[j] * out[i - 1 - j] for j in range(order))
            out[i] += acc >> shift
    else:
        raise ValueError(f"reserved subframe type {stype}")

    if wasted:
        out = [v << wasted for v in out]
    return out


def decode_flac(data: bytes) -> Tuple[np.ndarray, int]:
    """FLAC bytes -> (mono float32 waveform in [-1, 1], sample_rate)."""
    if len(data) < 42 or data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")
    pos = 4
    sample_rate = channels = bps = 0
    total_samples = 0
    last = False
    while not last:
        if pos + 4 > len(data):
            raise ValueError("truncated metadata")
        last = bool(data[pos] >> 7)
        btype = data[pos] & 0x7F
        blen = int.from_bytes(data[pos + 1:pos + 4], "big")
        pos += 4
        if pos + blen > len(data):
            raise ValueError("truncated metadata block")
        if btype == 0 and blen >= 34:           # STREAMINFO
            b = data[pos:pos + 34]
            sample_rate = (b[10] << 12) | (b[11] << 4) | (b[12] >> 4)
            channels = ((b[12] >> 1) & 0x7) + 1
            bps = (((b[12] & 1) << 4) | (b[13] >> 4)) + 1
            total_samples = ((b[13] & 0xF) << 32) | int.from_bytes(b[14:18], "big")
        pos += blen
    if sample_rate == 0:
        raise ValueError("missing STREAMINFO")

    br = _BitReader(data[pos:])
    scale = 1.0 / float(1 << (bps - 1))
    chunks: List[np.ndarray] = []
    nout = 0
    while not br.at_eof():
        try:
            sync = br.read(14)
        except EOFError:
            break                                # clean EOF
        if sync != 0x3FFE:
            raise ValueError("lost frame sync")
        br.read(1)                               # reserved
        br.read(1)                               # blocking strategy
        bs_code = br.read(4)
        sr_code = br.read(4)
        ch_code = br.read(4)
        ss_code = br.read(3)
        br.read(1)                               # reserved
        _skip_utf8(br)
        if bs_code == 6:
            blocksize = br.read(8) + 1
        elif bs_code == 7:
            blocksize = br.read(16) + 1
        else:
            blocksize = _BLOCKSIZE_TABLE[bs_code]
        if blocksize == 0:
            raise ValueError("reserved blocksize code")
        if sr_code == 12:
            br.read(8)
        elif sr_code in (13, 14):
            br.read(16)
        elif sr_code == 15:
            raise ValueError("invalid sample-rate code")
        br.read(8)                               # header CRC-8 (not verified)

        frame_bps = {0: bps, 1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}.get(ss_code)
        if frame_bps is None:
            raise ValueError("reserved sample-size code")

        mode = 0
        if ch_code < 8:
            nch = ch_code + 1
        elif ch_code == 8:
            nch, mode = 2, 1                    # left/side
        elif ch_code == 9:
            nch, mode = 2, 2                    # right/side
        elif ch_code == 10:
            nch, mode = 2, 3                    # mid/side
        else:
            raise ValueError("reserved channel assignment")
        if nch != channels:
            raise ValueError("channel count change mid-stream")

        subs = []
        for c in range(nch):
            sub_bps = frame_bps
            if (mode == 1 and c == 1) or (mode == 2 and c == 0) or \
                    (mode == 3 and c == 1):
                sub_bps += 1                     # side channel: +1 bit
            subs.append(_decode_subframe(br, blocksize, sub_bps))
        br.align_byte()
        br.read(16)                              # frame CRC-16 (not verified)

        if mode == 1:                            # right = left - side
            subs[1] = [l - s for l, s in zip(subs[0], subs[1])]
        elif mode == 2:                          # left = right + side
            subs[0] = [r + s for s, r in zip(subs[0], subs[1])]
        elif mode == 3:                          # mid/side
            left, right = [], []
            for m, s in zip(subs[0], subs[1]):
                mid = (m << 1) | (s & 1)
                left.append((mid + s) >> 1)
                right.append((mid - s) >> 1)
            subs = [left, right]

        arr = np.asarray(subs, np.float64)
        mono = (arr.mean(axis=0) * scale).astype(np.float32)
        chunks.append(mono)
        nout += blocksize
        if total_samples and nout >= total_samples:
            break

    out = (np.concatenate(chunks) if chunks
           else np.zeros((0,), np.float32))
    if total_samples:
        out = out[:total_samples]
    return out, sample_rate
