/* Native FLAC decoder: the port's copy of native/flacio.c with a plain C
 * interface, loaded by ctypes (tpu_asr_torch/native/__init__.py) instead of
 * the CPython C API; the decoder below is the original's.
 *
 * Host input-pipeline decode for
 * LibriSpeech-style .flac corpora. The reference decodes FLAC via
 * soundfile -> libsndfile (asr_train.py:14,141; its LibriSpeech builder emits
 * .flac paths, librispeech_asr.py:264-300); this is the framework's own
 * implementation of the FLAC bitstream format (RFC 9639), written from the
 * spec. Supports CONSTANT / VERBATIM / FIXED(0-4) / LPC(1-32) subframes,
 * Rice/Rice2 partitioned residuals with escape codes, wasted bits,
 * left-side / right-side / mid-side stereo decorrelation, 8/12/16/20/24/32
 * bit depths. Returns mono float32 (channel mean) + sample rate.
 *
 * int tat_flac_decode(data, len, &pcm, &sample_rate, &n, &err): 0 and a
 * malloc'ed float32 buffer of n samples (free it with tat_native_free), or
 * 1 and an error message. ctypes releases the GIL around the call.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* bit reader                                                          */
/* ------------------------------------------------------------------ */

typedef struct {
    const uint8_t *buf;
    size_t len;        /* total bytes */
    size_t pos;        /* next byte index */
    uint64_t acc;      /* bit accumulator, MSB-aligned semantics */
    int nbits;         /* valid bits in acc (low bits) */
    int error;
} BitReader;

static void br_init(BitReader *br, const uint8_t *buf, size_t len) {
    br->buf = buf; br->len = len; br->pos = 0;
    br->acc = 0; br->nbits = 0; br->error = 0;
}

static void br_fill(BitReader *br) {
    while (br->nbits <= 56 && br->pos < br->len) {
        br->acc = (br->acc << 8) | br->buf[br->pos++];
        br->nbits += 8;
    }
}

/* read n (<= 32) bits unsigned */
static uint32_t br_read(BitReader *br, int n) {
    if (n == 0) return 0;
    if (br->nbits < n) {
        br_fill(br);
        if (br->nbits < n) { br->error = 1; return 0; }
    }
    uint32_t v = (uint32_t)((br->acc >> (br->nbits - n)) & ((n == 32) ? 0xFFFFFFFFu : ((1u << n) - 1u)));
    br->nbits -= n;
    return v;
}

/* read n (<= 32) bits signed (two's complement) */
static int64_t br_read_signed(BitReader *br, int n) {
    uint32_t v = br_read(br, n);
    if (n == 0) return 0;
    if (n < 32 && (v & (1u << (n - 1)))) return (int64_t)v - ((int64_t)1 << n);
    if (n == 32) return (int64_t)(int32_t)v;
    return (int64_t)v;
}

/* unary: count 0 bits until a 1 bit */
static uint32_t br_read_unary(BitReader *br) {
    uint32_t q = 0;
    for (;;) {
        if (br->nbits == 0) {
            br_fill(br);
            if (br->nbits == 0) { br->error = 1; return 0; }
        }
        /* scan the accumulator's valid bits for a set bit */
        while (br->nbits > 0) {
            uint64_t bit = (br->acc >> (br->nbits - 1)) & 1u;
            br->nbits--;
            if (bit) return q;
            q++;
        }
    }
}

static void br_align_byte(BitReader *br) {
    br->nbits -= br->nbits & 7;
}

/* byte position for EOF checks (approximate to the byte) */
static size_t br_bytepos(const BitReader *br) {
    return br->pos - (size_t)(br->nbits >> 3);
}

/* ------------------------------------------------------------------ */
/* FLAC structures                                                     */
/* ------------------------------------------------------------------ */

#define FLAC_MAX_CHANNELS 8
#define FLAC_MAX_BLOCK 65535

typedef struct {
    uint32_t sample_rate;
    int channels;
    int bps;
    uint64_t total_samples;
} StreamInfo;

/* skip the UTF-8-extended coded frame/sample number (1-7 bytes) */
static void skip_utf8(BitReader *br) {
    uint32_t b0 = br_read(br, 8);
    int extra = 0;
    if (b0 < 0x80) extra = 0;
    else if ((b0 & 0xE0) == 0xC0) extra = 1;
    else if ((b0 & 0xF0) == 0xE0) extra = 2;
    else if ((b0 & 0xF8) == 0xF0) extra = 3;
    else if ((b0 & 0xFC) == 0xF8) extra = 4;
    else if ((b0 & 0xFE) == 0xFC) extra = 5;
    else if (b0 == 0xFE) extra = 6;
    else { br->error = 1; return; }
    for (int i = 0; i < extra; i++) (void)br_read(br, 8);
}

/* decode one partitioned-Rice residual into res[0..blocksize-order-1] */
static int decode_residual(BitReader *br, int64_t *res, int blocksize, int order) {
    uint32_t method = br_read(br, 2);
    if (method > 1) return -1;
    int plen = method == 0 ? 4 : 5;
    uint32_t escape = method == 0 ? 0xF : 0x1F;
    uint32_t porder = br_read(br, 4);
    uint32_t nparts = 1u << porder;
    if ((blocksize >> porder) == 0) return -1;
    int idx = 0;
    for (uint32_t p = 0; p < nparts; p++) {
        int count = blocksize >> porder;
        if (p == 0) count -= order;
        if (count < 0) return -1;
        uint32_t param = br_read(br, plen);
        if (param == escape) {
            uint32_t nbits = br_read(br, 5);
            for (int i = 0; i < count; i++)
                res[idx++] = nbits ? br_read_signed(br, (int)nbits) : 0;
        } else {
            for (int i = 0; i < count; i++) {
                uint32_t q = br_read_unary(br);
                uint32_t r = param ? br_read(br, (int)param) : 0;
                uint64_t v = ((uint64_t)q << param) | r;
                res[idx++] = (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
            }
        }
        if (br->error) return -1;
    }
    return 0;
}

/* decode one subframe into out[0..blocksize-1]; bps already adjusted for side */
static int decode_subframe(BitReader *br, int64_t *out, int blocksize, int bps) {
    if (br_read(br, 1) != 0) return -1;       /* padding bit */
    uint32_t type = br_read(br, 6);
    int wasted = 0;
    if (br_read(br, 1)) wasted = (int)br_read_unary(br) + 1;
    bps -= wasted;
    if (bps <= 0 || bps > 33) return -1;

    if (type == 0) {                           /* CONSTANT */
        int64_t v = br_read_signed(br, bps);
        for (int i = 0; i < blocksize; i++) out[i] = v;
    } else if (type == 1) {                    /* VERBATIM */
        for (int i = 0; i < blocksize; i++) out[i] = br_read_signed(br, bps);
    } else if ((type & 0x38) == 0x08 && (type & 0x07) <= 4) {   /* FIXED */
        int order = (int)(type & 0x07);
        if (order > blocksize) return -1;
        for (int i = 0; i < order; i++) out[i] = br_read_signed(br, bps);
        if (decode_residual(br, out + order, blocksize, order)) return -1;
        switch (order) {
        case 0: break;
        case 1: for (int i = order; i < blocksize; i++) out[i] += out[i-1]; break;
        case 2: for (int i = order; i < blocksize; i++) out[i] += 2*out[i-1] - out[i-2]; break;
        case 3: for (int i = order; i < blocksize; i++) out[i] += 3*out[i-1] - 3*out[i-2] + out[i-3]; break;
        case 4: for (int i = order; i < blocksize; i++) out[i] += 4*out[i-1] - 6*out[i-2] + 4*out[i-3] - out[i-4]; break;
        }
    } else if (type >= 0x20) {                 /* LPC */
        int order = (int)(type & 0x1F) + 1;
        if (order > blocksize) return -1;
        for (int i = 0; i < order; i++) out[i] = br_read_signed(br, bps);
        uint32_t prec = br_read(br, 4);
        if (prec == 0xF) return -1;
        prec += 1;
        int shift = (int)br_read_signed(br, 5);
        if (shift < 0) return -1;
        int64_t coef[32];
        for (int i = 0; i < order; i++) coef[i] = br_read_signed(br, (int)prec);
        if (decode_residual(br, out + order, blocksize, order)) return -1;
        for (int i = order; i < blocksize; i++) {
            int64_t acc = 0;
            for (int j = 0; j < order; j++) acc += coef[j] * out[i - 1 - j];
            out[i] += acc >> shift;
        }
    } else {
        return -1;                             /* reserved type */
    }
    if (wasted)
        for (int i = 0; i < blocksize; i++) out[i] <<= wasted;
    return br->error ? -1 : 0;
}

static const uint32_t BLOCKSIZE_TABLE[16] = {
    0, 192, 576, 1152, 2304, 4608, 0, 0,
    256, 512, 1024, 2048, 4096, 8192, 16384, 32768};
static const uint32_t SAMPLERATE_TABLE[16] = {
    0, 88200, 176400, 192000, 8000, 16000, 22050, 24000,
    32000, 44100, 48000, 96000, 0, 0, 0, 0};

/* decode the whole stream; returns malloc'd float32 mono + meta, or NULL */
static float *flac_decode(const uint8_t *data, size_t len, uint32_t *out_sr,
                          uint64_t *out_n, const char **err) {
    if (len < 42 || memcmp(data, "fLaC", 4) != 0) { *err = "not a FLAC stream"; return NULL; }
    size_t pos = 4;
    StreamInfo si; memset(&si, 0, sizeof si);
    int have_si = 0, last = 0;
    while (!last) {
        if (pos + 4 > len) { *err = "truncated metadata"; return NULL; }
        last = data[pos] >> 7;
        int btype = data[pos] & 0x7F;
        uint32_t blen = ((uint32_t)data[pos+1] << 16) | ((uint32_t)data[pos+2] << 8) | data[pos+3];
        pos += 4;
        if (pos + blen > len) { *err = "truncated metadata block"; return NULL; }
        if (btype == 0 && blen >= 34) {        /* STREAMINFO */
            const uint8_t *b = data + pos;
            si.sample_rate = ((uint32_t)b[10] << 12) | ((uint32_t)b[11] << 4) | (b[12] >> 4);
            si.channels = ((b[12] >> 1) & 0x7) + 1;
            si.bps = (((b[12] & 1) << 4) | (b[13] >> 4)) + 1;
            si.total_samples = ((uint64_t)(b[13] & 0xF) << 32) | ((uint64_t)b[14] << 24)
                             | ((uint64_t)b[15] << 16) | ((uint64_t)b[16] << 8) | b[17];
            have_si = 1;
        }
        pos += blen;
    }
    if (!have_si || si.sample_rate == 0) { *err = "missing STREAMINFO"; return NULL; }
    if (si.channels > FLAC_MAX_CHANNELS) { *err = "too many channels"; return NULL; }

    /* output: grow as frames arrive (total_samples may be 0 = unknown) */
    uint64_t cap = si.total_samples ? si.total_samples : 1 << 16;
    float *mono = (float *)malloc((size_t)cap * sizeof(float));
    if (!mono) { *err = "oom"; return NULL; }
    uint64_t nout = 0;

    int64_t *ch[FLAC_MAX_CHANNELS];
    for (int c = 0; c < si.channels; c++) {
        ch[c] = (int64_t *)malloc(FLAC_MAX_BLOCK * sizeof(int64_t));
        if (!ch[c]) {
            for (int k = 0; k < c; k++) free(ch[k]);
            free(mono); *err = "oom"; return NULL;
        }
    }

    BitReader br;
    br_init(&br, data + pos, len - pos);
    float scale = 1.0f / (float)((uint64_t)1 << (si.bps - 1));

    while (br_bytepos(&br) < br.len) {
        /* frame header */
        uint32_t sync = br_read(&br, 14);
        if (br.error) break;                   /* clean EOF */
        if (sync != 0x3FFE) { *err = "lost frame sync"; goto fail; }
        (void)br_read(&br, 1);                 /* reserved */
        (void)br_read(&br, 1);                 /* blocking strategy */
        uint32_t bs_code = br_read(&br, 4);
        uint32_t sr_code = br_read(&br, 4);
        uint32_t ch_code = br_read(&br, 4);
        uint32_t ss_code = br_read(&br, 3);
        (void)br_read(&br, 1);                 /* reserved */
        skip_utf8(&br);
        uint32_t blocksize;
        if (bs_code == 6) blocksize = br_read(&br, 8) + 1;
        else if (bs_code == 7) blocksize = br_read(&br, 16) + 1;
        else blocksize = BLOCKSIZE_TABLE[bs_code];
        if (blocksize == 0 || blocksize > FLAC_MAX_BLOCK) { *err = "bad blocksize"; goto fail; }
        if (sr_code == 12) (void)br_read(&br, 8);
        else if (sr_code == 13 || sr_code == 14) (void)br_read(&br, 16);
        else if (sr_code == 15) { *err = "invalid sample-rate code"; goto fail; }
        (void)SAMPLERATE_TABLE[0];
        (void)br_read(&br, 8);                 /* header CRC-8 (not verified) */

        int bps = si.bps;
        switch (ss_code) {
        case 0: break;
        case 1: bps = 8; break;
        case 2: bps = 12; break;
        case 4: bps = 16; break;
        case 5: bps = 20; break;
        case 6: bps = 24; break;
        case 7: bps = 32; break;
        default: *err = "reserved sample size"; goto fail;
        }

        int nch;
        int mode = 0;                          /* 0=indep 1=LS 2=RS 3=MS */
        if (ch_code < 8) nch = (int)ch_code + 1;
        else if (ch_code == 8) { nch = 2; mode = 1; }
        else if (ch_code == 9) { nch = 2; mode = 2; }
        else if (ch_code == 10) { nch = 2; mode = 3; }
        else { *err = "reserved channel assignment"; goto fail; }
        if (nch != si.channels) { *err = "channel count change"; goto fail; }

        for (int c = 0; c < nch; c++) {
            int sub_bps = bps;
            /* the side channel carries one extra bit */
            if ((mode == 1 && c == 1) || (mode == 2 && c == 0) || (mode == 3 && c == 1))
                sub_bps += 1;
            if (decode_subframe(&br, ch[c], (int)blocksize, sub_bps)) {
                *err = "subframe decode error"; goto fail;
            }
        }
        br_align_byte(&br);
        (void)br_read(&br, 16);                /* frame CRC-16 (not verified) */
        if (br.error) { *err = "truncated frame"; goto fail; }

        /* undo stereo decorrelation */
        if (mode == 1) {                       /* left/side: right = left - side */
            for (uint32_t i = 0; i < blocksize; i++) ch[1][i] = ch[0][i] - ch[1][i];
        } else if (mode == 2) {                /* right/side: left = right + side */
            for (uint32_t i = 0; i < blocksize; i++) ch[0][i] = ch[1][i] + ch[0][i];
        } else if (mode == 3) {                /* mid/side */
            for (uint32_t i = 0; i < blocksize; i++) {
                int64_t side = ch[1][i];
                int64_t mid = (ch[0][i] << 1) | (side & 1);
                ch[0][i] = (mid + side) >> 1;
                ch[1][i] = (mid - side) >> 1;
            }
        }

        if (nout + blocksize > cap) {
            while (nout + blocksize > cap) cap *= 2;
            float *grown = (float *)realloc(mono, (size_t)cap * sizeof(float));
            if (!grown) { *err = "oom"; goto fail; }
            mono = grown;
        }
        if (nch == 1) {
            for (uint32_t i = 0; i < blocksize; i++)
                mono[nout + i] = (float)ch[0][i] * scale;
        } else {
            float inv = 1.0f / (float)nch;
            for (uint32_t i = 0; i < blocksize; i++) {
                int64_t s = 0;
                for (int c = 0; c < nch; c++) s += ch[c][i];
                mono[nout + i] = (float)s * scale * inv;
            }
        }
        nout += blocksize;
        if (si.total_samples && nout >= si.total_samples) { nout = si.total_samples; break; }
    }

    for (int c = 0; c < si.channels; c++) free(ch[c]);
    *out_sr = si.sample_rate;
    *out_n = nout;
    return mono;
fail:
    for (int c = 0; c < si.channels; c++) free(ch[c]);
    free(mono);
    return NULL;
}

/* ------------------------------------------------------------------ */
/* C interface                                                         */
/* ------------------------------------------------------------------ */

int tat_flac_decode(const uint8_t *data, int64_t len, float **out_pcm,
                    uint32_t *out_sr, uint64_t *out_n, const char **err) {
    *err = "decode error";
    float *mono = flac_decode(data, (size_t)len, out_sr, out_n, err);
    if (!mono) return 1;
    *out_pcm = mono;
    return 0;
}
