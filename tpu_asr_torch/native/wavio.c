/* Native WAV decoder: the port's copy of native/wavio.c with a plain C
 * interface, loaded by ctypes (tpu_asr_torch/native/__init__.py) instead of
 * the CPython C API. Parses RIFF/WAVE containers (PCM 8/16/24/32-bit and
 * IEEE float32/64, WAVE_FORMAT_EXTENSIBLE) and converts to mono float32 in
 * [-1, 1] with channel-mean mixdown; the arithmetic is the original's.
 *
 * int tat_wav_decode(data, len, &pcm, &sample_rate, &n, &err): 0 and a
 * malloc'ed float32 buffer of n frames (free it with tat_native_free), or
 * 1 and an error message.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static uint32_t rd_u32(const uint8_t *p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
}
static uint16_t rd_u16(const uint8_t *p) {
    return (uint16_t)((uint16_t)p[0] | ((uint16_t)p[1] << 8));
}

int tat_wav_decode(const uint8_t *data, int64_t len, float **out_pcm,
                   uint32_t *out_sr, uint64_t *out_n, const char **err) {

    if (len < 12 || memcmp(data, "RIFF", 4) != 0 ||
        memcmp(data + 8, "WAVE", 4) != 0) {
        *err = "not a RIFF/WAVE file";
        return 1;
    }

    uint16_t audio_format = 0, n_channels = 0, bits = 0;
    uint32_t sample_rate = 0;
    const uint8_t *payload = NULL;
    uint32_t payload_len = 0;

    int64_t pos = 12;
    while (pos + 8 <= len) {
        const uint8_t *cid = data + pos;
        uint32_t csize = rd_u32(data + pos + 4);
        if (pos + 8 + (int64_t)csize > len)
            csize = (uint32_t)(len - pos - 8);
        if (memcmp(cid, "fmt ", 4) == 0 && csize >= 16) {
            const uint8_t *f = data + pos + 8;
            audio_format = rd_u16(f);
            n_channels = rd_u16(f + 2);
            sample_rate = rd_u32(f + 4);
            bits = rd_u16(f + 14);
            if (audio_format == 0xFFFE && csize >= 24 + 2)
                audio_format = rd_u16(f + 24);  /* extensible: subformat tag */
        } else if (memcmp(cid, "data", 4) == 0) {
            payload = data + pos + 8;
            payload_len = csize;
        }
        pos += 8 + csize + (csize & 1);
    }

    if (!payload || !n_channels || !sample_rate ||
        !(audio_format == 1 || audio_format == 3)) {
        *err = "unsupported or malformed wav";
        return 1;
    }

    uint32_t bytes_per = bits / 8;
    if (bytes_per == 0 || (audio_format == 1 && bits != 8 && bits != 16 &&
                           bits != 24 && bits != 32) ||
        (audio_format == 3 && bits != 32 && bits != 64)) {
        *err = "unsupported wav bit depth";
        return 1;
    }

    uint32_t n_frames = payload_len / (bytes_per * n_channels);
    float *dst = (float *)malloc((size_t)n_frames * 4 + 4);
    if (!dst) { *err = "out of memory"; return 1; }

    for (uint32_t i = 0; i < n_frames; i++) {
        double acc = 0.0;
        for (uint16_t c = 0; c < n_channels; c++) {
            const uint8_t *s = payload + ((size_t)i * n_channels + c) * bytes_per;
            double v = 0.0;
            if (audio_format == 1) {
                if (bits == 8) {
                    v = ((double)s[0] - 128.0) / 128.0;
                } else if (bits == 16) {
                    int16_t x = (int16_t)rd_u16(s);
                    v = (double)x / 32768.0;
                } else if (bits == 24) {
                    int32_t x = (int32_t)((uint32_t)s[0] | ((uint32_t)s[1] << 8) |
                                          ((uint32_t)s[2] << 16));
                    if (x & 0x800000) x -= 0x1000000;
                    v = (double)x / 8388608.0;
                } else { /* 32 */
                    int32_t x = (int32_t)rd_u32(s);
                    v = (double)x / 2147483648.0;
                }
            } else { /* IEEE float */
                if (bits == 32) {
                    float fv; memcpy(&fv, s, 4); v = (double)fv;
                } else {
                    double dv; memcpy(&dv, s, 8); v = dv;
                }
            }
            acc += v;
        }
        dst[i] = (float)(acc / (double)n_channels);
    }

    *out_pcm = dst;
    *out_sr = sample_rate;
    *out_n = n_frames;
    return 0;
}

void tat_native_free(void *p) { free(p); }
