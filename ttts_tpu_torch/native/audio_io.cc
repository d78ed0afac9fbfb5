// Native host-side audio runtime for the data pipeline.
//
// Replaces the reference's library-level native dependencies on the data path
// (SURVEY §2.9): libsndfile/torchaudio WAV decoding (ttts/vqvae/dataset.py:
// 56-72), torchaudio's polyphase sinc resampler, and pydub's
// split_on_silence energy VAD (ttts/prepare/vad_process.py:6-31).
//
// Exposed as a plain C ABI consumed via ctypes (ttts_tpu_torch/data/audio.py).
// Build: make -C ttts_tpu_torch/native
//
// All functions return 0 on success, negative on error.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// WAV decode (PCM 8/16/24/32-bit and float32/float64, any channel count;
// output mono float32 in [-1, 1]).
// ---------------------------------------------------------------------------

struct WavInfo {
  int32_t sample_rate;
  int32_t channels;
  int64_t frames;  // samples per channel
};

static uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
static uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

// Parse header; returns data offset/size + format via out params.
static int wav_parse(const uint8_t* buf, int64_t len, WavInfo* info,
                     int64_t* data_off, int64_t* data_len, int* fmt_code,
                     int* bits) {
  if (len < 44 || memcmp(buf, "RIFF", 4) || memcmp(buf + 8, "WAVE", 4))
    return -1;
  int64_t pos = 12;
  bool have_fmt = false;
  *data_off = -1;
  while (pos + 8 <= len) {
    const uint8_t* ck = buf + pos;
    uint32_t ck_size = rd_u32(ck + 4);
    if (!memcmp(ck, "fmt ", 4) && pos + 8 + 16 <= len) {
      *fmt_code = rd_u16(ck + 8);
      info->channels = rd_u16(ck + 10);
      info->sample_rate = (int32_t)rd_u32(ck + 12);
      *bits = rd_u16(ck + 22);
      // WAVE_FORMAT_EXTENSIBLE: the sub-format lives 24 bytes into the fmt
      // payload — re-check the BUFFER bound, not just the declared ck_size
      // (a truncated/malicious file can claim ck_size >= 40 with fewer bytes)
      if (*fmt_code == 0xFFFE && ck_size >= 40 && pos + 8 + 26 <= len) {
        *fmt_code = rd_u16(ck + 8 + 24);
      }
      have_fmt = true;
    } else if (!memcmp(ck, "data", 4)) {
      *data_off = pos + 8;
      *data_len = std::min<int64_t>(ck_size, len - *data_off);
    }
    pos += 8 + ck_size + (ck_size & 1);
  }
  if (!have_fmt || *data_off < 0) return -2;
  int bytes = *bits / 8;
  if (bytes <= 0 || info->channels <= 0) return -3;
  info->frames = *data_len / (bytes * info->channels);
  return 0;
}

int wav_info_mem(const uint8_t* buf, int64_t len, WavInfo* info) {
  int64_t off, dlen;
  int fmt, bits;
  return wav_parse(buf, len, info, &off, &dlen, &fmt, &bits);
}

// Decode to mono float32; out must hold info.frames floats.
int wav_decode_mono_mem(const uint8_t* buf, int64_t len, float* out) {
  WavInfo info;
  int64_t off, dlen;
  int fmt, bits;
  int rc = wav_parse(buf, len, &info, &off, &dlen, &fmt, &bits);
  if (rc) return rc;
  const uint8_t* d = buf + off;
  const int c = info.channels;
  const double inv_c = 1.0 / c;
  for (int64_t i = 0; i < info.frames; i++) {
    double acc = 0.0;
    for (int ch = 0; ch < c; ch++) {
      const uint8_t* s = d + (i * c + ch) * (bits / 8);
      double v = 0.0;
      if (fmt == 1) {  // PCM
        if (bits == 16) {
          v = (int16_t)rd_u16(s) / 32768.0;
        } else if (bits == 24) {
          int32_t x = (int32_t)((uint32_t)s[0] | ((uint32_t)s[1] << 8) |
                                ((uint32_t)s[2] << 16));
          if (x & 0x800000) x |= 0xFF000000;
          v = x / 8388608.0;
        } else if (bits == 32) {
          v = (int32_t)rd_u32(s) / 2147483648.0;
        } else if (bits == 8) {
          v = ((int)s[0] - 128) / 128.0;
        } else {
          return -4;
        }
      } else if (fmt == 3) {  // IEEE float
        if (bits == 32) {
          float f;
          memcpy(&f, s, 4);
          v = f;
        } else if (bits == 64) {
          double f;
          memcpy(&f, s, 8);
          v = f;
        } else {
          return -4;
        }
      } else {
        return -5;
      }
      acc += v;
    }
    out[i] = (float)(acc * inv_c);
  }
  return 0;
}

// File-based wrappers.
int wav_info(const char* path, WavInfo* info) {
  FILE* f = fopen(path, "rb");
  if (!f) return -10;
  fseek(f, 0, SEEK_END);
  int64_t len = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(len);
  if ((int64_t)fread(buf.data(), 1, len, f) != len) {
    fclose(f);
    return -11;
  }
  fclose(f);
  return wav_info_mem(buf.data(), len, info);
}

int wav_decode_mono(const char* path, float* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -10;
  fseek(f, 0, SEEK_END);
  int64_t len = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(len);
  if ((int64_t)fread(buf.data(), 1, len, f) != len) {
    fclose(f);
    return -11;
  }
  fclose(f);
  return wav_decode_mono_mem(buf.data(), len, out);
}

// PCM16 WAV writer.
int wav_write_pcm16(const char* path, const float* data, int64_t frames,
                    int32_t sample_rate) {
  FILE* f = fopen(path, "wb");
  if (!f) return -10;
  int64_t data_bytes = frames * 2;
  uint8_t hdr[44];
  memcpy(hdr, "RIFF", 4);
  uint32_t riff = (uint32_t)(36 + data_bytes);
  memcpy(hdr + 4, &riff, 4);
  memcpy(hdr + 8, "WAVEfmt ", 8);
  uint32_t fmt_size = 16;
  memcpy(hdr + 16, &fmt_size, 4);
  uint16_t fmt = 1, ch = 1, bits = 16;
  memcpy(hdr + 20, &fmt, 2);
  memcpy(hdr + 22, &ch, 2);
  memcpy(hdr + 24, &sample_rate, 4);
  uint32_t byte_rate = sample_rate * 2;
  memcpy(hdr + 28, &byte_rate, 4);
  uint16_t block = 2;
  memcpy(hdr + 32, &block, 2);
  memcpy(hdr + 34, &bits, 2);
  memcpy(hdr + 36, "data", 4);
  uint32_t dsz = (uint32_t)data_bytes;
  memcpy(hdr + 40, &dsz, 4);
  fwrite(hdr, 1, 44, f);
  std::vector<int16_t> pcm(frames);
  for (int64_t i = 0; i < frames; i++) {
    float v = std::max(-1.0f, std::min(1.0f, data[i]));
    pcm[i] = (int16_t)lrintf(v * 32767.0f);
  }
  fwrite(pcm.data(), 2, frames, f);
  fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// Polyphase windowed-sinc resampler (torchaudio semantics: hann window,
// lowpass_filter_width=6, rolloff 0.99) — same math as ttts_tpu_torch/ops/resample.
// out must hold ceil(frames * new_freq / orig_freq) floats (after gcd).
// ---------------------------------------------------------------------------

static int64_t gcd64(int64_t a, int64_t b) { return b ? gcd64(b, a % b) : a; }

int64_t resample_out_len(int64_t frames, int32_t orig_freq, int32_t new_freq) {
  int64_t g = gcd64(orig_freq, new_freq);
  int64_t o = orig_freq / g, n = new_freq / g;
  return (frames * n + o - 1) / o;
}

int resample_sinc(const float* in, int64_t frames, int32_t orig_freq,
                  int32_t new_freq, float* out) {
  if (orig_freq == new_freq) {
    memcpy(out, in, frames * sizeof(float));
    return 0;
  }
  int64_t g = gcd64(orig_freq, new_freq);
  int64_t o = orig_freq / g, n = new_freq / g;
  const int lpw = 6;
  const double rolloff = 0.99;
  double base_freq = std::min(o, n) / 2.0 * rolloff;
  int64_t width = (int64_t)ceil(lpw * o / base_freq);
  int64_t klen = 2 * width + o;
  // kernel bank: n phases × klen
  std::vector<float> kernel(n * klen);
  for (int64_t ph = 0; ph < n; ph++) {
    for (int64_t j = 0; j < klen; j++) {
      double idx = (double)(j - width) / o;
      double t = -((double)ph) / n + idx;
      t *= base_freq;
      t = std::max(-(double)lpw, std::min((double)lpw, t));
      double window = cos(t * M_PI / lpw / 2.0);
      window *= window;
      double tp = t * M_PI;
      double s = (tp == 0.0) ? 1.0 : sin(tp) / tp;
      kernel[ph * klen + j] = (float)(s * window * (base_freq / o));
    }
  }
  int64_t out_len = (frames * n + o - 1) / o;
  for (int64_t i = 0; i < out_len; i++) {
    int64_t block = i / n;
    int64_t ph = i % n;
    int64_t start = block * o - width;
    double acc = 0.0;
    const float* k = &kernel[ph * klen];
    int64_t j0 = std::max<int64_t>(0, -start);
    int64_t j1 = std::min<int64_t>(klen, frames - start);
    for (int64_t j = j0; j < j1; j++) acc += (double)in[start + j] * k[j];
    out[i] = (float)acc;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Energy VAD: split on silence (pydub split_on_silence semantics:
// min_silence_len ms below threshold dBFS splits; keep_silence padding).
// Returns the number of segments; seg_starts/seg_ends (sample indices) are
// filled up to max_segs.
// ---------------------------------------------------------------------------

int vad_split(const float* in, int64_t frames, int32_t sample_rate,
              int32_t min_silence_ms, float silence_thresh_db,
              int32_t keep_silence_ms, int64_t* seg_starts, int64_t* seg_ends,
              int32_t max_segs) {
  const int64_t win = sample_rate / 100;  // 10 ms windows
  if (win <= 0 || frames < win) return 0;
  int64_t n_win = frames / win;
  std::vector<uint8_t> silent(n_win);
  const double thresh = pow(10.0, silence_thresh_db / 10.0);  // power ratio
  for (int64_t w = 0; w < n_win; w++) {
    double e = 0.0;
    for (int64_t i = 0; i < win; i++) {
      double v = in[w * win + i];
      e += v * v;
    }
    e /= win;
    silent[w] = (e < thresh) ? 1 : 0;
  }
  const int64_t min_sil_win = std::max<int64_t>(1, min_silence_ms / 10);
  const int64_t keep = (int64_t)keep_silence_ms * sample_rate / 1000;
  int32_t count = 0;
  int64_t seg_start = -1;
  int64_t sil_run = 0;
  for (int64_t w = 0; w <= n_win; w++) {
    bool is_sil = (w == n_win) ? true : (silent[w] != 0);
    if (!is_sil) {
      if (seg_start < 0) seg_start = w * win;
      sil_run = 0;
    } else {
      sil_run++;
      if (seg_start >= 0 && (sil_run >= min_sil_win || w == n_win)) {
        int64_t end = (w - sil_run + 1) * win;
        if (count < max_segs) {
          seg_starts[count] = std::max<int64_t>(0, seg_start - keep);
          seg_ends[count] = std::min<int64_t>(frames, end + keep);
          count++;
        }
        seg_start = -1;
      }
    }
  }
  return count;
}

}  // extern "C"
