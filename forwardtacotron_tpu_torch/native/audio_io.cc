// Native audio IO + quantization for the preprocessing data loader.
//
// The reference leans on C/C++ library dependencies for this work
// (libsndfile via soundfile, numba-jitted librosa load paths — SURVEY.md
// §2.4); this is the framework's own native equivalent: a small,
// dependency-free C++ library exposed through ctypes
// (forwardtacotron_tpu_torch/utils/native_audio.py) that handles the
// host-side hot loop of preprocessing — PCM WAV decode (16/24/32-bit +
// float), linear resampling, peak normalization, mu-law companding and
// label quantization — without touching Python objects per sample.
//
// Build: g++ compiles it at first use (forwardtacotron_tpu_torch/native/
// __init__.py); a missing compiler or a failed build raises.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- WAV IO

struct WavInfo {
  int32_t sample_rate;
  int32_t channels;
  int64_t frames;       // samples per channel
  int32_t format;       // 1 = PCM int, 3 = IEEE float
  int32_t bits;
};

// Parse the RIFF header; returns 0 on success.
static int parse_header(FILE* f, WavInfo* info, long* data_offset,
                        int64_t* data_bytes) {
  char id[5] = {0};
  uint32_t chunk_size = 0;
  if (fread(id, 1, 4, f) != 4 || strncmp(id, "RIFF", 4) != 0) return -1;
  if (fread(&chunk_size, 4, 1, f) != 1) return -1;
  if (fread(id, 1, 4, f) != 4 || strncmp(id, "WAVE", 4) != 0) return -1;

  bool have_fmt = false;
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t sample_rate = 0;
  while (fread(id, 1, 4, f) == 4) {
    if (fread(&chunk_size, 4, 1, f) != 1) return -1;
    if (strncmp(id, "fmt ", 4) == 0) {
      uint8_t buf[40];
      size_t n = chunk_size < sizeof(buf) ? chunk_size : sizeof(buf);
      if (fread(buf, 1, n, f) != n) return -1;
      if (chunk_size > n) fseek(f, chunk_size - n, SEEK_CUR);
      fmt = *reinterpret_cast<uint16_t*>(buf + 0);
      channels = *reinterpret_cast<uint16_t*>(buf + 2);
      sample_rate = *reinterpret_cast<uint32_t*>(buf + 4);
      bits = *reinterpret_cast<uint16_t*>(buf + 14);
      if (fmt == 0xFFFE && chunk_size >= 40) {  // WAVE_FORMAT_EXTENSIBLE
        fmt = *reinterpret_cast<uint16_t*>(buf + 24);
      }
      have_fmt = true;
    } else if (strncmp(id, "data", 4) == 0) {
      if (!have_fmt) return -1;
      *data_offset = ftell(f);
      *data_bytes = chunk_size;
      info->sample_rate = static_cast<int32_t>(sample_rate);
      info->channels = channels;
      info->format = fmt;
      info->bits = bits;
      info->frames = static_cast<int64_t>(chunk_size) /
                     (channels * (bits / 8));
      return 0;
    } else {
      fseek(f, chunk_size + (chunk_size & 1), SEEK_CUR);
    }
  }
  return -1;
}

// Query the frame count (after channel mixdown) so the caller can
// allocate the output buffer.
int64_t wav_num_frames(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  long off;
  int64_t bytes;
  int rc = parse_header(f, &info, &off, &bytes);
  fclose(f);
  return rc == 0 ? info.frames : -1;
}

int32_t wav_sample_rate(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  long off;
  int64_t bytes;
  int rc = parse_header(f, &info, &off, &bytes);
  fclose(f);
  return rc == 0 ? info.sample_rate : -1;
}

// Decode to float32 mono in [-1, 1]. Returns frames written or -1.
int64_t wav_read_float(const char* path, float* out, int64_t capacity) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  long off;
  int64_t bytes;
  if (parse_header(f, &info, &off, &bytes) != 0) { fclose(f); return -1; }
  if (info.frames > capacity) { fclose(f); return -1; }
  fseek(f, off, SEEK_SET);

  const int ch = info.channels;
  const int64_t n = info.frames;
  std::vector<uint8_t> raw(static_cast<size_t>(bytes));
  if (fread(raw.data(), 1, raw.size(), f) != raw.size()) {
    fclose(f);
    return -1;
  }
  fclose(f);

  const double inv_ch = 1.0 / ch;
  if (info.format == 1 && info.bits == 16) {
    const int16_t* p = reinterpret_cast<const int16_t*>(raw.data());
    for (int64_t i = 0; i < n; ++i) {
      double acc = 0;
      for (int c = 0; c < ch; ++c) acc += p[i * ch + c];
      out[i] = static_cast<float>(acc * inv_ch / 32768.0);
    }
  } else if (info.format == 1 && info.bits == 24) {
    const uint8_t* p = raw.data();
    for (int64_t i = 0; i < n; ++i) {
      double acc = 0;
      for (int c = 0; c < ch; ++c) {
        const uint8_t* s = p + (i * ch + c) * 3;
        int32_t v = (s[0] << 8) | (s[1] << 16) |
                    (static_cast<int32_t>(static_cast<int8_t>(s[2])) << 24);
        acc += v >> 8;
      }
      out[i] = static_cast<float>(acc * inv_ch / 8388608.0);
    }
  } else if (info.format == 1 && info.bits == 32) {
    const int32_t* p = reinterpret_cast<const int32_t*>(raw.data());
    for (int64_t i = 0; i < n; ++i) {
      double acc = 0;
      for (int c = 0; c < ch; ++c) acc += p[i * ch + c];
      out[i] = static_cast<float>(acc * inv_ch / 2147483648.0);
    }
  } else if (info.format == 3 && info.bits == 32) {
    const float* p = reinterpret_cast<const float*>(raw.data());
    for (int64_t i = 0; i < n; ++i) {
      double acc = 0;
      for (int c = 0; c < ch; ++c) acc += p[i * ch + c];
      out[i] = static_cast<float>(acc * inv_ch);
    }
  } else {
    return -1;
  }
  return n;
}

// Write float32 mono as 16-bit PCM. Returns 0 on success.
int wav_write_pcm16(const char* path, const float* data, int64_t n,
                    int32_t sample_rate) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  uint32_t data_bytes = static_cast<uint32_t>(n * 2);
  uint32_t riff = 36 + data_bytes;
  uint16_t fmt = 1, ch = 1, bits = 16, block = 2;
  uint32_t byte_rate = sample_rate * 2;
  uint32_t fmt_size = 16;
  fwrite("RIFF", 1, 4, f);
  fwrite(&riff, 4, 1, f);
  fwrite("WAVE", 1, 4, f);
  fwrite("fmt ", 1, 4, f);
  fwrite(&fmt_size, 4, 1, f);
  fwrite(&fmt, 2, 1, f);
  fwrite(&ch, 2, 1, f);
  fwrite(&sample_rate, 4, 1, f);
  fwrite(&byte_rate, 4, 1, f);
  fwrite(&block, 2, 1, f);
  fwrite(&bits, 2, 1, f);
  fwrite("data", 1, 4, f);
  fwrite(&data_bytes, 4, 1, f);
  std::vector<int16_t> pcm(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    float v = data[i];
    if (v > 1.f) v = 1.f;
    if (v < -1.f) v = -1.f;
    pcm[static_cast<size_t>(i)] = static_cast<int16_t>(lrintf(v * 32767.f));
  }
  fwrite(pcm.data(), 2, pcm.size(), f);
  fclose(f);
  return 0;
}

// ------------------------------------------------------- resample / DSP

// Polyphase-free linear resampler (preprocessing-quality; the mel/FFT
// band-limiting downstream dominates).  out must hold
// ceil(n * out_rate / in_rate) samples.  Returns output length.
int64_t resample_linear(const float* in, int64_t n, int32_t in_rate,
                        int32_t out_rate, float* out) {
  if (in_rate == out_rate) {
    memcpy(out, in, sizeof(float) * static_cast<size_t>(n));
    return n;
  }
  const double ratio = static_cast<double>(in_rate) / out_rate;
  const int64_t m = static_cast<int64_t>(
      static_cast<double>(n) * out_rate / in_rate);
  for (int64_t i = 0; i < m; ++i) {
    const double pos = i * ratio;
    const int64_t i0 = static_cast<int64_t>(pos);
    const int64_t i1 = i0 + 1 < n ? i0 + 1 : n - 1;
    const double frac = pos - i0;
    out[i] = static_cast<float>(in[i0] * (1.0 - frac) + in[i1] * frac);
  }
  return m;
}

// mu-law companding to integer labels (reference utils/dsp.py:149-153).
void encode_mu_law(const float* x, int64_t n, int32_t mu, int32_t* out) {
  const double mu1 = mu - 1;
  const double denom = log(1.0 + mu1);
  for (int64_t i = 0; i < n; ++i) {
    const double v = x[i];
    const double fx =
        (v >= 0 ? 1.0 : -1.0) * log(1.0 + mu1 * fabs(v)) / denom;
    out[i] = static_cast<int32_t>(floor((fx + 1.0) / 2.0 * mu1 + 0.5));
  }
}

// linear label quantization (reference utils/dsp.py:143-147).
void float_to_label(const float* x, int64_t n, int32_t bits, int32_t* out) {
  const double scale = (pow(2.0, bits) - 1.0) / 2.0;
  const double maxv = pow(2.0, bits) - 1.0;
  for (int64_t i = 0; i < n; ++i) {
    double v = (x[i] + 1.0) * scale;
    if (v < 0) v = 0;
    if (v > maxv) v = maxv;
    out[i] = static_cast<int32_t>(v);
  }
}

// peak normalize in place; returns the peak.
float peak_normalize(float* x, int64_t n, int always) {
  float peak = 0.f;
  for (int64_t i = 0; i < n; ++i) {
    const float a = fabsf(x[i]);
    if (a > peak) peak = a;
  }
  if (peak > 0.f && (always || peak > 1.f)) {
    const float inv = 1.f / peak;
    for (int64_t i = 0; i < n; ++i) x[i] *= inv;
  }
  return peak;
}

}  // extern "C"
