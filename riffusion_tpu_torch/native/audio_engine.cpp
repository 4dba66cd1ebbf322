// Native host-side audio kernels for riffusion_tpu_torch: polyphase
// resampling, crossfaded concatenation and dynamic range compression.
//
// A copy of riffusion_tpu/native/audio_engine.cpp; everything from the first
// #include on is the same text (tests/test_torch_native.py holds it so), so
// both packages compute the same samples. Exposed through a C ABI and loaded
// with ctypes (riffusion_tpu_torch/audio/native.py). All functions operate
// on interleaved int16 PCM in (samples, channels) layout.
//
// Build: audio/native.py builds it on first use into native/build/ with
// g++ -O3 -fPIC -std=c++17 -shared -ffp-contract=off (no fused multiply-add,
// so hosts with FMA give the same bits as hosts without).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

inline int16_t clip16(double v) {
  if (v > 32767.0) return 32767;
  if (v < -32768.0) return -32768;
  return static_cast<int16_t>(std::lround(v));
}

inline int64_t gcd64(int64_t a, int64_t b) {
  while (b) {
    int64_t t = a % b;
    a = b;
    b = t;
  }
  return a;
}

}  // namespace

extern "C" {

// Polyphase windowed-sinc resampler (Kaiser window, beta=8.555 ~ 80 dB
// stopband). Semantics match scipy.signal.resample_poly's output length:
// out_len = ceil(n * up / down). Returns the number of output samples written,
// or -1 on error. `out` must have room for out_len * channels int16s.
int64_t rf_resample_poly_int16(const int16_t* in, int64_t n, int32_t channels,
                               int64_t rate_in, int64_t rate_out, int16_t* out) {
  if (n <= 0 || channels <= 0 || rate_in <= 0 || rate_out <= 0) return -1;
  const int64_t g = gcd64(rate_in, rate_out);
  const int64_t up = rate_out / g;
  const int64_t down = rate_in / g;
  const int64_t out_len = (n * up + down - 1) / down;

  if (up == 1 && down == 1) {
    std::memcpy(out, in, sizeof(int16_t) * n * channels);
    return n;
  }

  // Low-pass at min(1/up, 1/down) * Nyquist. Half-width in input samples:
  const double cutoff = 1.0 / static_cast<double>(std::max(up, down));
  const int64_t half_taps_up = 10 * std::max(up, down);  // taps in upsampled domain
  const double beta = 8.555;

  // Kaiser window via I0.
  auto bessel_i0 = [](double x) {
    double sum = 1.0, term = 1.0;
    for (int k = 1; k < 64; ++k) {
      term *= (x / (2.0 * k)) * (x / (2.0 * k));
      sum += term;
      if (term < 1e-16 * sum) break;
    }
    return sum;
  };
  const double i0_beta = bessel_i0(beta);

  // h[j] evaluated lazily per output sample would be O(n*taps); instead build
  // the polyphase filter bank once: phase p, tap t -> coefficient.
  const int64_t taps_per_phase = 2 * (half_taps_up / up) + 1;
  std::vector<double> bank(static_cast<size_t>(up) * taps_per_phase);
  for (int64_t p = 0; p < up; ++p) {
    for (int64_t t = 0; t < taps_per_phase; ++t) {
      // Index in the upsampled-domain prototype filter.
      const int64_t j = (t - taps_per_phase / 2) * up + p;
      const double x = static_cast<double>(j);
      const double arg = x * cutoff;
      double sinc = (j == 0) ? 1.0 : std::sin(kPi * arg) / (kPi * arg);
      const double w_arg = x / static_cast<double>(half_taps_up);
      double window = 0.0;
      if (std::abs(w_arg) <= 1.0) {
        window = bessel_i0(beta * std::sqrt(1.0 - w_arg * w_arg)) / i0_beta;
      }
      bank[static_cast<size_t>(p) * taps_per_phase + t] = sinc * cutoff * up * window;
    }
  }

  for (int64_t i = 0; i < out_len; ++i) {
    // Output sample i sits at upsampled index i*down = m*up + p.
    const int64_t m = (i * down) / up;     // center input sample
    const int64_t p = (i * down) % up;     // polyphase index
    const double* h = &bank[static_cast<size_t>(p) * taps_per_phase];
    for (int32_t c = 0; c < channels; ++c) {
      double acc = 0.0;
      for (int64_t t = 0; t < taps_per_phase; ++t) {
        const int64_t k = m - (t - taps_per_phase / 2);
        if (k < 0 || k >= n) continue;
        acc += h[t] * static_cast<double>(in[k * channels + c]);
      }
      out[i * channels + c] = clip16(acc);
    }
  }
  return out_len;
}

// Concatenate a and b with a linear-amplitude crossfade over `xf` samples.
// out must hold (na + nb - xf) * channels samples.
void rf_crossfade_concat_int16(const int16_t* a, int64_t na, const int16_t* b,
                               int64_t nb, int32_t channels, int64_t xf,
                               int16_t* out) {
  const int64_t head = na - xf;
  std::memcpy(out, a, sizeof(int16_t) * head * channels);
  for (int64_t i = 0; i < xf; ++i) {
    const double t = (xf > 1) ? static_cast<double>(i) / static_cast<double>(xf) : 1.0;
    for (int32_t c = 0; c < channels; ++c) {
      const double va = static_cast<double>(a[(head + i) * channels + c]) * (1.0 - t);
      const double vb = static_cast<double>(b[i * channels + c]) * t;
      out[(head + i) * channels + c] = clip16(va + vb);
    }
  }
  std::memcpy(out + (na)*channels, b + xf * channels,
              sizeof(int16_t) * (nb - xf) * channels);
}

// Dynamic range compressor (feed-forward, RMS detector with attack/release
// smoothing). Equivalent capability to pydub.effects.compress_dynamic_range
// (which the reference measured at ~1.7 s on CPU; audio_util.py:55) but
// single-pass native. In-place on a copy written to `out`.
void rf_compress_dynamic_range_int16(const int16_t* in, int64_t n,
                                     int32_t channels, double rate,
                                     double threshold_db, double ratio,
                                     double attack_ms, double release_ms,
                                     int16_t* out) {
  const double attack_coeff = std::exp(-1.0 / (rate * attack_ms / 1000.0));
  const double release_coeff = std::exp(-1.0 / (rate * release_ms / 1000.0));
  double env_db = -120.0;
  for (int64_t i = 0; i < n; ++i) {
    double peak = 0.0;
    for (int32_t c = 0; c < channels; ++c) {
      peak = std::max(peak, std::abs(static_cast<double>(in[i * channels + c])));
    }
    const double level_db =
        (peak > 0.0) ? 20.0 * std::log10(peak / 32767.0) : -120.0;
    if (level_db > env_db) {
      env_db = attack_coeff * env_db + (1.0 - attack_coeff) * level_db;
    } else {
      env_db = release_coeff * env_db + (1.0 - release_coeff) * level_db;
    }
    double gain_db = 0.0;
    if (env_db > threshold_db) {
      gain_db = (threshold_db + (env_db - threshold_db) / ratio) - env_db;
    }
    const double gain = std::pow(10.0, gain_db / 20.0);
    for (int32_t c = 0; c < channels; ++c) {
      out[i * channels + c] =
          clip16(static_cast<double>(in[i * channels + c]) * gain);
    }
  }
}

}  // extern "C"
