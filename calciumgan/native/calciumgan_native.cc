// Native host-side kernels for CalciumGAN, exposed via ctypes.
//
// Contents:
//  - crc32c (Castagnoli, slice-by-8): record framing checksums for the
//    TFRecord container (calciumgan/data/tfrecord.py).
//  - oasis_ar1 / deconvolve_batch / oasis_batch: OASIS AR(1) spike
//    deconvolution, the per-trace routine of oasis_ar1.h (shared with the
//    GPU kernel in oasis_cuda.cu) fanned over OpenMP threads. This is the
//    CPU path and the f64 reference the GPU kernel is checked against.
//  - ar1_filter_batch: spikes -> calcium AR(1)/AR(2) synthesis (the DG
//    generators' hot loop).
//
// Build: make -C calciumgan/native  (produces libcalciumgan_native.so)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include "oasis_ar1.h"

extern "C" {

// ---------------------------------------------------------------------------
// crc32c
// ---------------------------------------------------------------------------

// Table construction runs inside a C++11 magic static (thread-safe,
// guaranteed-once): ctypes releases the GIL during calls and the record
// codec hashes from prefetch/sweep threads concurrently — a plain
// check-then-set flag could serve a partially built table to the second
// thread in.
struct CrcTables {
  uint32_t t[8][256];
  CrcTables() {
    const uint32_t poly = 0x82F63B78u;
    for (int i = 0; i < 256; ++i) {
      uint32_t c = static_cast<uint32_t>(i);
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ poly : c >> 1;
      t[0][i] = c;
    }
    for (int s = 1; s < 8; ++s) {
      for (int i = 0; i < 256; ++i) {
        uint32_t c = t[s - 1][i];
        t[s][i] = t[0][c & 0xFF] ^ (c >> 8);
      }
    }
  }
};

static const uint32_t (&crc_tables_ref())[8][256] {
  static const CrcTables tables;  // magic static: thread-safe init
  return tables.t;
}

uint32_t cg_crc32c(const uint8_t* data, uint64_t n) {
  const uint32_t (&crc_tables)[8][256] = crc_tables_ref();
  uint32_t crc = 0xFFFFFFFFu;
  uint64_t i = 0;
  // align + slice-by-8
  while (n - i >= 8) {
    uint32_t lo;
    uint32_t hi;
    std::memcpy(&lo, data + i, 4);
    std::memcpy(&hi, data + i + 4, 4);
    lo ^= crc;
    crc = crc_tables[7][lo & 0xFF] ^ crc_tables[6][(lo >> 8) & 0xFF] ^
          crc_tables[5][(lo >> 16) & 0xFF] ^ crc_tables[4][(lo >> 24) & 0xFF] ^
          crc_tables[3][hi & 0xFF] ^ crc_tables[2][(hi >> 8) & 0xFF] ^
          crc_tables[1][(hi >> 16) & 0xFF] ^ crc_tables[0][(hi >> 24) & 0xFF];
    i += 8;
  }
  for (; i < n; ++i) crc = (crc >> 8) ^ crc_tables[0][(crc ^ data[i]) & 0xFF];
  return crc ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
// OASIS AR(1)
// ---------------------------------------------------------------------------

namespace {

struct HostSignal {
  const double* y;
  double operator()(int64_t t) const { return y[t]; }
};

struct HostFloatSignal {
  const float* y;
  double operator()(int64_t t) const { return static_cast<double>(y[t]); }
};

struct CalciumSpikeSink {
  double* c;
  double* s;
  void operator()(int64_t t, double ct, double st) const {
    c[t] = ct;
    s[t] = st;
  }
};

struct BinarySink {
  float* out;
  double threshold;
  void operator()(int64_t t, double, double st) const {
    out[t] = st > threshold ? 1.0f : 0.0f;
  }
};

// Per-thread pool stack scratch for traces of length T.
struct HostStack {
  std::vector<double> v, w;
  std::vector<int32_t> len;
  explicit HostStack(int64_t T) : v(T), w(T), len(T) {}
  CgPoolStack view() { return CgPoolStack{v.data(), w.data(), len.data(), 1}; }
};

}  // namespace

// Single trace; c and s must hold T doubles.
void cg_oasis_ar1(const double* y, int64_t T, double g, double lam,
                  double s_min, double* c, double* s) {
  HostStack st(T);
  cg_oasis_trace(HostSignal{y}, T, g, lam, s_min, st.view(),
                 CalciumSpikeSink{c, s});
}

// Batched: signals (N, T) float32 row-major -> binary spikes (N, T) float32
// thresholded at `threshold` (the reference pipeline recipe:
// spike_helper.py:23-29). OpenMP across traces.
void cg_deconvolve_batch(const float* signals, int64_t N, int64_t T, double g,
                         double s_min, double threshold, float* out) {
#pragma omp parallel
  {
    HostStack st(T);
#pragma omp for schedule(dynamic, 1)
    for (int64_t i = 0; i < N; ++i)
      cg_oasis_trace(HostFloatSignal{signals + i * T}, T, g, 0.0, s_min,
                     st.view(), BinarySink{out + i * T, threshold});
  }
}

// Batched raw (c, s) output in float64, for spike_train_inference parity.
void cg_oasis_batch(const double* signals, int64_t N, int64_t T, double g,
                    double lam, double s_min, double* c_out, double* s_out) {
#pragma omp parallel
  {
    HostStack st(T);
#pragma omp for schedule(dynamic, 1)
    for (int64_t i = 0; i < N; ++i)
      cg_oasis_trace(HostSignal{signals + i * T}, T, g, lam, s_min,
                     st.view(), CalciumSpikeSink{c_out + i * T,
                                                 s_out + i * T});
  }
}

// ---------------------------------------------------------------------------
// spikes -> calcium AR filter (reference generate_dg_data.py:54-70:
// recurrence starts at t=2)
// ---------------------------------------------------------------------------

void cg_ar_filter_batch(float* x, int64_t N, int64_t T, double g1, double g2,
                        int32_t order) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < N; ++i) {
    float* row = x + i * T;
    if (order == 1) {
      for (int64_t t = 2; t < T; ++t)
        row[t] += static_cast<float>(g1 * row[t - 1]);
    } else {
      for (int64_t t = 2; t < T; ++t)
        row[t] +=
            static_cast<float>(g1 * row[t - 1] + g2 * row[t - 2]);
    }
  }
}

}  // extern "C"
