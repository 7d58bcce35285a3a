// OASIS AR(1) spike deconvolution on Hopper, called from JAX through the
// foreign function interface (calciumgan/ops/oasis.py: oasis_spikes).
//
// One thread runs one trace through the exact pool-adjacency machine of
// oasis_ar1.h in float64, the routine the host kernel
// (calciumgan_native.cc) runs, so the card's spikes equal the host's.
// The machine is sequential and data dependent within a trace; across
// traces it is embarrassingly parallel, which is one GPU thread's work.
//
// Layout: signals come in time-major, (T, N), and spikes go out the same
// way, so a warp's loads and stores at frame t coalesce. Each trace's pool
// stack holds up to T pools (no depth cap) in a scratch result laid out
// [depth][trace], so lanes at equal depth also coalesce.
//
// Build: make -C calciumgan/native cuda FFI_INCLUDE=<jax.ffi.include_dir()>

#include <cuda_runtime.h>

#include <cstdint>
#include <string>

#include "oasis_ar1.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

// One warp per block: with few traces (whole recordings) the warps then
// spread over as many SMs as there are warps.
constexpr int kBlock = 32;

struct TimeMajorSignal {
  const float* y;
  int64_t n;
  int64_t i;
  __host__ __device__ double operator()(int64_t t) const {
    return static_cast<double>(y[t * n + i]);
  }
};

struct TimeMajorSpikes {
  int8_t* out;
  int64_t n;
  int64_t i;
  double threshold;
  __host__ __device__ void operator()(int64_t t, double, double s) const {
    out[t * n + i] = s > threshold ? 1 : 0;
  }
};

__global__ void oasis_spikes_kernel(const float* y, int64_t n, int64_t T,
                                    double g, double s_min, double threshold,
                                    double* v, double* w, int32_t* len,
                                    int8_t* out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const CgPoolStack st{v + i, w + i, len + i, n};
  cg_oasis_trace(TimeMajorSignal{y, n, i}, T, g, 0.0, s_min, st,
                 TimeMajorSpikes{out, n, i, threshold});
}

// Scratch bytes for n traces of T frames: v and w (f64) then len (i32).
inline size_t scratch_bytes(int64_t n, int64_t T) {
  return static_cast<size_t>(n) * static_cast<size_t>(T) *
         (2 * sizeof(double) + sizeof(int32_t));
}

ffi::Error OasisSpikesImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> y,
                           ffi::ResultBuffer<ffi::S8> out,
                           ffi::ResultBuffer<ffi::U8> scratch, double g,
                           double s_min, double threshold) {
  const auto dims = y.dimensions();
  if (dims.size() != 2)
    return ffi::Error::InvalidArgument("signals must be (T, N)");
  const int64_t T = dims[0];
  const int64_t n = dims[1];
  if (n == 0 || T == 0) return ffi::Error::Success();
  if (scratch->size_bytes() < scratch_bytes(n, T))
    return ffi::Error::InvalidArgument("scratch result too small");

  auto* base = static_cast<uint8_t*>(scratch->untyped_data());
  auto* v = reinterpret_cast<double*>(base);
  auto* w = v + n * T;
  auto* len = reinterpret_cast<int32_t*>(w + n * T);
  const unsigned blocks = static_cast<unsigned>((n + kBlock - 1) / kBlock);
  oasis_spikes_kernel<<<blocks, kBlock, 0, stream>>>(
      y.typed_data(), n, T, g, s_min, threshold, v, w, len,
      out->typed_data());
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("oasis_spikes_kernel: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(CgOasisSpikes, OasisSpikesImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::S8>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Attr<double>("g")
                                  .Attr<double>("s_min")
                                  .Attr<double>("threshold"));
