// K1: fused bias + LeakyReLU(0.2) * sqrt(2), forward.
//
// Replaces the TPU kernel marconet_tpu/ops/fused_act.py::_fwd_kernel
// (launched by _fused_lrelu_fwd through _pallas_elementwise), which is also
// the reference's only native op, basicsr's fused_act.
//
//   y[i] = sqrt(2) * leaky_relu(x[i] + bias[i % C], 0.2)
//
// over a (rows, C) view whose last dimension is the channel: a 2-D tensor,
// or a 4-D NCHW tensor in channels_last memory format (physically NHWC).
//
// Bound: device-memory bytes. Per element it reads x once and writes y once
// (2 * itemsize bytes) for three flops, far below the ~295 flop/byte where
// the H100's arithmetic would become the limit; the bias row is C values
// that stay in L1. The design therefore does only what keeps the bytes
// moving: a grid-stride loop in which neighbouring threads touch
// neighbouring addresses (coalesced), one read and one write per element,
// math in f32 and one rounding on store. Vector loads and fusing the
// activation into the producing conv's epilogue are left to later work.
#include "common.cuh"

namespace marconet {
namespace {

constexpr float kSlope = 0.2f;
constexpr float kGain = 1.41421356237309515f;  // sqrt(2) rounded to f32

template <typename T>
__global__ void fused_lrelu_fwd_kernel(const T* __restrict__ x,
                                       const T* __restrict__ bias,
                                       T* __restrict__ y, int64_t n,
                                       int64_t c) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float v = to_f32(x[i]) + to_f32(bias[i % c]);
    v = v >= 0.f ? v : v * kSlope;
    y[i] = from_f32<T>(v * kGain);
  }
}

template <typename T>
void launch(const void* x, const void* bias, void* y, int64_t n, int64_t c,
            cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  // enough blocks to fill 132 SMs many times over; the loop covers the rest
  const int64_t max_blocks = 132 * 64;
  if (blocks > max_blocks) blocks = max_blocks;
  fused_lrelu_fwd_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bias),
      static_cast<T*>(y), n, c);
}

}  // namespace
}  // namespace marconet

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int marconet_fused_lrelu_fwd(const void* x, const void* bias,
                                        void* y, long long n, long long c,
                                        int dtype, void* stream) {
  using namespace marconet;
  if (n <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      launch<float>(x, bias, y, n, c, s);
      break;
    case kBFloat16:
      launch<__nv_bfloat16>(x, bias, y, n, c, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
