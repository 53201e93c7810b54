// K1 and K1b: fused bias + LeakyReLU(0.2) * sqrt(2), forward and backward.
//
// K1 replaces the TPU kernel marconet_tpu/ops/fused_act.py::_fwd_kernel
// (launched by _fused_lrelu_fwd through _pallas_elementwise), K1b the TPU
// kernel _bwd_kernel (launched by _fused_lrelu_bwd, the custom VJP); the
// pair is also the reference's only native op, basicsr's fused_act.
//
//   K1:  y[i]  = sqrt(2) * leaky_relu(x[i] + bias[i % C], 0.2)
//   K1b: dx[i] = (x[i] + bias[i % C] >= 0 ? sqrt(2) : 0.2 * sqrt(2)) * g[i]
//
// over a (rows, C) view whose last dimension is the channel: a 2-D tensor,
// or a 4-D NCHW tensor in channels_last memory format (physically NHWC).
// The bias gradient (a sum of dx over rows) is taken outside the kernel,
// as the JAX package does.
//
// Bound: device-memory bytes. Per element K1 reads x once and writes y once
// (2 * itemsize bytes), K1b reads x and g and writes dx (3 * itemsize), for
// a handful of flops, far below the ~295 flop/byte where the H100's
// arithmetic would become the limit; the bias row is C values that stay in
// L1. The design therefore does only what keeps the bytes moving: a
// grid-stride loop in which neighbouring threads touch neighbouring
// addresses (coalesced), one read of each input and one write per element,
// math in f32 and one rounding on store. Vector loads and fusing the
// activation into the producing conv's epilogue are left to later work.
#include "common.cuh"

namespace marconet {
namespace {

constexpr float kSlope = 0.2f;
constexpr float kGain = 1.41421356237309515f;  // sqrt(2) rounded to f32
// 0.2 * sqrt(2) taken in double, then rounded to f32 (as the JAX kernel's
// Python constant negative_slope * scale is)
constexpr float kGainNeg = (float)(0.2 * 1.41421356237309515);

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
__global__ void fused_lrelu_bwd_kernel(const T* __restrict__ x,
                                       const T* __restrict__ bias,
                                       const T* __restrict__ g,
                                       T* __restrict__ dx, int64_t n,
                                       int64_t c) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float v = to_f32(x[i]) + to_f32(bias[i % c]);
    const float gain = v >= 0.f ? kGain : kGainNeg;
    dx[i] = from_f32<T>(gain * to_f32(g[i]));
  }
}

constexpr int kThreads = 256;

// enough blocks to fill 132 SMs many times over; the loop covers the rest
unsigned grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t max_blocks = 132 * 64;
  return (unsigned)(blocks > max_blocks ? max_blocks : blocks);
}

template <typename T>
void launch(const void* x, const void* bias, void* y, int64_t n, int64_t c,
            cudaStream_t stream) {
  fused_lrelu_fwd_kernel<T><<<grid_for(n), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bias),
      static_cast<T*>(y), n, c);
}

template <typename T>
void launch_bwd(const void* x, const void* bias, const void* g, void* dx,
                int64_t n, int64_t c, cudaStream_t stream) {
  fused_lrelu_bwd_kernel<T><<<grid_for(n), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bias),
      static_cast<const T*>(g), static_cast<T*>(dx), n, c);
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

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int marconet_fused_lrelu_bwd(const void* x, const void* bias,
                                        const void* g, void* dx, long long n,
                                        long long c, int dtype,
                                        void* stream) {
  using namespace marconet;
  if (n <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      launch_bwd<float>(x, bias, g, dx, n, c, s);
      break;
    case kBFloat16:
      launch_bwd<__nv_bfloat16>(x, bias, g, dx, n, c, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
