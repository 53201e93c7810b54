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
// L1. What the designs do about it:
//
// * Both move 16 bytes per access, with one design. Each thread owns one
//   16-byte pack of channels (8 bf16 or 4 f32) of the (rows, C) view: it
//   loads that slice of the bias into registers once, then walks down the
//   rows with one uint4 load of x (and, in K1b, one of g) and one store a
//   row, four rows in flight. A 2-D layout of each block (channel packs
//   across, rows down) fixes the channel offset once per thread, so there
//   is no per-element division, and the grid is sized from the SM count.
//   Where C is not a multiple of the pack or a pointer is not 16-byte
//   aligned, the same kernel runs with a pack of one element.
//
//   K1 took this design first (44% -> 83% of its bound in bf16 on an H100
//   80GB HBM3 at 700 W). K1b was a scalar grid-stride loop with a 64-bit
//   i % C per element and 2-byte accesses; in bf16 it ran at its f32 time,
//   0.2846 ms at (32, 128, 128, 128) against a 0.1202 ms bound (42%):
//   per-element work, not bytes, set it. Now it shares K1's traversal.
//
#include "common.cuh"

namespace marconet {
namespace {

constexpr float kSlope = 0.2f;
constexpr float kGain = 1.41421356237309515f;  // sqrt(2) rounded to f32
// 0.2 * sqrt(2) taken in double, then rounded to f32 (as the JAX kernel's
// Python constant negative_slope * scale is)
constexpr float kGainNeg = (float)(0.2 * 1.41421356237309515);

constexpr int kThreads = 256;
constexpr int kRowsInFlight = 4;

template <typename T>
__device__ __forceinline__ T lrelu_gain(T x, float b) {
  float v = to_f32(x) + b;
  v = v >= 0.f ? v : v * kSlope;
  return from_f32<T>(v * kGain);
}

template <typename T, int kVec>
__device__ __forceinline__ Pack<T, kVec> lrelu_gain(const Pack<T, kVec>& x,
                                                    const float (&b)[kVec]) {
  Pack<T, kVec> y;
#pragma unroll
  for (int q = 0; q < kVec; ++q) y.e[q] = lrelu_gain(x.e[q], b[q]);
  return y;
}

template <typename T, int kVec>
__device__ __forceinline__ Pack<T, kVec> lrelu_grad(const Pack<T, kVec>& x,
                                                    const float (&b)[kVec],
                                                    const Pack<T, kVec>& g) {
  Pack<T, kVec> dx;
#pragma unroll
  for (int q = 0; q < kVec; ++q) {
    const float gain = to_f32(x.e[q]) + b[q] >= 0.f ? kGain : kGainNeg;
    dx.e[q] = from_f32<T>(gain * to_f32(g.e[q]));
  }
  return dx;
}

// K1 (y = lrelu_gain(x)) or K1b (y = lrelu_grad(x, g)); x, g and y are
// (rows, packs) arrays of packs. A block is cols x (256 / cols) threads
// over channel packs x rows, and blockIdx.y picks the block's cols packs
// when a row has more than 256.
template <typename T, int kVec, bool kBwd>
__device__ __forceinline__ void lrelu_rows(
    const Pack<T, kVec>* __restrict__ x, const T* __restrict__ bias,
    const Pack<T, kVec>* __restrict__ g, Pack<T, kVec>* __restrict__ y,
    int64_t rows, int packs, int cols) {
  const int col = blockIdx.y * cols + threadIdx.x % cols;
  const int block_rows = kThreads / cols;
  const int r0 = threadIdx.x / cols;
  if (r0 >= block_rows || col >= packs) return;
  float b[kVec];
#pragma unroll
  for (int q = 0; q < kVec; ++q) b[q] = to_f32(bias[col * kVec + q]);
  const int64_t row_step = (int64_t)gridDim.x * block_rows;
  const int64_t step = row_step * packs;   // in packs
  int64_t r = (int64_t)blockIdx.x * block_rows + r0;
  int64_t i = r * packs + col;
  for (; r + (kRowsInFlight - 1) * row_step < rows;
       r += kRowsInFlight * row_step, i += kRowsInFlight * step) {
    Pack<T, kVec> v[kRowsInFlight], w[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      v[u] = x[i + u * step];
      if constexpr (kBwd) w[u] = g[i + u * step];
    }
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      if constexpr (kBwd)
        y[i + u * step] = lrelu_grad(v[u], b, w[u]);
      else
        y[i + u * step] = lrelu_gain(v[u], b);
    }
  }
  for (; r < rows; r += row_step, i += step) {
    if constexpr (kBwd)
      y[i] = lrelu_grad(x[i], b, g[i]);
    else
      y[i] = lrelu_gain(x[i], b);
  }
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
    fused_lrelu_fwd_kernel(const Pack<T, kVec>* __restrict__ x,
                           const T* __restrict__ bias,
                           Pack<T, kVec>* __restrict__ y, int64_t rows,
                           int packs, int cols) {
  lrelu_rows<T, kVec, false>(x, bias, nullptr, y, rows, packs, cols);
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
    fused_lrelu_bwd_kernel(const Pack<T, kVec>* __restrict__ x,
                           const T* __restrict__ bias,
                           const Pack<T, kVec>* __restrict__ g,
                           Pack<T, kVec>* __restrict__ dx, int64_t rows,
                           int packs, int cols) {
  lrelu_rows<T, kVec, true>(x, bias, g, dx, rows, packs, cols);
}

template <typename T, int kVec, bool kBwd>
void launch_rows(const void* x, const void* bias, const void* g, void* y,
                 int64_t rows, int packs, cudaStream_t stream) {
  const int cols = packs < kThreads ? packs : kThreads;
  const int block_rows = kThreads / cols;
  const unsigned col_blocks = (unsigned)((packs + cols - 1) / cols);
  // about eight resident blocks of 256 threads on every SM
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int64_t row_blocks = (rows + block_rows - 1) / block_rows;
  const int64_t fill = (int64_t)sms * 8 / col_blocks;
  if (row_blocks > fill) row_blocks = fill > 0 ? fill : 1;
  const dim3 grid((unsigned)row_blocks, col_blocks);
  const auto* px = static_cast<const Pack<T, kVec>*>(x);
  const T* pb = static_cast<const T*>(bias);
  auto* py = static_cast<Pack<T, kVec>*>(y);
  if constexpr (kBwd)
    fused_lrelu_bwd_kernel<T, kVec><<<grid, kThreads, 0, stream>>>(
        px, pb, static_cast<const Pack<T, kVec>*>(g), py, rows, packs, cols);
  else
    fused_lrelu_fwd_kernel<T, kVec><<<grid, kThreads, 0, stream>>>(
        px, pb, py, rows, packs, cols);
}

// 16-byte packs where C and every pointer allow, else one element a pack
// (g is null for K1)
template <typename T, bool kBwd>
void launch(const void* x, const void* bias, const void* g, void* y,
            int64_t n, int64_t c, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = c % kVec == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(g) |
                     reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  if (vec)
    launch_rows<T, kVec, kBwd>(x, bias, g, y, n / c, (int)(c / kVec),
                               stream);
  else
    launch_rows<T, 1, kBwd>(x, bias, g, y, n / c, (int)c, stream);
}

}  // namespace
}  // namespace marconet

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int marconet_fused_lrelu_fwd(const void* x, const void* bias,
                                        void* y, long long n, long long c,
                                        int dtype, void* stream) {
  using namespace marconet;
  // a row's packs span at most 2^23 / 256 grid columns (grid.y < 65536)
  if (n <= 0 || c <= 0 || n % c != 0 || c > (1 << 23))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      launch<float, false>(x, bias, nullptr, y, n, c, s);
      break;
    case kBFloat16:
      launch<__nv_bfloat16, false>(x, bias, nullptr, y, n, c, s);
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
  if (n <= 0 || c <= 0 || n % c != 0 || c > (1 << 23))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      launch<float, true>(x, bias, g, dx, n, c, s);
      break;
    case kBFloat16:
      launch<__nv_bfloat16, true>(x, bias, g, dx, n, c, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
