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
// * K1 moves 16 bytes per access. Each thread owns one 16-byte vector of
//   channels (8 bf16 or 4 f32) of the (rows, C) view: it loads that slice
//   of the bias into registers once, then walks down the rows with one
//   uint4 load and store per row, four rows in flight. A 2-D layout of
//   each block (channel vectors across, rows down) fixes the channel
//   offset once per thread, so there is no per-element division, and the
//   grid is sized from the SM count. Where C is not a multiple of the
//   vector or a pointer is not 16-byte aligned, the same kernel runs with
//   a vector of one element.
// * K1b is a grid-stride loop in which neighbouring
//   threads touch neighbouring addresses (coalesced), one read of each
//   input and one write per element.
//
// Both do their math in f32 and round once on store, as the plain versions
// do. Fusing the activation into the producing conv's epilogue is left to
// later work.
#include "common.cuh"

namespace marconet {
namespace {

constexpr float kSlope = 0.2f;
constexpr float kGain = 1.41421356237309515f;  // sqrt(2) rounded to f32
// 0.2 * sqrt(2) taken in double, then rounded to f32 (as the JAX kernel's
// Python constant negative_slope * scale is)
constexpr float kGainNeg = (float)(0.2 * 1.41421356237309515);

// kVec consecutive channels, moved as one access (16 bytes when kVec > 1)
template <typename T, int kVec>
struct alignas(sizeof(T) * kVec) Pack {
  T e[kVec];
};

constexpr int kFwdThreads = 256;
constexpr int kFwdRowsInFlight = 4;

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

// x and y are (rows, packs) arrays of packs; a block is cols x (256 / cols)
// threads over channel packs x rows, and blockIdx.y picks the block's cols
// packs when a row has more than 256.
template <typename T, int kVec>
__global__ void __launch_bounds__(kFwdThreads)
    fused_lrelu_fwd_kernel(const Pack<T, kVec>* __restrict__ x,
                           const T* __restrict__ bias,
                           Pack<T, kVec>* __restrict__ y, int64_t rows,
                           int packs, int cols) {
  const int col = blockIdx.y * cols + threadIdx.x % cols;
  const int block_rows = kFwdThreads / cols;
  const int r0 = threadIdx.x / cols;
  if (r0 >= block_rows || col >= packs) return;
  float b[kVec];
#pragma unroll
  for (int q = 0; q < kVec; ++q) b[q] = to_f32(bias[col * kVec + q]);
  const int64_t row_step = (int64_t)gridDim.x * block_rows;
  const int64_t step = row_step * packs;   // in packs
  int64_t r = (int64_t)blockIdx.x * block_rows + r0;
  int64_t i = r * packs + col;
  for (; r + (kFwdRowsInFlight - 1) * row_step < rows;
       r += kFwdRowsInFlight * row_step, i += kFwdRowsInFlight * step) {
    Pack<T, kVec> v[kFwdRowsInFlight];
#pragma unroll
    for (int u = 0; u < kFwdRowsInFlight; ++u) v[u] = x[i + u * step];
#pragma unroll
    for (int u = 0; u < kFwdRowsInFlight; ++u)
      y[i + u * step] = lrelu_gain(v[u], b);
  }
  for (; r < rows; r += row_step, i += step) y[i] = lrelu_gain(x[i], b);
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

template <typename T, int kVec>
void launch_fwd(const void* x, const void* bias, void* y, int64_t rows,
                int packs, cudaStream_t stream) {
  const int cols = packs < kFwdThreads ? packs : kFwdThreads;
  const int block_rows = kFwdThreads / cols;
  const unsigned col_blocks = (unsigned)((packs + cols - 1) / cols);
  // about eight resident blocks of 256 threads on every SM
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int64_t row_blocks = (rows + block_rows - 1) / block_rows;
  const int64_t fill = (int64_t)sms * 8 / col_blocks;
  if (row_blocks > fill) row_blocks = fill > 0 ? fill : 1;
  fused_lrelu_fwd_kernel<T, kVec>
      <<<dim3((unsigned)row_blocks, col_blocks), kFwdThreads, 0, stream>>>(
          static_cast<const Pack<T, kVec>*>(x), static_cast<const T*>(bias),
          static_cast<Pack<T, kVec>*>(y), rows, packs, cols);
}

// 16-byte packs where C and both pointers allow, else one element a pack
template <typename T>
void launch(const void* x, const void* bias, void* y, int64_t n, int64_t c,
            cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = c % kVec == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  if (vec)
    launch_fwd<T, kVec>(x, bias, y, n / c, (int)(c / kVec), stream);
  else
    launch_fwd<T, 1>(x, bias, y, n / c, (int)c, stream);
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
  // a row's packs span at most 2^23 / 256 grid columns (grid.y < 65536)
  if (n <= 0 || c <= 0 || n % c != 0 || c > (1 << 23))
    return (int)cudaErrorInvalidValue;
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
