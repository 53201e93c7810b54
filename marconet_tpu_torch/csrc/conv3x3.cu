// K3: 3x3 stride-1 zero-SAME convolution as an implicit GEMM.
//
// Replaces the TPU kernel marconet_tpu/ops/pallas_conv.py::_conv3x3_kernel
// (launched by conv3x3_same), written for the SR net's windowed SFT conv
// stacks: fuse, scale and shift over B*N windows of 32x32 or 64x64 pixels at
// 256-512 -> 256 channels.
//
//   out[n, y, x, co] = sum over dy, dx in {0,1,2}, ci < CI of
//       x[n, y+dy-1, x+dx-1, ci] * w[dy, dx, ci, co]     (0 outside the image)
//
// x (N, H, W, CI) NHWC, w (3, 3, CI, CO) HWIO, out (N, H, W, CO), all
// contiguous bf16; the sum is taken in f32 and rounded once to bf16. Any N,
// H, W, CI and CO (edges are masked). f32 inputs take conv3x3_f32.cu; a
// call here with the f32 dtype code returns cudaErrorInvalidValue.
//
// The GEMM: M = N*H*W output pixels, N = CO, K = 9*CI, with A[m, k] the input
// pixel under tap k / CI of output pixel m (zero where the tap leaves the
// image) and B the weights viewed as a (9*CI, CO) row-major matrix. No
// patch matrix is built: each block gathers its A tile straight from x with
// predicated loads (the zero border costs no padded copy, as the TPU
// kernel's per-tap edge slices did), stages it and the B tile in shared
// memory, and keeps its f32 sums in registers across the whole K loop.
//
// Bound: operations. At the serving batch's largest SFT conv (N=128
// windows of 64x64, 512 -> 256 channels) the GEMM does 2*M*K*CO = 1.237
// TFLOP while the inputs and output move ~0.8 GB, about 1500 flop/byte, far
// above the H100's ~295 flop/byte ridge. So the least time is 1.25 ms at the
// 989 TFLOP/s bf16 tensor-core peak. What the design does about it: the
// products run on the tensor cores through mma.sync (nvcuda::wmma 16x16x16,
// f32 accumulate). A 256-thread block owns a 128-pixel x 128-channel
// output tile; each of its 8 warps owns 32 x 64 of it (8 accumulator
// fragments), and every A and B fragment loaded from shared memory feeds
// 4 and 2 products. K advances 32 channels of one tap at a time; the next
// K tile's global loads are issued into registers before the current
// tile's products, and two shared buffers alternate, so one barrier per K
// tile suffices. Loads are 16 bytes wide when CI and CO are multiples of 8.
//
// This is the general form, for any shape and alignment. bf16 inputs that
// TMA can tile (ops/conv3x3.py::conv3x3_path), the SFT convs among them,
// take conv3x3_wgmma.cu instead: wgmma fed by TMA through a multi-stage
// shared-memory ring. PERF.md keeps both kernels' times.
#include <mma.h>

#include "common.cuh"

namespace marconet {
namespace {

using namespace nvcuda;

struct ConvShape {
  int N, H, W, CI, CO;
  int64_t M;  // N * H * W output pixels
};

// Where output pixel m's tap (dy, dx) reads x, as an element offset of
// channel 0, or -1 outside the image (or past the last pixel).
struct PixelRef {
  int64_t base;  // m * CI
  int y, x;
  bool valid;
};

__device__ __forceinline__ PixelRef pixel_ref(const ConvShape& s, int64_t m) {
  PixelRef p;
  p.valid = m < s.M;
  const int64_t mm = p.valid ? m : 0;
  const int hw = (int)(mm % ((int64_t)s.H * s.W));
  p.y = hw / s.W;
  p.x = hw - p.y * s.W;
  p.base = mm * s.CI;
  return p;
}

__device__ __forceinline__ int64_t tap_offset(const ConvShape& s,
                                              const PixelRef& p, int dy,
                                              int dx) {
  const int iy = p.y + dy - 1, ix = p.x + dx - 1;
  if (!p.valid || iy < 0 || iy >= s.H || ix < 0 || ix >= s.W) return -1;
  return p.base + ((int64_t)(dy - 1) * s.W + (dx - 1)) * s.CI;
}

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kTcThreads = 256;
constexpr int kAStride = kBK + 8;  // bf16 per shared A row (80 bytes)
constexpr int kBStride = kBN + 8;  // bf16 per shared B row (272 bytes)

// Eight consecutive bf16 starting at p, of which the first `count` exist
// (the rest, and all when count <= 0, are zero).
template <bool kVec>
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p, int count) {
  if (count <= 0) return make_uint4(0, 0, 0, 0);
  if (kVec) return __ldg(reinterpret_cast<const uint4*>(p));
  uint4 v;
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = i < count ? p[i] : __float2bfloat16(0.f);
  return v;
}

template <bool kVec>
__global__ void __launch_bounds__(kTcThreads)
    conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ w,
                        __nv_bfloat16* __restrict__ out, ConvShape s,
                        int n_tiles) {
  __shared__ __align__(128) __nv_bfloat16 As[2][kBM][kAStride];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][kBK][kBStride];
  __shared__ __align__(128) float scratch[kTcThreads / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int co0 = (int)(blockIdx.x % n_tiles) * kBN;
  const int64_t m0 = (int64_t)(blockIdx.x / n_tiles) * kBM;

  // this thread's loads: A rows a_row[i] at channels a_k..a_k+7 of the K
  // tile, B rows b_row[i] at output channels b_n..b_n+7
  const int a_k = (tid % 4) * 8;
  PixelRef a_pix[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) a_pix[i] = pixel_ref(s, m0 + tid / 4 + 64 * i);
  const int b_n = (tid % 16) * 8;
  const int b_count = s.CO - (co0 + b_n);

  const int nkc = (s.CI + kBK - 1) / kBK;
  const int k_tiles = 9 * nkc;
  uint4 a_reg[2], b_reg[2];

  auto load_tile = [&](int kt) {
    const int tap = kt / nkc;
    const int ci0 = (kt - tap * nkc) * kBK;
    const int dy = tap / 3, dx = tap % 3;
    const int ci = ci0 + a_k;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t off = tap_offset(s, a_pix[i], dy, dx);
      a_reg[i] = load8<kVec>(x + (off < 0 ? 0 : off + ci),
                             off < 0 ? 0 : s.CI - ci);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int cib = ci0 + tid / 16 + 16 * i;
      const int64_t row = (int64_t)tap * s.CI + cib;
      b_reg[i] = load8<kVec>(w + (cib < s.CI ? row * s.CO + co0 + b_n : 0),
                             cib < s.CI ? b_count : 0);
    }
  };
  auto store_tile = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      *reinterpret_cast<uint4*>(&As[buf][tid / 4 + 64 * i][a_k]) = a_reg[i];
      *reinterpret_cast<uint4*>(&Bs[buf][tid / 16 + 16 * i][b_n]) = b_reg[i];
    }
  };

  const int wm = (warp / 2) * 32;  // the warp's 32 x 64 piece of the tile
  const int wn = (warp % 2) * 64;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load_tile(0);
  store_tile(0);
  __syncthreads();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < k_tiles) load_tile(kt + 1);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[buf][wm + 16 * i][kk], kAStride);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(b[j], &Bs[buf][kk][wn + 16 * j], kBStride);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j],
                                                   acc[i][j]);
    }
    // buffer buf ^ 1 was last read in iteration kt - 1, before the barrier
    // that ended it
    if (kt + 1 < k_tiles) store_tile(buf ^ 1);
    __syncthreads();
  }

  // epilogue: each fragment through the warp's scratch, rounded once, stored
  // with the pixel and channel edges masked
  float* sc = scratch[warp];
  const int r = lane / 2, c = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int64_t m = m0 + wm + 16 * i + r;
      const int co = co0 + wn + 16 * j + c;
      if (m < s.M) {
        __nv_bfloat16* o = out + m * s.CO + co;
        if (kVec && co + 8 <= s.CO) {
          uint4 v;
          __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
          for (int q = 0; q < 8; ++q) e[q] = __float2bfloat16_rn(sc[r * 16 + c + q]);
          *reinterpret_cast<uint4*>(o) = v;
        } else {
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (co + q < s.CO) o[q] = __float2bfloat16_rn(sc[r * 16 + c + q]);
        }
      }
      __syncwarp();
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace
}  // namespace marconet

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int marconet_conv3x3_same(const void* x, const void* w, void* out,
                                     int N, int H, int W, int CI, int CO,
                                     int dtype, void* stream) {
  using namespace marconet;
  if (N <= 0 || H <= 0 || W <= 0 || CI <= 0 || CO <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype != kBFloat16) return (int)cudaErrorInvalidValue;
  const ConvShape s{N, H, W, CI, CO, (int64_t)N * H * W};
  const int n_tiles = (CO + kBN - 1) / kBN;
  const int64_t blocks = ((s.M + kBM - 1) / kBM) * n_tiles;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  const bool vec = CI % 8 == 0 && CO % 8 == 0 && aligned16(x) &&
                   aligned16(w) && aligned16(out);
  if (vec)
    conv3x3_bf16_kernel<true>
        <<<(unsigned)blocks, kTcThreads, 0, st>>>(xb, wb, ob, s, n_tiles);
  else
    conv3x3_bf16_kernel<false>
        <<<(unsigned)blocks, kTcThreads, 0, st>>>(xb, wb, ob, s, n_tiles);
  return (int)cudaGetLastError();
}
