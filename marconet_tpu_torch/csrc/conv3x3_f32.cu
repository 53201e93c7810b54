// K3, f32 path for Hopper: an implicit GEMM on the FP32 pipes.
//
// Replaces, for f32 inputs, the TPU kernel
// marconet_tpu/ops/pallas_conv.py::_conv3x3_kernel (launched by
// conv3x3_same), written for the SR net's windowed SFT conv stacks: 128
// windows of 64x64 or 32x32 pixels at 512 or 256 -> 256 channels.
//
//   out[n, y, x, co] = sum over dy, dx in {0,1,2}, ci < CI of
//       x[n, y+dy-1, x+dx-1, ci] * w[dy, dx, ci, co]     (0 outside the image)
//
// x (N, H, W, CI) NHWC, w (3, 3, CI, CO) HWIO, out (N, H, W, CO), all
// contiguous f32; any N, H, W, CI and CO. The GEMM: M = N*H*W output
// pixels, N = CO, K = 9*CI, A[m, k] the input pixel under tap k / CI of
// output pixel m (zero where the tap leaves the image), B the weights as a
// (9*CI, CO) row-major matrix. No patch matrix, no padded copy: the border
// is a zero-filled load.
//
// Why not TF32 (or 3xTF32 on the tensor cores): the port's f32 gates hold
// K3 within 1e-5 of the largest value of its plain version, and no further
// from f64 than twice the plain version, which takes full f32 products.
// TF32 keeps 10 mantissa bits; a split-TF32 emulation is another numerical
// contract. So every product is an fmaf on the FP32 pipes.
//
// Bound: operations. At (128, 64, 64, 256 -> 256) the GEMM does 0.618
// TFLOP against ~1.1 GB of input and output, ~580 flop/byte, far above
// the card's ~20 flop/byte f32 ridge: the least time is the 67 TFLOP/s
// FP32 peak's 9.23 ms, and the kernel has to keep the FMA pipes issuing.
// The design (each step's time is in PERF.md):
//
// * Tiles. A 256-thread CTA computes 128 pixels x 128 channels, each
//   thread 8 x 8 sums laid out as four 4 x 4 quadrants at offsets 0 and 64
//   in each direction. A warp is 4 x 8 threads over the quadrants, so each
//   of a k step's four shared reads is one conflict-free LDS.128 (4
//   distinct float4 of A, 8 contiguous of B): 64 FMAs per 4 LDS.128. Each
//   k step's operands are read one step ahead of its FMAs.
// * A tile: 16 channels of one tap for 128 pixels. A arrives
//   channel-contiguous and the outer product wants it pixel-contiguous, so
//   it is transposed through registers: four threads load a pixel's 16
//   channels (one 16-byte load each: 64 contiguous bytes, so a warp's
//   load touches 8 pixels), and store them as scalars into As[k][pixel],
//   whose rows are 132 floats long and stay 16-byte aligned for the
//   LDS.128 reads (the stores conflict 2-way). cp.async cannot transpose
//   a 16-byte copy.
// * B tile: 16 rows of 128 output channels, copied by cp.async straight
//   into shared memory (zero-filled past CI and CO), so it holds no
//   registers.
// * Loads. 16 bytes along CI for A when CI % 4 == 0 and x is 16-byte
//   aligned (kVecA), along CO for B and the stores when CO % 4 == 0 and w
//   and out are (kVecB); scalar, predicated accesses otherwise, so any
//   N, H, W, CI and CO work.
// * Index math once per CTA. Each loading thread computes its pixels'
//   offset and 9-bit masks of the taps that stay inside the image once;
//   the loop steps channels and taps by increments.
// * Pipeline. Two shared buffers: the next tile's A loads and B copies are
//   issued before the current tile's 1024 FMAs a thread, A stored and B
//   awaited behind them; one barrier per tile. Two CTAs share an SM
//   (__launch_bounds__(256, 2): at most 128 registers a thread), so one
//   CTA's barrier is covered by the other's FMAs.
// * Numerics: a two-level sum. Each thread sums one tap's products over at
//   most 256 channels of each output apart, in registers, then adds that
//   partial into a running sum that lives in shared memory (16 float4 a
//   thread, 64 KB a CTA, read and written only by that thread) at the top
//   of the next tile, where no staged load holds registers. That is the
//   plain version's own order (a matmul per tap and 256-channel block,
//   added into an f32 sum): its error against f64 matches the plain
//   version's. One running sum over K = 9*CI products lands 4.97-10.89x
//   further from f64 at the SFT shapes, past the gate of 2x; a second
//   register a sum would cost 64 registers a thread and the second CTA on
//   the SM.
//
// Resources (-Xptxas -v, nvcc 12.8, sm_90a): 128 registers a thread, no
// spills except in the variant with scalar A and 16-byte B loads (12
// bytes), 96.5 KB of shared memory a CTA, two CTAs an SM.
#include <cstddef>

#include "common.cuh"

namespace marconet {
namespace {

constexpr int kBM = 128;             // output pixels of a CTA
constexpr int kBN = 128;             // output channels of a CTA
constexpr int kBK = 16;              // K (channels of one tap) of a tile
constexpr int kThreads = 256;
constexpr int kAStride = kBM + 4;    // floats of a shared A row
constexpr int kFoldTiles = 256 / kBK;  // at most, tiles of a partial
constexpr int kALanes = kBK / 4;     // threads that load one A pixel
constexpr int kAPix = kBK / 8;       // A pixels a thread loads
constexpr int kAStep = kThreads / kALanes;  // pixels between them

struct Shape {
  int N, H, W, CI, CO;
  int64_t M;  // N * H * W output pixels
};

struct Smem {
  float a[2][kBK][kAStride];  // [k][pixel]
  float b[2][kBK][kBN];       // [k][channel]
  float4 acc[16][kThreads];   // running sums, thread t's in column t
};

constexpr size_t kSmemBytes = sizeof(Smem);

// The element offset from a pixel's channel 0 to that of its tap (dy, dx).
__device__ __forceinline__ int64_t tap_delta(const Shape& s, int tap) {
  return ((int64_t)(tap / 3 - 1) * s.W + (tap % 3 - 1)) * s.CI;
}

// Four consecutive floats at p, of which the first `count` exist (the rest,
// and all when count <= 0, are zero); kVec: one 16-byte load.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* p, int count) {
  if (kVec) return count > 0 ? __ldg(reinterpret_cast<const float4*>(p))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 v;
  v.x = count > 0 ? __ldg(p) : 0.f;
  v.y = count > 1 ? __ldg(p + 1) : 0.f;
  v.z = count > 2 ? __ldg(p + 2) : 0.f;
  v.w = count > 3 ? __ldg(p + 3) : 0.f;
  return v;
}

// Copies src_bytes (0 fills zeros) of the `bytes` at src into shared dst.
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int bytes, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
}

template <bool kVecA, bool kVecB>
__global__ void __launch_bounds__(kThreads, 2)
    conv3x3_f32_kernel(const float* __restrict__ x,
                       const float* __restrict__ w, float* __restrict__ out,
                       Shape s, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x;
  const int co0 = (int)(blockIdx.x % n_tiles) * kBN;
  const int64_t m0 = (int64_t)(blockIdx.x / n_tiles) * kBM;

  // loads: A pixels a_p + kAStep * i at channels a_c..a_c+3 of the tile
  // (kALanes threads cover a pixel's kBK channels: 64 contiguous bytes at
  // kBK = 16), through registers and transposed on the store; B rows
  // b_k + 8 * j at output channels b_n..b_n+3 (cp.async, straight into
  // shared memory)
  const int a_p = tid / kALanes, a_c = (tid % kALanes) * 4;
  const int b_k = tid / 32, b_n = (tid % 32) * 4;
  const int b_count = s.CO - (co0 + b_n);

  // this thread's A pixels, once: the first one's channel-0 offset (pixel
  // i is kAStep * CI elements further) and, in bits 9i..9i+8, the taps of
  // pixel i that stay inside the image (bit dy * 3 + dx)
  const int64_t a_base = (m0 + a_p) * s.CI;
  int taps = 0;
#pragma unroll
  for (int i = 0; i < kAPix; ++i) {
    const int64_t m = m0 + a_p + kAStep * i;
    if (m >= s.M) continue;
    const int hw = (int)(m % ((int64_t)s.H * s.W));
    const int y = hw / s.W, xx = hw - y * s.W;
    const int rows = (y > 0 ? 1 : 0) | 2 | (y + 1 < s.H ? 4 : 0);
    const int cols = (xx > 0 ? 1 : 0) | 2 | (xx + 1 < s.W ? 4 : 0);
#pragma unroll
    for (int t = 0; t < 9; ++t)
      if (((rows >> (t / 3)) & (cols >> (t % 3)) & 1) != 0)
        taps |= 1 << (9 * i + t);
  }

  // the next tile to load: tap ld_tap, channels ld_ci..ld_ci+kBK-1
  int ld_tap = 0, ld_ci = 0;
  int64_t a_tap = tap_delta(s, 0);
  int64_t b_off = (int64_t)b_k * s.CO + co0 + b_n;
  float4 a_reg[kAPix];

  auto load_tile = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kAPix; ++i) {
      const int ca =
          (taps >> (9 * i + ld_tap)) & 1 ? s.CI - (ld_ci + a_c) : 0;
      a_reg[i] = load4<kVecA>(
          x + (ca > 0 ? a_base + (int64_t)kAStep * i * s.CI + a_tap +
                            ld_ci + a_c
                      : 0),
          ca);
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const int cb = ld_ci + b_k + 8 * j < s.CI ? b_count : 0;
      const float* pb = w + (cb > 0 ? b_off + (int64_t)8 * j * s.CO : 0);
      float* dst = &sm.b[buf][b_k + 8 * j][b_n];
      if (kVecB) {
        cp_async(dst, pb, 16, cb > 0 ? 16 : 0);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          cp_async(dst + q, cb > q ? pb + q : w, 4, cb > q ? 4 : 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  auto advance = [&]() {
    ld_ci += kBK;
    b_off += (int64_t)kBK * s.CO;
    if (ld_ci >= s.CI) {
      ld_ci = 0;
      ++ld_tap;
      a_tap = tap_delta(s, ld_tap);
      b_off = ((int64_t)ld_tap * s.CI + b_k) * s.CO + co0 + b_n;
    }
  };
  auto store_tile = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kAPix; ++i) {
      const int p = a_p + kAStep * i;
      sm.a[buf][a_c + 0][p] = a_reg[i].x;
      sm.a[buf][a_c + 1][p] = a_reg[i].y;
      sm.a[buf][a_c + 2][p] = a_reg[i].z;
      sm.a[buf][a_c + 3][p] = a_reg[i].w;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  };

  // this thread's sums: rows tm + i (i < 4) and 64 + tm + i - 4, columns
  // tn + j (j < 4) and 64 + tn + j - 4; a warp is 4 x 8 threads
  const int warp = tid / 32, lane = tid % 32;
  const int tm = ((warp / 2) * 4 + lane / 8) * 4;
  const int tn = ((warp % 2) * 8 + lane % 8) * 4;
  float part[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) part[i][j] = 0.f;
#pragma unroll
  for (int q = 0; q < 16; ++q)
    sm.acc[q][tid] = make_float4(0.f, 0.f, 0.f, 0.f);

  // a k step's operands, read one step ahead: fa / fb[slot][quadrant]
  float4 fa[2][2], fb[2][2];
  auto load_frag = [&](int buf, int k, int slot) {
    fa[slot][0] = *reinterpret_cast<const float4*>(&sm.a[buf][k][tm]);
    fa[slot][1] = *reinterpret_cast<const float4*>(&sm.a[buf][k][64 + tm]);
    fb[slot][0] = *reinterpret_cast<const float4*>(&sm.b[buf][k][tn]);
    fb[slot][1] = *reinterpret_cast<const float4*>(&sm.b[buf][k][64 + tn]);
  };

  const int n_chunks = (s.CI + kBK - 1) / kBK;  // K tiles a tap
  const int k_tiles = 9 * n_chunks;
  int chunk = 0;          // the computed tile's chunk within its tap
  bool fold_due = false;  // the last tile ended a partial
  load_tile(0);
  store_tile(0);
  advance();
  __syncthreads();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int buf = kt & 1;
    const bool more = kt + 1 < k_tiles;
    // a partial (one tap's products over 256 channels, or over the tap's
    // last channels) joins the running sums here, where no staged load
    // holds registers
    if (fold_due) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float4 v = sm.acc[2 * i + h][tid];
          v.x += part[i][4 * h + 0];
          v.y += part[i][4 * h + 1];
          v.z += part[i][4 * h + 2];
          v.w += part[i][4 * h + 3];
          sm.acc[2 * i + h][tid] = v;
#pragma unroll
          for (int j = 0; j < 4; ++j) part[i][4 * h + j] = 0.f;
        }
      }
    }
    if (more) load_tile(buf ^ 1);
    load_frag(buf, 0, 0);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      if (k + 1 < kBK) load_frag(buf, k + 1, (k + 1) & 1);
      const int slot = k & 1;
      const float4 a0 = fa[slot][0], a1 = fa[slot][1];
      const float4 b0 = fb[slot][0], b1 = fb[slot][1];
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          part[i][j] = fmaf(av[i], bv[j], part[i][j]);
    }
    if (++chunk == n_chunks) {
      chunk = 0;
      fold_due = true;
    } else {
      fold_due = chunk % kFoldTiles == 0;
    }
    // buffer buf ^ 1 was last read in iteration kt - 1, before the barrier
    // that ended it
    if (more) {
      store_tile(buf ^ 1);
      advance();
    }
    __syncthreads();
  }

  // epilogue: the running sum plus the last partial, stored with the pixel
  // and channel edges masked
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t mo = m0 + tm + (i < 4 ? i : 60 + i);
    if (mo >= s.M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 v = sm.acc[2 * i + h][tid];
      v.x += part[i][4 * h + 0];
      v.y += part[i][4 * h + 1];
      v.z += part[i][4 * h + 2];
      v.w += part[i][4 * h + 3];
      const int co = co0 + tn + 64 * h;
      float* o = out + mo * s.CO + co;
      if (kVecB && co < s.CO) {
        *reinterpret_cast<float4*>(o) = v;
      } else {
        if (co + 0 < s.CO) o[0] = v.x;
        if (co + 1 < s.CO) o[1] = v.y;
        if (co + 2 < s.CO) o[2] = v.z;
        if (co + 3 < s.CO) o[3] = v.w;
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool kVecA, bool kVecB>
int launch(const float* x, const float* w, float* out, const Shape& s,
           cudaStream_t st) {
  const int n_tiles = (s.CO + kBN - 1) / kBN;
  const int64_t blocks = ((s.M + kBM - 1) / kBM) * n_tiles;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  auto* kernel = conv3x3_f32_kernel<kVecA, kVecB>;
  // above 48 KB of shared memory, and room for two CTAs an SM
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, kThreads, kSmemBytes, st>>>(x, w, out, s,
                                                       n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace marconet

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int marconet_conv3x3_f32(const void* x, const void* w, void* out,
                                    int N, int H, int W, int CI, int CO,
                                    void* stream) {
  using namespace marconet;
  if (N <= 0 || H <= 0 || W <= 0 || CI <= 0 || CO <= 0)
    return (int)cudaErrorInvalidValue;
  const Shape s{N, H, W, CI, CO, (int64_t)N * H * W};
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  auto* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte A loads along CI, and 16-byte B copies and stores along CO
  const bool vec_a = CI % 4 == 0 && aligned16(x);
  const bool vec_b = CO % 4 == 0 && aligned16(w) && aligned16(out);
  if (vec_a)
    return vec_b ? launch<true, true>(xf, wf, of, s, st)
                 : launch<true, false>(xf, wf, of, s, st);
  return vec_b ? launch<false, true>(xf, wf, of, s, st)
               : launch<false, false>(xf, wf, of, s, st);
}
