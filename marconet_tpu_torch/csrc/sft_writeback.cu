// K2: the SFT write-back with last-writer-wins overlap, and its backward.
//
// The forward replaces the TPU kernel
// marconet_tpu/ops/pallas_sft.py::_writeback_kernel (launched by
// sft_writeback). The backward replaces no TPU kernel: the JAX package's
// training path differentiates its XLA write-back instead
// (marconet_tpu/models/srnet.py:389-438).
//
//   out = canvas; then each valid slot s, in slot order, writes
//   canvas + res[s] over columns [x1_s, x1_s + L_s)
//
// so a covered column holds canvas + the residual of the highest valid slot
// covering it, and an uncovered column keeps the canvas. Shapes: canvas and
// out (B, H, W, C), res (B, S, H, win, C), x1 / L / valid (B, S) int32; all
// contiguous. L is clamped to [0, win].
//
// Bound: device-memory bytes. Every output element is one read of the canvas,
// at most one read of one residual and one write, with one add between. The
// TPU kernel serialised a read-modify-write DMA per slot, aligned windows to
// 16 columns and shifted them with a one-hot matmul; a GPU gathers instead.
// One block owns one (b, output column, channel tile): it scans the <= 16
// slots' (x1, L, valid) once to find the winner, then its threads walk the
// column's H rows with neighbouring threads on neighbouring channels
// (coalesced), so each element is read and written exactly once and no
// overlapping slot is ever written twice. Takes any W, win and C.
//
// Backward: d canvas = g (the wrapper returns g itself), and
//
//   d res[b, s, h, j, c] = g[b, h, x1_s + j, c]  if slot s is the winning
//                          valid slot at column x1_s + j and j < L_s,
//                          else 0.
//
// Also bound by device-memory bytes: every d res element is written once,
// g is read only at winning columns. The design:
//
// * A block owns a tile: one (line b, slot s), a group of rows h (one per
//   thread row) and a chunk of window columns j. It decides the winners of
//   its columns once, into a shared table (the canvas column x1_s + j where
//   slot s is the winning valid slot there, else -1): one thread a column
//   scans the <= S - 1 higher slots.
// * Threads own 16-byte packs over the channel axis (8 bf16 or 4 f32; C =
//   256 at the SFT shapes), in a 2-D layout of packs x rows h, so no
//   element index is ever divided. Each thread walks its chunk's columns,
//   four in flight, and copies a g pack or stores a zero pack: d res and g
//   rows are contiguous along j, so a warp moves whole 512-byte rows.
// * The tiles are cut so that their count fills the SMs about eight
//   blocks deep; a block loops over tiles when there are more.
// * Where C is not a multiple of the pack or a pointer is not 16-byte
//   aligned, the same kernel runs with a pack of one element.
//
// Each d res element is written exactly once, so no atomics and no zeroing
// pass. The earlier design (one block per (j, s, b), thread 0 deciding the
// winner, a 64-bit e / C and 2-byte stores per element) ran at 0.0991 ms in
// bf16 at sft_64 B=2 against a 0.0343 ms bound (35%, H100 80GB HBM3, 700 W):
// per-element work, not bytes, set it.
#include "common.cuh"

namespace marconet {
namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void sft_writeback_kernel(const T* __restrict__ canvas,
                                     const T* __restrict__ res,
                                     const int* __restrict__ x1,
                                     const int* __restrict__ len,
                                     const int* __restrict__ valid,
                                     T* __restrict__ out, int H, int W, int C,
                                     int S, int win) {
  const int x = blockIdx.x;
  const int b = blockIdx.y;
  const int c = blockIdx.z * blockDim.x + threadIdx.x;

  __shared__ int s_slot, s_col;
  if (threadIdx.x == 0) {
    int slot = -1, col = 0;
    for (int s = 0; s < S; ++s) {
      const int i = b * S + s;
      const int l = min(max(len[i], 0), win);
      const int v = x - x1[i];
      if (valid[i] > 0 && v >= 0 && v < l) {
        slot = s;
        col = v;
      }
    }
    s_slot = slot;
    s_col = col;
  }
  __syncthreads();
  if (c >= C) return;

  const int64_t row = (int64_t)W * C;
  const int64_t base = ((int64_t)b * H * W + x) * C + c;
  const T* cp = canvas + base;
  T* op = out + base;
  const int slot = s_slot;
  if (slot < 0) {
    for (int h = 0; h < H; ++h) op[h * row] = cp[h * row];
    return;
  }
  const int64_t rrow = (int64_t)win * C;
  const T* rp = res + (((int64_t)b * S + slot) * H * win + s_col) * C + c;
  for (int h = 0; h < H; ++h) {
    op[h * row] = from_f32<T>(to_f32(cp[h * row]) + to_f32(rp[h * rrow]));
  }
}

template <typename T>
void launch(const void* canvas, const void* res, const int* x1,
            const int* len, const int* valid, void* out, int B, int H, int W,
            int C, int S, int win, cudaStream_t stream) {
  dim3 grid(W, B, (C + kThreads - 1) / kThreads);
  sft_writeback_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(canvas), static_cast<const T*>(res), x1, len,
      valid, static_cast<T*>(out), H, W, C, S, win);
}

constexpr int kBwdThreads = 256;
constexpr int kBwdColsInFlight = 4;
constexpr int kBwdMaxChunk = 256;   // window columns of one tile

// g (B, H, W, packs) and dres (B, S, H, win, packs) in packs. A block is
// cols x (256 / cols) threads over channel packs x rows h; tile t is
// (column block, chunk of jc window columns, group of rows, slot, line),
// fastest first.
template <typename T, int kVec>
__global__ void __launch_bounds__(kBwdThreads)
    sft_writeback_bwd_kernel(const Pack<T, kVec>* __restrict__ g,
                             const int* __restrict__ x1,
                             const int* __restrict__ len,
                             const int* __restrict__ valid,
                             Pack<T, kVec>* __restrict__ dres, int H, int W,
                             int packs, int S, int win, int cols, int jc,
                             int64_t tiles) {
  __shared__ int s_col[kBwdMaxChunk];
  const int block_rows = kBwdThreads / cols;
  const int col_blocks = (packs + cols - 1) / cols;
  const int chunks = (win + jc - 1) / jc;
  const int groups = (H + block_rows - 1) / block_rows;
  const int t_col = threadIdx.x % cols, t_row = threadIdx.x / cols;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    int64_t rest = t;
    const int cb = (int)(rest % col_blocks);
    rest /= col_blocks;
    const int j0 = (int)(rest % chunks) * jc;
    rest /= chunks;
    const int h = (int)(rest % groups) * block_rows + t_row;
    rest /= groups;
    const int s = (int)(rest % S);
    const int b = (int)(rest / S);
    const int jn = min(jc, win - j0);

    __syncthreads();   // the previous tile's readers are done with s_col
    for (int k = threadIdx.x; k < jn; k += kBwdThreads) {
      const int i = b * S + s;
      const int j = j0 + k;
      const int x = x1[i] + j;
      bool wins = valid[i] > 0 && j < min(max(len[i], 0), win) && x >= 0 &&
                  x < W;
      for (int u = s + 1; wins && u < S; ++u) {
        const int m = b * S + u;
        const int v = x - x1[m];
        if (valid[m] > 0 && v >= 0 && v < min(max(len[m], 0), win))
          wins = false;
      }
      s_col[k] = wins ? x : -1;
    }
    __syncthreads();

    const int p = cb * cols + t_col;
    if (t_row >= block_rows || h >= H || p >= packs) continue;
    const Pack<T, kVec>* gp = g + ((int64_t)b * H + h) * W * packs + p;
    Pack<T, kVec>* dp =
        dres + ((((int64_t)b * S + s) * H + h) * win + j0) * packs + p;
    Pack<T, kVec> zero;
#pragma unroll
    for (int q = 0; q < kVec; ++q) zero.e[q] = from_f32<T>(0.f);
    int k = 0;
    for (; k + kBwdColsInFlight <= jn; k += kBwdColsInFlight) {
      Pack<T, kVec> v[kBwdColsInFlight];
#pragma unroll
      for (int u = 0; u < kBwdColsInFlight; ++u) {
        const int x = s_col[k + u];
        v[u] = x >= 0 ? gp[(int64_t)x * packs] : zero;
      }
#pragma unroll
      for (int u = 0; u < kBwdColsInFlight; ++u)
        dp[(int64_t)(k + u) * packs] = v[u];
    }
    for (; k < jn; ++k) {
      const int x = s_col[k];
      dp[(int64_t)k * packs] = x >= 0 ? gp[(int64_t)x * packs] : zero;
    }
  }
}

template <typename T, int kVec>
void launch_bwd_packs(const void* g, const int* x1, const int* len,
                      const int* valid, void* dres, int B, int H, int W,
                      int packs, int S, int win, cudaStream_t stream) {
  const int cols = packs < kBwdThreads ? packs : kBwdThreads;
  const int block_rows = kBwdThreads / cols;
  const int64_t base = (int64_t)((packs + cols - 1) / cols) *
                       ((H + block_rows - 1) / block_rows) * S * B;
  // cut the window columns into chunks so the tiles fill every SM about
  // eight blocks of 256 threads deep (one wave), at most 256 columns a chunk
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t fill = (int64_t)sms * 8;
  int64_t chunks = fill / base;
  if (chunks < 1) chunks = 1;
  if (chunks > win) chunks = win;
  int jc = (int)((win + chunks - 1) / chunks);
  if (jc > kBwdMaxChunk) jc = kBwdMaxChunk;
  const int64_t tiles = base * ((win + jc - 1) / jc);
  const unsigned grid = (unsigned)(tiles < fill ? tiles : fill);
  sft_writeback_bwd_kernel<T, kVec><<<grid, kBwdThreads, 0, stream>>>(
      static_cast<const Pack<T, kVec>*>(g), x1, len, valid,
      static_cast<Pack<T, kVec>*>(dres), H, W, packs, S, win, cols, jc,
      tiles);
}

// 16-byte packs where C and both pointers allow, else one element a pack
template <typename T>
void launch_bwd(const void* g, const int* x1, const int* len,
                const int* valid, void* dres, int B, int H, int W, int C,
                int S, int win, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = C % kVec == 0 && ((reinterpret_cast<uintptr_t>(g) |
                                      reinterpret_cast<uintptr_t>(dres)) &
                                     15) == 0;
  if (vec)
    launch_bwd_packs<T, kVec>(g, x1, len, valid, dres, B, H, W, C / kVec, S,
                              win, stream);
  else
    launch_bwd_packs<T, 1>(g, x1, len, valid, dres, B, H, W, C, S, win,
                           stream);
}

}  // namespace
}  // namespace marconet

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int marconet_sft_writeback(const void* canvas, const void* res,
                                      const void* x1, const void* len,
                                      const void* valid, void* out, int B,
                                      int H, int W, int C, int S, int win,
                                      int dtype, void* stream) {
  using namespace marconet;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || S <= 0 || win <= 0 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* px1 = static_cast<const int*>(x1);
  const int* plen = static_cast<const int*>(len);
  const int* pvalid = static_cast<const int*>(valid);
  switch (dtype) {
    case kFloat32:
      launch<float>(canvas, res, px1, plen, pvalid, out, B, H, W, C, S, win,
                    s);
      break;
    case kBFloat16:
      launch<__nv_bfloat16>(canvas, res, px1, plen, pvalid, out, B, H, W, C,
                            S, win, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// d res of the write-back; returns cudaGetLastError() after the launch.
extern "C" int marconet_sft_writeback_bwd(const void* g, const void* x1,
                                          const void* len, const void* valid,
                                          void* dres, int B, int H, int W,
                                          int C, int S, int win, int dtype,
                                          void* stream) {
  using namespace marconet;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || S <= 0 || win <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* px1 = static_cast<const int*>(x1);
  const int* plen = static_cast<const int*>(len);
  const int* pvalid = static_cast<const int*>(valid);
  switch (dtype) {
    case kFloat32:
      launch_bwd<float>(g, px1, plen, pvalid, dres, B, H, W, C, S, win, s);
      break;
    case kBFloat16:
      launch_bwd<__nv_bfloat16>(g, px1, plen, pvalid, dres, B, H, W, C, S,
                                win, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
