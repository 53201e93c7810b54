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
// g is read only at winning columns. One block owns one (window column j,
// slot s, line b): its thread 0 decides once whether slot s wins at column
// x1_s + j (a valid slot covers it and no higher valid slot does), then the
// block's threads copy that g column, or write zeros, down the H * C
// elements with neighbouring threads on neighbouring channels. Each d res
// element is written exactly once, so no atomics and no zeroing pass.
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

template <typename T>
__global__ void sft_writeback_bwd_kernel(const T* __restrict__ g,
                                         const int* __restrict__ x1,
                                         const int* __restrict__ len,
                                         const int* __restrict__ valid,
                                         T* __restrict__ dres, int H, int W,
                                         int C, int S, int win) {
  const int j = blockIdx.x;
  const int s = blockIdx.y;
  const int b = blockIdx.z;
  const int x = x1[b * S + s] + j;

  __shared__ int s_wins;
  if (threadIdx.x == 0) {
    const int i = b * S + s;
    const int l = min(max(len[i], 0), win);
    bool wins = valid[i] > 0 && j < l && x >= 0 && x < W;
    for (int t = s + 1; wins && t < S; ++t) {
      const int k = b * S + t;
      const int lt = min(max(len[k], 0), win);
      const int v = x - x1[k];
      if (valid[k] > 0 && v >= 0 && v < lt) wins = false;
    }
    s_wins = wins;
  }
  __syncthreads();

  const int64_t hc = (int64_t)H * C;
  const int64_t rstride = (int64_t)win * C;
  T* dp = dres + (((int64_t)b * S + s) * H * win + j) * C;
  if (!s_wins) {
    const T zero = from_f32<T>(0.f);
    for (int64_t e = threadIdx.x; e < hc; e += blockDim.x) {
      const int64_t h = e / C;
      dp[h * rstride + (e - h * C)] = zero;
    }
    return;
  }
  const int64_t gstride = (int64_t)W * C;
  const T* gp = g + ((int64_t)b * H * W + x) * C;
  for (int64_t e = threadIdx.x; e < hc; e += blockDim.x) {
    const int64_t h = e / C;
    const int64_t c = e - h * C;
    dp[h * rstride + c] = gp[h * gstride + c];
  }
}

template <typename T>
void launch_bwd(const void* g, const int* x1, const int* len,
                const int* valid, void* dres, int B, int H, int W, int C,
                int S, int win, cudaStream_t stream) {
  dim3 grid(win, S, B);
  sft_writeback_bwd_kernel<T><<<grid, 256, 0, stream>>>(
      static_cast<const T*>(g), x1, len, valid, static_cast<T*>(dres), H, W,
      C, S, win);
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
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || S <= 0 || win <= 0 ||
      B > 65535 || S > 65535)
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
