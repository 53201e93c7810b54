// K3, bf16 path for Hopper: TMA feeding wgmma through an mbarrier ring.
//
// Replaces, with conv3x3.cu's general kernel, the TPU kernel
// marconet_tpu/ops/pallas_conv.py::_conv3x3_kernel (launched by
// conv3x3_same), written for the SR net's windowed SFT conv stacks: 128
// windows of 64x64 or 32x32 pixels at 512 or 256 -> 256 channels, bf16.
//
//   out[n, y, x, co] = sum over dy, dx in {0,1,2}, ci < CI of
//       x[n, y+dy-1, x+dx-1, ci] * w[dy, dx, ci, co]     (0 outside the image)
//
// x (N, H, W, CI) NHWC and out (N, H, W, CO) bf16; the weights come K-major,
// wk (CO, 3, 3, CI) (the wrapper's copy of the HWIO weights). The sum is
// taken in f32 on the tensor cores and rounded once to bf16. The wrapper's
// rule (ops/conv3x3.py::conv3x3_path) sends here only inputs with CI and CO
// multiples of 8, 128 % W == 0, H a multiple of 128 / W and 16-byte-aligned
// pointers; everything else takes conv3x3.cu.
//
// Bound: operations. At (128, 64, 64, 512 -> 256) the GEMM (M = N*H*W
// pixels, N = CO, K = 9*CI) does 1.237 TFLOP against ~0.8 GB of input and
// output, ~1500 flop/byte, so the least time is the 989 TFLOP/s bf16 peak's
// 1.25 ms. Hopper reaches that peak only through wgmma fed from shared
// memory, with the loads kept off the threads that issue it. The design:
//
// * A tiles straight from x, no im2col copy. An M tile of 128 pixels is
//   128 / W whole rows of one image, so the A tile of tap (dy, dx) and
//   channel block ci0 is one box of a 4-D TMA map of x (CI, W, H, N):
//   {64 channels, W, 128 / W rows, 1 image} at {ci0, dx - 1, y0 + dy - 1, n}.
//   TMA writes zeros for the box's elements outside the tensor (row or
//   column -1 or past the edge, channels past CI): that zero fill is the
//   zero-SAME border, as the TPU kernel's per-tap edge slices were, and the
//   K tail when CI % 64 != 0. A B tile is two boxes {64, 1, 128} of a 3-D
//   map of wk (CI, 9, CO); rows past CO are zeros too.
// * Both maps use the 128-byte swizzle: a box row is 64 bf16 = 128 bytes,
//   and the shared tile is then the K-major, 128B-swizzled layout that a
//   wgmma shared-memory descriptor reads directly (every tile 1024-aligned).
// * A CTA computes a 128-pixel x 256-channel tile, which covers all of the
//   SFT convs' CO: each x box is fetched once per tap and channel block and
//   the 2.4 MB of weights stay in L2. K advances 64 channels of one tap per
//   step (9 * CI / 64 steps, 72 at CI = 512) through a ring of 4 stages of
//   16 KB of A plus 32 KB of B (192 KB), each stage with a full and an
//   empty mbarrier.
// * At the tensor cores' rate each step's 48 KB would ask ~11 TB/s of L2,
//   two thirds of it weights read again for every tile. So two CTAs on
//   neighbouring pixel tiles under the same channels form a cluster: each
//   loads half of the B tile and multicasts it into both, which cuts the
//   reads to 32 KB a step. A stage is free again only when the consumers
//   of both CTAs have released it, so its empty barrier counts the
//   consumer warpgroups of the cluster.
// * Warp specialisation, 384 threads: warpgroups 0 and 1 consume, each
//   running wgmma m64n256k16 on its 64 rows into 128 f32 registers a
//   thread, one wgmma group kept in flight so the tensor cores never wait
//   for a stage's release; warpgroup 2 produces, one thread keeping the
//   TMA loads in flight (setmaxnreg hands its registers to the consumers).
// * Persistent: as many clusters as the card holds walk over the tile
//   pairs, so the producer fills the next pair's stages while the
//   consumers store this one.
// * Epilogue through shared memory. Stored straight from the registers,
//   each warp's store wrote 16 bytes into each of eight rows, and the
//   output held the tensor cores idle for a large share of every tile. Each
//   warpgroup rounds its 64 rows once to bf16 into a 128B-swizzled 8 KB
//   buffer (no bank conflicts), 64 channels at a time, reads it back 16
//   bytes a thread and stores whole 128-byte row pieces, channels past CO
//   masked.
#include <cuda.h>

#include "common.cuh"

namespace marconet {
namespace {

constexpr int kBM = 128;            // pixels per tile
constexpr int kBN = 256;            // output channels per tile
constexpr int kBK = 64;             // channels of one tap per K step
constexpr int kStages = 4;
constexpr int kCluster = 2;         // CTAs sharing each B tile
constexpr int kABytes = kBM * kBK * 2;   // 16 KB
constexpr int kBBytes = kBN * kBK * 2;   // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kThreads = 384;       // 2 consumer warpgroups + 1 producer
constexpr int kConsumers = 2;       // consumer warpgroups per CTA
constexpr int kOutCols = 64;        // output channels per epilogue chunk
constexpr int kOutBytes = 64 * kOutCols * 2;   // a warpgroup's 64 rows: 8 KB
// the ring, an output buffer per consumer warpgroup, alignment slack
constexpr int kSmemBytes =
    kStages * kStageBytes + kConsumers * kOutBytes + 1024;

struct WgmmaShape {
  int H, W, CO;
  int k_steps;         // 9 * ceil(CI / 64)
  int co_tiles;        // ceil(CO / 256)
  int m_tiles;         // N * H * W / 128
  int pairs;           // ceil(m_tiles / 2) * co_tiles: one per cluster turn
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// arrive on the barrier at the same shared offset in CTA `rank` of the
// cluster (this CTA's own included)
__device__ __forceinline__ void mbar_arrive_in(uint32_t bar, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(bar), "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(remote)
               : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::
          : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_"
      "tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// the box lands at shared offset dst in every CTA of `mask`, each of whose
// barriers at offset bar counts its bytes
__device__ __forceinline__ void tma_load_3d_multicast(uint32_t dst,
                                                      const CUtensorMap* map,
                                                      uint32_t bar,
                                                      uint16_t mask, int c0,
                                                      int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_"
      "tx::bytes.multicast::cluster [%0], [%1, {%4, %5, %6}], [%2], %3;" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, __nv_bfloat162 v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr),
               "r"(*reinterpret_cast<uint32_t*>(&v))
               : "memory");
}

__device__ __forceinline__ uint4 ld_shared_16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// the 128 threads of consumer warpgroup wg (named barriers 1 and 2)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
}

// Shared-memory matrix descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending)
               : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256 f32, spread over the warpgroup) += A (64 x 16) * B (16 x 256)^T,
// both read from shared memory through their descriptors.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// The M tile that CTA `rank` of a cluster computes at turn `pair`: the two
// CTAs take neighbouring 128-pixel tiles under the same 256 channels. With
// an odd number of M tiles the last pair's second CTA repeats the first's
// tile (it must still load and multicast its half of B) and stores nothing.
struct TileRef {
  int co0;
  int64_t m0;
  bool store;
};

__device__ __forceinline__ TileRef tile_ref(const WgmmaShape& s, int pair,
                                            uint32_t rank) {
  TileRef t;
  t.co0 = (pair % s.co_tiles) * kBN;
  int m = 2 * (pair / s.co_tiles) + (int)rank;
  t.store = m < s.m_tiles;
  if (!t.store) m = s.m_tiles - 1;
  t.m0 = (int64_t)m * kBM;
  return t;
}

__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_w,
                         __nv_bfloat16* __restrict__ out, WgmmaShape s) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];

  // the ring, aligned to the 1024 bytes of the 128B swizzle's pattern; the
  // offset is the same in both CTAs of a cluster
  const uint32_t ring = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t tile_a = ring;                         // kStages x 16 KB
  const uint32_t tile_b = ring + kStages * kABytes;     // kStages x 32 KB
  const uint32_t tile_o = ring + kStages * kStageBytes;  // 2 x 8 KB
  const uint32_t rank = cluster_rank();
  const int cluster = blockIdx.x / kCluster;
  const int clusters = gridDim.x / kCluster;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      // full: this CTA's producer, plus the bytes of its A box and of both
      // halves of the B tile; empty: every consumer warpgroup of the
      // cluster, since both CTAs' producers write each stage's B
      mbar_init(smem_addr(&full_bar[i]), 1);
      mbar_init(smem_addr(&empty_bar[i]), kConsumers * kCluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // both CTAs' barriers exist before either multicasts into the other
  cluster_sync();

  const int wg = threadIdx.x / 128;
  const int hw = s.H * s.W;
  const int ci_blocks = s.k_steps / 9;

  if (wg == 2) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 256) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&map_x))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&map_w))
                   : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (int pair = cluster; pair < s.pairs; pair += clusters) {
        const TileRef t = tile_ref(s, pair, rank);
        const int n = (int)(t.m0 / hw);
        const int y0 = (int)(t.m0 - (int64_t)n * hw) / s.W;
        for (int k = 0; k < s.k_steps; ++k) {
          const int tap = k / ci_blocks;
          const int ci0 = (k - tap * ci_blocks) * kBK;
          const int dy = tap / 3, dx = tap - 3 * (tap / 3);
          // both CTAs' consumers released this stage's previous contents
          mbar_wait(smem_addr(&empty_bar[stage]), phase ^ 1);
          const uint32_t full = smem_addr(&full_bar[stage]);
          mbar_expect_tx(full, kStageBytes);
          tma_load_4d(tile_a + stage * kABytes, &map_x, full, ci0, dx - 1,
                      y0 + dy - 1, n);
          // this CTA's half of the B tile (128 channels), to both CTAs
          tma_load_3d_multicast(
              tile_b + stage * kBBytes + rank * (kBBytes / 2), &map_w, full,
              (1 << kCluster) - 1, ci0, tap, t.co0 + (int)rank * (kBN / 2));
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      // stay until every stage's last contents are released by both CTAs:
      // the other CTA's consumers arrive on this CTA's barriers
      for (int i = 0; i < kStages; ++i) {
        mbar_wait(smem_addr(&empty_bar[stage]), phase ^ 1);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64 * wg .. 64 * wg + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    // a wgmma group completes for its whole warpgroup: one thread releases
    const bool wg_leader = t == 0;
    int stage = 0;
    uint32_t phase = 0;
    float d[128];
    for (int pair = cluster; pair < s.pairs; pair += clusters) {
      const TileRef tr = tile_ref(s, pair, rank);
#pragma unroll
      for (int i = 0; i < 128; ++i) d[i] = 0.f;
      int prev = -1;
      for (int k = 0; k < s.k_steps; ++k) {
        mbar_wait(smem_addr(&full_bar[stage]), phase);
        const uint64_t da =
            sw128_desc(tile_a + stage * kABytes + wg * (kABytes / 2));
        const uint64_t db = sw128_desc(tile_b + stage * kBBytes);
        fence_acc(d);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)   // 16 channels = 32 bytes
          wgmma_m64n256k16(d, da + 2 * kk, db + 2 * kk);
        wgmma_commit();
        // the group issued one step earlier is done: release its stage in
        // both CTAs
        wgmma_wait<1>();
        fence_acc(d);
        if (prev >= 0 && wg_leader)
          for (uint32_t r = 0; r < kCluster; ++r)
            mbar_arrive_in(smem_addr(&empty_bar[prev]), r);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(d);
      if (wg_leader)
        for (uint32_t r = 0; r < kCluster; ++r)
          mbar_arrive_in(smem_addr(&empty_bar[prev]), r);
      if (!tr.store) continue;

      // Epilogue: 64-channel chunks of the warpgroup's 64 rows, rounded
      // once to bf16 into its 128B-swizzled buffer (no bank conflicts),
      // then read back a 16-byte piece per thread and stored coalesced,
      // pieces past CO masked. Register i of thread t holds row
      // 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2), column
      // 8 * (i / 4) + 2 * (t % 4) + i % 2 of the m64nNk16 accumulator.
      const uint32_t buf = tile_o + wg * kOutBytes;
      const int r0 = 16 * (t / 32) + lane / 4;   // and r0 + 8: same swizzle
#pragma unroll
      for (int c = 0; c < kBN / kOutCols; ++c) {
        if (tr.co0 + c * kOutCols >= s.CO) break;
        warpgroup_sync(wg);   // the last chunk's pieces are read
#pragma unroll
        for (int jj = 0; jj < kOutCols / 8; ++jj) {
          const int j = c * (kOutCols / 8) + jj;
          const uint32_t at =
              buf + r0 * 128 + ((jj ^ (r0 % 8)) * 16) + 4 * (lane % 4);
          st_shared(at, __floats2bfloat162_rn(d[4 * j], d[4 * j + 1]));
          st_shared(at + 8 * 128,
                    __floats2bfloat162_rn(d[4 * j + 2], d[4 * j + 3]));
        }
        warpgroup_sync(wg);
#pragma unroll
        for (int q = 0; q < 64 * 8 / 128; ++q) {   // 64 rows x 8 pieces
          const int piece = t + 128 * q;
          const int row = piece / 8, ch = piece % 8;
          const uint4 v = ld_shared_16(buf + row * 128 + ((ch ^ (row % 8)) * 16));
          const int col = tr.co0 + c * kOutCols + ch * 8;
          if (col < s.CO)
            *reinterpret_cast<uint4*>(out + (tr.m0 + wg * 64 + row) * s.CO +
                                      col) = v;
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime, so the
// library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map with the 128-byte swizzle and zero fill out of bounds;
// dims and box innermost first, strides in bytes of dims 1.. .
bool encode(CUtensorMap* map, const void* base, int rank,
            const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Clusters of the kernel that the current card holds at once (queried once
// per device).
int resident_clusters(cudaLaunchConfig_t cfg) {
  static int cached[64] = {};
  int device = 0;
  cudaGetDevice(&device);
  if (device < 0 || device >= 64) return 0;
  if (cached[device] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cfg.gridDim = dim3(sms);
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, conv3x3_wgmma_kernel, &cfg) !=
        cudaSuccess)
      return 0;
    cached[device] = n;
  }
  return cached[device];
}

}  // namespace
}  // namespace marconet

// x (N, H, W, CI), wk (CO, 3, 3, CI), out (N, H, W, CO), all bf16 and
// contiguous, within the rule above. Returns cudaGetLastError() after the
// launch (0 on success), or an error code without launching when the
// inputs break the rule or a tensor map cannot be made.
extern "C" int marconet_conv3x3_wgmma(const void* x, const void* wk, void* out,
                                      int N, int H, int W, int CI, int CO,
                                      void* stream) {
  using namespace marconet;
  if (N <= 0 || H <= 0 || W <= 0 || CI <= 0 || CO <= 0 || CI % 8 != 0 ||
      CO % 8 != 0 || kBM % W != 0 || H % (kBM / W) != 0 ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wk) |
        reinterpret_cast<uintptr_t>(out)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  WgmmaShape s;
  s.H = H;
  s.W = W;
  s.CO = CO;
  s.k_steps = 9 * ((CI + kBK - 1) / kBK);
  s.co_tiles = (CO + kBN - 1) / kBN;
  const int64_t m_tiles = (int64_t)N * H * W / kBM;
  const int64_t pairs = (m_tiles + 1) / 2 * s.co_tiles;
  if (m_tiles > 0x3fffffff || pairs > 0x3fffffff)   // tile indices are int
    return (int)cudaErrorInvalidValue;
  s.m_tiles = (int)m_tiles;
  s.pairs = (int)pairs;

  CUtensorMap map_x, map_w;
  const cuuint64_t xdims[4] = {(cuuint64_t)CI, (cuuint64_t)W, (cuuint64_t)H,
                               (cuuint64_t)N};
  const cuuint64_t xstrides[3] = {(cuuint64_t)CI * 2, (cuuint64_t)W * CI * 2,
                                  (cuuint64_t)H * W * CI * 2};
  const cuuint32_t xbox[4] = {kBK, (cuuint32_t)W, (cuuint32_t)(kBM / W), 1};
  const cuuint64_t wdims[3] = {(cuuint64_t)CI, 9, (cuuint64_t)CO};
  const cuuint64_t wstrides[2] = {(cuuint64_t)CI * 2, (cuuint64_t)9 * CI * 2};
  const cuuint32_t wbox[3] = {kBK, 1, kBN / kCluster};
  if (!encode(&map_x, x, 4, xdims, xstrides, xbox) ||
      !encode(&map_w, wk, 3, wdims, wstrides, wbox))
    return (int)cudaErrorInvalidValue;

  cudaFuncSetAttribute(conv3x3_wgmma_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemBytes);
  cudaLaunchAttribute cluster_dim;
  cluster_dim.id = cudaLaunchAttributeClusterDimension;
  cluster_dim.val.clusterDim.x = kCluster;
  cluster_dim.val.clusterDim.y = 1;
  cluster_dim.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &cluster_dim;
  cfg.numAttrs = 1;
  // persistent: as many clusters as fit on the card at once, each a CTA
  // per SM
  const int clusters = resident_clusters(cfg);
  if (clusters <= 0) return (int)cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3(kCluster * (s.pairs < clusters ? s.pairs : clusters));
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, conv3x3_wgmma_kernel, map_x, map_w,
      static_cast<__nv_bfloat16*>(out), s);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
