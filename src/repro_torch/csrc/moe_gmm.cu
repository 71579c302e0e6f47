// K9 on Hopper: grouped matmul for MoE expert dispatch (kernel streams,
// paper §II-H, applied to the experts).
//
// Replaces the Pallas kernel repro/kernels/moe_gmm.py:moe_gmm (_kernel).
// Same function: tokens (T,D) grouped by expert into tiles of bm rows,
// weights (E,D,F) stacked per expert, tile_eid (ceil(T/bm),) int32 the
// expert of each tile; out (T,F) = the tile's rows @ weights[tile_eid], f32
// sums, out in the tokens' dtype (f32 or bf16).  Two extensions: a tile
// whose id lies outside [0, E) (the caller marks unused tiles with -1) comes
// out zero and reads no weight, and T, D and F need not be multiples of the
// blocks (every tail is masked).  Built with nvcc for sm_90a and bound
// through the plain C functions at the bottom (ctypes; see
// repro_torch/kernels/_build.py).
//
// What bounds it: in decode a tile holds a few routed rows, so the weights
// of the experts that have rows, each read once, bound it (bytes: a Jamba
// expert is 3 x 8192 x 24576 bf16 = 1.2 GB); in prefill each expert has
// hundreds of rows and the bf16 products bound it (tensor cores).
//
// Three kernels, one route each, chosen in the wrapper (kernels/moe_gmm.route):
//
// moe_gmm_kernel_wgmma, the prefill route: bf16 with bm a multiple of 64,
// D and F multiples of 8, tokens and weights 16-byte aligned (TMA).  K6's
// mainloop (matmul_fused.cu), widened, with the B operand picked per block:
//   * a block owns a 128 x 256 output tile (bm a multiple of 128) or a
//     64 x 256 one (bm 64), so it never straddles two tiles of the id
//     stream; it reads its tile's id at its start (the reference's scalar
//     prefetch);
//   * one thread of a producer warp keeps TMA loads of the tokens tile (64
//     deep, K-major) and of the weight tile in flight in a ring of 4 (2 at
//     bm 64) shared-memory stages on mbarriers; the weights' tensor map is
//     3-D over (F, D, E) with the expert as the third box coordinate, so a
//     D tail reads zeros, never the next expert's rows, and they are read
//     MN-major through wgmma's transpose bit, with no transposed copy;
//   * two consumer warpgroups run wgmma m64n256k16 (m64n128k16 at bm 64)
//     bf16 -> f32 and free a stage once the products that read it are
//     done; the first product of a tile sets the accumulator (d = 0), so
//     ptxas keeps the products in flight (K6's zeroed accumulator makes it
//     serialize them); one block an SM (two at bm 64);
//   * an id outside [0, E) issues no load and stores a zero tile;
//   * blocks are numbered down groups of 8 row tiles, column by column, so
//     the row tiles of one expert read each weight column tile at about the
//     same time: an expert's gate weight (403 MB at Jamba's widths) is far
//     above L2, and each tile of it comes from device memory about once;
//   * the results leave through the free ring in the 128-byte swizzle by
//     TMA stores, which drop the T and F tails.  No epilogue: SiLU and the
//     gate-times-up product stay in torch, as the reference's kernel has
//     none.  The helpers live in hopper.cuh.
//
// moe_gmm_kernel_stream, the bf16 decode route (bm 16, 32 or 48, the rule
// of the prefill route otherwise): decode reads each used expert's weights
// once for a few rows, a stream of bytes.  A persistent block per SM walks
// a work list of (used tile, 256-column box, D chunk) that every block
// derives from the id stream, so no block exists for a -1 tile and every
// SM streams to the end; one producer thread keeps TMA loads of 512
// contiguous bytes of 64 weight rows in flight in a 4-stage ring; four
// consumer warps multiply by mma.sync m16n8k16; where D is cut into chunks
// to fill the card, moe_stream_sum_kernel adds their f32 partials in chunk
// order (the same bits on every run).  Details at namespace st.
//
// moe_gmm_kernel, f32 and ragged or unaligned bf16: a tiled GEMM whose
// B operand is picked per block by the id stream, the way K4 reads its
// streams from device memory.
//   * A block owns a BM x BN output tile of one M-tile (bm % BM == 0); it
//     reads tile_eid at its start and, for an empty tile, writes zeros and
//     stops.  The grid is sized on the host from T alone.
//   * D is walked in BK steps through a ring of STAGES shared-memory
//     buffers filled by 16-byte cp.async copies (zero-filled past the
//     tails), so STAGES - 1 steps of loads are in flight while one is
//     multiplied: the weight stream is what decode waits on.
//   * bf16: mma.sync.m16n8k16 bf16 -> f32 on the tensor cores.  A fragments
//     come from row-major shared tiles by ldmatrix; the weights are (D,F)
//     with F contiguous, so B fragments come by ldmatrix.trans.  Shared rows
//     are padded by 16 bytes, so both ldmatrix forms are conflict-free.
//   * f32: true f32 FMAs on the SIMT cores (no TF32: the f32 path serves
//     the parity model, held to 1e-4 of the logits), each thread BM/8 rows
//     x 4 columns.
//   * BM is 16 when the rows per expert are few (decode: each touched
//     expert's weights stream once, BN 64 gives enough blocks), 64 or 128
//     for prefill.
// Offsets are 64-bit.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"     // TMA, mbarriers, wgmma, the tensor-map encoder
#include "mma_bf16.cuh"   // cp.async, ldmatrix, mma.sync, the warp tiles

namespace {

struct GmmArgs {
  const void* tokens;   // (T, D)
  const void* weights;  // (E, D, F)
  const int* tile_eid;  // (ceil(T / bm),)
  void* out;            // (T, F)
  int t, d, f, e, bm;
  bool vec;  // D, F multiples of the 16-byte vector and pointers aligned
};

// A stage: the (BM x BK) token slice at (m0, k0) and the (BK x BN) weight
// slice at (k0, n0) of expert weight `w`.
template <typename T, int BM, int BN, int BK, int STAGES>
using Layout = Smem<T, BM, BK, BK, BN, STAGES>;

template <typename T, int BM, int BN, int BK, int STAGES>
__device__ __forceinline__ void load_stage(const GmmArgs& a, const T* w, T* sa, T* sb,
                                           int64_t m0, int n0, int k0) {
  using L = Layout<T, BM, BN, BK, STAGES>;
  const T* x = static_cast<const T*>(a.tokens);
  const int rows = a.t - m0 < BM ? static_cast<int>(a.t - m0) : BM;
  load_tile<T, BM, BK, L::kAStride>(sa, x + m0 * a.d + k0, x, a.d, rows, a.d - k0, a.vec);
  load_tile<T, BK, BN, L::kBStride>(sb, w + static_cast<int64_t>(k0) * a.f + n0, w, a.f,
                                    a.d - k0, a.f - n0, a.vec);
}

// grid (ceil(F / BN), ceil(T / BM)); dynamic shared memory Layout::kBytes.
template <typename P, int BM, int BN, int BK, int STAGES>
__global__ void __launch_bounds__(kThreads)
moe_gmm_kernel(const GmmArgs a) {
  using T = typename P::T;
  using L = Layout<T, BM, BN, BK, STAGES>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sa = reinterpret_cast<T*>(smem);
  T* sb = sa + STAGES * L::kAElems;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int n0 = blockIdx.x * BN;
  const int eid = __ldg(a.tile_eid + m0 / a.bm);

  P p;
  p.init();
  if (eid >= 0 && eid < a.e) {
    const T* w = static_cast<const T*>(a.weights) + static_cast<int64_t>(eid) * a.d * a.f;
    const int nk = (a.d + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk)
        load_stage<T, BM, BN, BK, STAGES>(a, w, sa + s * L::kAElems, sb + s * L::kBElems, m0, n0,
                                          s * BK);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<STAGES - 2>();  // step kt has landed
      __syncthreads();              // and every warp is done with step kt - 1
      const int nxt = kt + STAGES - 1;
      if (nxt < nk) {
        const int buf = nxt % STAGES;
        load_stage<T, BM, BN, BK, STAGES>(a, w, sa + buf * L::kAElems, sb + buf * L::kBElems, m0,
                                          n0, nxt * BK);
      }
      cp_async_commit();
      const int buf = kt % STAGES;
      p.template compute<L::kAStride, L::kBStride>(sa + buf * L::kAElems, sb + buf * L::kBElems);
    }
    cp_async_wait<0>();
  }
  p.store(static_cast<T*>(a.out), m0, n0, a.t, a.f);
}

template <typename P, int BM, int BN, int BK, int STAGES>
int launch(const GmmArgs& a, cudaStream_t s) {
  using L = Layout<typename P::T, BM, BN, BK, STAGES>;
  auto kernel = moe_gmm_kernel<P, BM, BN, BK, STAGES>;
  if (L::kBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t m_blocks = (static_cast<int64_t>(a.t) + BM - 1) / BM;
  if (m_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((a.f + BN - 1) / BN), static_cast<unsigned>(m_blocks));
  kernel<<<grid, kThreads, L::kBytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---- the bf16 prefill route: TMA + wgmma ----------------------------------

namespace wg {

using namespace hopper;

constexpr int kBK = 64;                          // k of a stage: 128 bytes of bf16
constexpr int kConsumers = 2;                    // warpgroups of 64 rows each
constexpr int kThreads = 128 * kConsumers + 32;  // + one producer warp
constexpr int kBox = kBK * 64 * 2;               // one 64 x 64 bf16 box, 8 KB
constexpr int kGroupM = 8;                       // row tiles of a raster group

// kMW: consumer warpgroups along M.  2: a 128 x 256 block (bm a multiple
// of 128), each warpgroup 64 rows x 256 columns, a 4-stage ring, one block
// an SM; 1: a 64 x 256 block (bm 64), each warpgroup 64 x 128, a 2-stage
// ring, two blocks an SM.  A block never straddles two tiles of the id
// stream.
template <int kMW>
struct Tile {
  static constexpr int kBM = 64 * kMW;
  static constexpr int kBN = 256;
  static constexpr int kNC = kBN * kMW / kConsumers;  // columns of a warpgroup
  static constexpr int kStages = kMW == 2 ? 4 : 2;
  static constexpr int kPerSm = kMW == 2 ? 1 : 2;     // what shared memory allows
  static constexpr int kABytes = kBM * kBK * 2;       // tokens, K-major
  static constexpr int kBBytes = kBK * kBN * 2;       // weights, kBN / 64 boxes
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSmem = kStages * kStageBytes + 1024;  // + 1 KB alignment
};

struct Args {
  const int* tile_eid;
  int t, d, f, e, bm;
};

// One block: a kBM x kBN output tile of one tile of the id stream.  Blocks
// are numbered down groups of kGroupM row tiles, column by column, so the
// row tiles of one expert (consecutive in the stream) read each weight
// column tile at about the same time, and it comes from device memory about
// once per expert.
template <int kMW>
__global__ void __launch_bounds__(kThreads, Tile<kMW>::kPerSm)
moe_gmm_kernel_wgmma(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w,
                     const __grid_constant__ CUtensorMap map_out, const Args p) {
  using G = Tile<kMW>;
  constexpr int kStages = G::kStages;
  constexpr int kNC = G::kNC;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];   // the stage's loads landed
  __shared__ __align__(8) uint64_t empty[kStages];  // both consumers are done with it
  // 128-byte swizzle repeats every 1 KB: the ring starts on a 1 KB boundary
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int w = threadIdx.x / 128;  // consumer warpgroup, or kConsumers: the producer
  const int tiles_m = (p.t + G::kBM - 1) / G::kBM;
  const int tiles_n = (p.f + G::kBN - 1) / G::kBN;
  const int per_group = kGroupM * tiles_n;
  const int first_m = static_cast<int>(blockIdx.x) / per_group * kGroupM;
  const int rows = min(tiles_m - first_m, kGroupM);
  const int in_group = static_cast<int>(blockIdx.x) % per_group;
  const int m0 = (first_m + in_group % rows) * G::kBM;
  const int n0 = in_group / rows * G::kBN;
  // the tile's expert (the reference's scalar prefetch); an id outside
  // [0, E) gives a zero tile and loads no weight
  const int eid = __ldg(p.tile_eid + m0 / p.bm);
  const int k_tiles = eid >= 0 && eid < p.e ? (p.d + kBK - 1) / kBK : 0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (w == kConsumers) {  // the producer warp: one thread keeps the ring full
    if (threadIdx.x == 128 * kConsumers) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % kStages;
        mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);  // the first round passes
        uint8_t* sa = ring + s * G::kStageBytes;
        uint8_t* sb = sa + G::kABytes;
        mbar_expect_tx(&full[s], G::kStageBytes);
        tma_load(sa, &map_x, &full[s], kt * kBK, m0);
#pragma unroll
        for (int box = 0; box < G::kBN / 64; ++box)
          tma_load_3d(sb + box * kBox, &map_w, &full[s], n0 + box * 64, kt * kBK, eid);
      }
    }
    return;
  }

  // a consumer: rows mw*64 .. + 63, columns nw*kNC .. + kNC - 1 of the
  // block; its first product sets the accumulator (d = 0), so no
  // instruction but wgmma defines it inside the loop
  const int mw = w % kMW, nw = w / kMW;
  float acc[kNC / 2];
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % kStages;
    mbar_wait(&full[s], (kt / kStages) & 1);
    const uint32_t sa = smem_u32(ring + s * G::kStageBytes) + mw * 64 * 128;
    const uint32_t sb = smem_u32(ring + s * G::kStageBytes + G::kABytes) + nw * (kNC / 64) * kBox;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_bf16(acc, desc_sw128(sa + kk * 32, 16, 1024),
                 desc_sw128(sb + kk * 16 * 128, kBox, 1024), kt > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // the products of stage kt-1 are done: free it
    if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(kt - 1) % kStages]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (k_tiles == 0) {  // an empty tile: zeros
#pragma unroll
    for (int i = 0; i < kNC / 2; ++i) acc[i] = 0.f;
  }

  // Both consumers are past their last wgmma: the ring is free.  Each
  // warpgroup writes its 64 x kNC bf16 results into it as 64 x 64 boxes in
  // the 128-byte swizzle, and one thread stores them with TMA, which drops
  // what lies past T or F.
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
  uint8_t* tile = ring + w * (kNC / 64) * kBox;
  const int t = threadIdx.x % 128;
  const int r0 = (t / 32) * 16 + (t % 32) / 4;
#pragma unroll
  for (int j = 0; j < kNC / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(tile + sw128_at(r0 + 8 * h, j * 8 + (t % 4) * 2, kBox)) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  fence_async_smem();
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + w) : "memory");
  if (t == 0) {
#pragma unroll
    for (int box = 0; box < kNC / 64; ++box)
      tma_store(&map_out, tile + box * kBox, n0 + nw * kNC + box * 64, m0 + mw * 64);
    tma_store_wait();
  }
}

template <int kMW>
int launch(const void* tokens, const void* weights, const int* tile_eid, void* out, int t, int d,
           int f, int e, int bm, cudaStream_t stream) {
  using G = Tile<kMW>;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map_x, map_w, map_out;
  if (!encode(fn, &map_x, tokens, t, d, G::kBM, kBK) ||
      !encode_3d(fn, &map_w, weights, e, d, f, kBK, 64) ||
      !encode(fn, &map_out, out, t, f, 64, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  // per call: the attribute belongs to the current device
  const cudaError_t err = cudaFuncSetAttribute(
      moe_gmm_kernel_wgmma<kMW>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = static_cast<int64_t>((t + G::kBM - 1) / G::kBM) *
                         ((f + G::kBN - 1) / G::kBN);
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const Args p{tile_eid, t, d, f, e, bm};
  moe_gmm_kernel_wgmma<kMW><<<static_cast<unsigned>(blocks), kThreads, G::kSmem, stream>>>(
      map_x, map_w, map_out, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ---- the bf16 decode route: a weight stream ---------------------------------

namespace st {

using namespace hopper;

constexpr int kBK = 64;                          // D rows of a stage (128 bytes of tokens)
constexpr int kBN = 256;                         // F columns of an item: 512 bytes a weight row
constexpr int kConsumers = 4;                    // warps, one 64-column box each
constexpr int kThreads = 32 * (kConsumers + 1);  // + one producer warp
constexpr int kStages = 4;
constexpr int kBox = kBK * 64 * 2;               // one 64 x 64 bf16 box, 8 KB
constexpr int kWeightStage = kConsumers * kBox;  // 32 KB of weights a stage
constexpr int kMaxTiles = 2048;                  // the id stream a block lists
constexpr int kMaxSplits = 8;

// MT m16 tiles of rows (bm = 16 * MT): a stage holds the four weight boxes
// and the tile's bm x 64 tokens.
template <int MT>
struct Tile {
  static constexpr int kXBytes = MT * 16 * 128;
  static constexpr int kStageBytes = kWeightStage + kXBytes;
  static constexpr int kSmem = kStages * kStageBytes + 1024;  // + 1 KB alignment
};

struct Args {
  const int* tile_eid;
  __nv_bfloat16* out;  // (T, F)
  float* part;         // (s_max, T, F) partial sums when D is split, else unused
  int t, d, f, e, bm, s_max;
};

// How the used tiles' work is cut: `splits` chunks of `chunk` stages of D
// per (used tile, column box).  The rule of kernels/moe_gmm.stream_splits:
// the split whose rounds of items over `grid` blocks move the fewest bytes
// (weights, and each split's f32 partial written and read back), the
// fewest splits on a tie.  Whole rounds keep the card's blocks on
// neighbouring column boxes of the same D rows at the same time.
struct Plan {
  int splits, chunk;
};

__device__ Plan plan(int n_used, int n_col, int k_steps, int grid, int s_max, int bm) {
  Plan best{1, k_steps};
  int64_t best_cost = -1;
  const int top = min(s_max, k_steps);
  for (int s = 1; s <= top; ++s) {
    const int chunk = (k_steps + s - 1) / s;
    if ((k_steps + chunk - 1) / chunk != s) continue;  // no two splits alike
    const int64_t items = static_cast<int64_t>(n_used) * n_col * s;
    const int64_t rounds = (items + grid - 1) / grid;
    const int64_t cost =
        rounds * (static_cast<int64_t>(chunk) * kBK * kBN * 2 + (s > 1 ? bm * kBN * 8 : 0));
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = Plan{s, chunk};
    }
  }
  return best;
}

// The used tiles of the id stream (ids in [0, E)), in order, into `used`
// and their ids into `used_eid`, by the whole block; returns their count.
__device__ int list_used(const int* tile_eid, int tiles, int e, int* used, int* used_eid,
                         int* warp_count) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  int base = 0;
  for (int i0 = 0; i0 < tiles; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const int id = i < tiles ? __ldg(tile_eid + i) : -1;
    const bool keep = id >= 0 && id < e;
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_count[warp] = __popc(mask);
    __syncthreads();
    int before = base, total = 0;
    for (int w = 0; w < warps; ++w) {
      if (w < warp) before += warp_count[w];
      total += warp_count[w];
    }
    if (keep) {
      const int slot = before + __popc(mask & ((1u << lane) - 1));
      used[slot] = i;
      used_eid[slot] = id;
    }
    base += total;
    __syncthreads();  // warp_count is written again
  }
  return base;
}

// A persistent block per SM walks the work list (used tile, column box of
// kBN, D chunk), item w = blockIdx.x + i * gridDim.x: the used tile
// outermost, so one expert's columns are read together; no item exists for
// a tile outside [0, E).  One producer thread keeps a ring of kStages
// stages of TMA loads in flight (32 KB of weights each, three or four
// stages = 96-128 KB an SM: at HBM's ~1 us latency, 3.35 TB/s needs about
// 32 KB an SM), across item boundaries; four consumer warps each multiply
// one 64-column box by mma.sync m16n8k16 bf16 -> f32 and store their
// item's results from registers: bf16 into out when D is whole, else f32
// into the chunk's slice of `part`, which moe_stream_sum_kernel adds up.
template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
moe_gmm_kernel_stream(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_w, const Args p) {
  using G = Tile<MT>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];   // the stage's loads landed
  __shared__ __align__(8) uint64_t empty[kStages];  // every consumer is done with it
  __shared__ int used[kMaxTiles], used_eid[kMaxTiles];
  __shared__ int warp_count[kConsumers + 1];
  // 128-byte swizzle repeats every 1 KB: the ring starts on a 1 KB boundary
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int tiles = (p.t + p.bm - 1) / p.bm;
  const int n_used = list_used(p.tile_eid, tiles, p.e, used, used_eid, warp_count);
  const int n_col = (p.f + kBN - 1) / kBN;
  const int k_steps = (p.d + kBK - 1) / kBK;
  const Plan pl = plan(n_used, n_col, k_steps, gridDim.x, p.s_max, p.bm);
  const int64_t items = static_cast<int64_t>(n_used) * n_col * pl.splits;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kConsumers) {  // the producer warp: one thread keeps the ring full
    if (lane == 0) {
      int it = 0;
      for (int64_t w = blockIdx.x; w < items; w += gridDim.x) {
        const int j = static_cast<int>(w % pl.splits);
        const int col = static_cast<int>(w / pl.splits % n_col);
        const int u = static_cast<int>(w / pl.splits / n_col);
        const int m0 = used[u] * p.bm, eid = used_eid[u], n0 = col * kBN;
        const int k_end = min((j + 1) * pl.chunk, k_steps);
        for (int kt = j * pl.chunk; kt < k_end; ++kt, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);  // the first round passes
          uint8_t* stage = ring + s * G::kStageBytes;
          mbar_expect_tx(&full[s], G::kStageBytes);
#pragma unroll
          for (int box = 0; box < kConsumers; ++box)
            tma_load_3d(stage + box * kBox, &map_w, &full[s], n0 + box * 64, kt * kBK, eid);
          tma_load(stage + kWeightStage, &map_x, &full[s], kt * kBK, m0);
        }
      }
    }
    return;
  }

  // a consumer warp: columns n0 + warp * 64 .. + 63 of its items
  const int g = lane >> 2, tq = lane & 3;
  int it = 0;
  for (int64_t w = blockIdx.x; w < items; w += gridDim.x) {
    const int j = static_cast<int>(w % pl.splits);
    const int col = static_cast<int>(w / pl.splits % n_col);
    const int u = static_cast<int>(w / pl.splits / n_col);
    const int m0 = used[u] * p.bm, n0 = col * kBN + warp * 64;
    const int k_end = min((j + 1) * pl.chunk, k_steps);
    float acc[MT][8][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][n][c] = 0.f;
    for (int kt = j * pl.chunk; kt < k_end; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const uint8_t* sb = ring + s * G::kStageBytes + warp * kBox;
      const uint8_t* sa = ring + s * G::kStageBytes + kWeightStage;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        uint32_t af[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          ldmatrix_x4(af[i], sa + sw128_at(i * 16 + (lane & 15), kk + (lane >> 4) * 8, 0));
        uint32_t bf[8][2];
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, sb + sw128_at(kk + (lane & 15), jp * 16 + (lane >> 4) * 8, kBox));
          bf[2 * jp][0] = r[0];
          bf[2 * jp][1] = r[1];
          bf[2 * jp + 1][0] = r[2];
          bf[2 * jp + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int n = 0; n < 8; ++n) mma_bf16(acc[i][n], af[i], bf[n][0], bf[n][1]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // F % 8 == 0 and the column is even: a pair is in bounds when its first is
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = n0 + n * 8 + 2 * tq;
        if (c >= p.f) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + i * 16 + g + 8 * h;
          if (row >= p.t) continue;
          const int64_t at = static_cast<int64_t>(row) * p.f + c;
          if (pl.splits == 1)
            *reinterpret_cast<__nv_bfloat162*>(p.out + at) =
                __floats2bfloat162_rn(acc[i][n][2 * h], acc[i][n][2 * h + 1]);
          else
            *reinterpret_cast<float2*>(p.part + static_cast<int64_t>(j) * p.t * p.f + at) =
                make_float2(acc[i][n][2 * h], acc[i][n][2 * h + 1]);
        }
      }
  }
}

// The second pass, a block for each 2,048 columns of each tile: a tile
// outside [0, E) comes out zero; a used tile's rows take its D chunks'
// partials summed in chunk order when D was split, and are left as the
// main kernel wrote them otherwise (the block returns at once).  Named
// apart from moe_gmm_kernel_*, so a profiler trace tells the two apart.
constexpr int kSumCols = 8 * 256;  // 8 columns a thread

__global__ void __launch_bounds__(256)
moe_stream_sum_kernel(const Args p, int grid_main) {
  __shared__ int n_used;
  const int tile = blockIdx.y;
  const int id = __ldg(p.tile_eid + tile);
  const bool use = id >= 0 && id < p.e;
  int splits = 1;
  if (use) {  // the split needs the count of used tiles
    const int tiles = (p.t + p.bm - 1) / p.bm;
    if (threadIdx.x == 0) n_used = 0;
    __syncthreads();
    int mine = 0;
    for (int i = threadIdx.x; i < tiles; i += blockDim.x) {
      const int other = __ldg(p.tile_eid + i);
      mine += other >= 0 && other < p.e;
    }
    if (mine) atomicAdd(&n_used, mine);
    __syncthreads();
    splits = plan(n_used, (p.f + kBN - 1) / kBN, (p.d + kBK - 1) / kBK, grid_main, p.s_max,
                  p.bm).splits;
    if (splits == 1) return;
  }
  const int col = blockIdx.x * kSumCols + threadIdx.x * 8;
  if (col >= p.f) return;
  const int64_t plane = static_cast<int64_t>(p.t) * p.f;
  const int row_end = min((tile + 1) * p.bm, p.t);
  for (int row = tile * p.bm; row < row_end; ++row) {
    const int64_t at = static_cast<int64_t>(row) * p.f + col;
    float sum[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) sum[c] = 0.f;
    for (int j = 0; j < (use ? splits : 0); ++j) {
      const float4* src = reinterpret_cast<const float4*>(p.part + j * plane + at);
      const float4 lo = src[0], hi = src[1];
      sum[0] += lo.x;
      sum[1] += lo.y;
      sum[2] += lo.z;
      sum[3] += lo.w;
      sum[4] += hi.x;
      sum[5] += hi.y;
      sum[6] += hi.z;
      sum[7] += hi.w;
    }
    uint4 packed;
    __nv_bfloat162* pk = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int c = 0; c < 4; ++c) pk[c] = __floats2bfloat162_rn(sum[2 * c], sum[2 * c + 1]);
    *reinterpret_cast<uint4*>(p.out + at) = packed;
  }
}

template <int MT>
int launch(const void* tokens, const void* weights, const Args& a, cudaStream_t stream) {
  using G = Tile<MT>;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map_x, map_w;
  if (!encode(fn, &map_x, tokens, a.t, a.d, 16 * MT, kBK) ||
      !encode_3d(fn, &map_w, weights, a.e, a.d, a.f, kBK, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  // per call: the attribute and the SM count belong to the current device
  cudaError_t err = cudaFuncSetAttribute(moe_gmm_kernel_stream<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_gmm_kernel_stream<MT><<<sms, kThreads, G::kSmem, stream>>>(map_x, map_w, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_sum((a.f + kSumCols - 1) / kSumCols, (a.t + a.bm - 1) / a.bm);
  moe_stream_sum_kernel<<<grid_sum, 256, 0, stream>>>(a, sms);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace st

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// tokens (T,D), weights (E,D,F), out (T,F) contiguous, all of one dtype
// (0 = f32, 1 = bf16); tile_eid (ceil(T/bm),) int32 on the device.  bm must
// be a multiple of 16; the block height is the largest of 128, 64, 16 that
// divides it.  Launches on `stream` without synchronising and returns a
// cudaError_t (0 on success).
extern "C" int repro_moe_gmm(const void* tokens, const void* weights, const int* tile_eid,
                             void* out, int t, int d, int f, int e, int bm, int dtype,
                             void* stream) {
  if (t <= 0 || d < 0 || f <= 0 || e <= 0 || bm <= 0 || bm % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  GmmArgs a{tokens, weights, tile_eid, out, t, d, f, e, bm, false};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    a.vec = d % 8 == 0 && f % 8 == 0 && aligned(tokens) && aligned(weights);
    if (bm % 128 == 0) return launch<MmaBf16<128, 128, 32, 2, 2>, 128, 128, 32, 3>(a, s);
    if (bm % 64 == 0) return launch<MmaBf16<64, 128, 32, 2, 2>, 64, 128, 32, 3>(a, s);
    return launch<MmaBf16<16, 64, 64, 1, 4>, 16, 64, 64, 4>(a, s);
  }
  if (dtype == 0) {
    a.vec = d % 4 == 0 && f % 4 == 0 && aligned(tokens) && aligned(weights);
    if (bm % 128 == 0) return launch<SimtF32<128, 64, 32>, 128, 64, 32, 3>(a, s);
    if (bm % 64 == 0) return launch<SimtF32<64, 64, 32>, 64, 64, 32, 3>(a, s);
    return launch<SimtF32<16, 64, 32>, 16, 64, 32, 3>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 prefill route: tokens (T,D), weights (E,D,F), out (T,F), all
// bf16, with D and F positive multiples of 8, tokens and weights 16-byte
// aligned and bm a multiple of 64 (kernels/moe_gmm.route); tile_eid
// (ceil(T/bm),) int32 on the device.  Returns a cudaError_t:
// cudaErrorInvalidValue for arguments off that rule or a tensor map
// cuTensorMapEncodeTiled refuses, cudaErrorNotSupported when libcuda has no
// cuTensorMapEncodeTiled.
extern "C" int repro_moe_gmm_wgmma(const void* tokens, const void* weights, const int* tile_eid,
                                   void* out, int t, int d, int f, int e, int bm, void* stream) {
  if (t <= 0 || d <= 0 || f <= 0 || e <= 0 || bm <= 0 || bm % 64 != 0 || d % 8 != 0 ||
      f % 8 != 0 || tokens == nullptr || weights == nullptr || tile_eid == nullptr ||
      out == nullptr || !aligned(tokens) || !aligned(weights) || !aligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bm % 128 ? wg::launch<1>(tokens, weights, tile_eid, out, t, d, f, e, bm, s)
                  : wg::launch<2>(tokens, weights, tile_eid, out, t, d, f, e, bm, s);
}

// The bf16 decode route, a weight stream: tokens (T,D), weights (E,D,F),
// out (T,F), all bf16, with D and F positive multiples of 8, tokens, weights
// and out 16-byte aligned, bm 16, 32 or 48 and at most 2,048 tiles
// (kernels/moe_gmm.route); tile_eid (ceil(T/bm),) int32 on the device;
// `partial` an f32 scratch (s_max, T, F), 16-byte aligned, for the D
// chunks' sums when s_max > 1 (1 <= s_max <= 8; unused at 1).  Launches
// the stream kernel, one block an SM, and its sum pass on `stream` without
// synchronising.  Returns a cudaError_t: cudaErrorInvalidValue for
// arguments off that rule or a tensor map cuTensorMapEncodeTiled refuses,
// cudaErrorNotSupported when libcuda has no cuTensorMapEncodeTiled.
extern "C" int repro_moe_gmm_stream(const void* tokens, const void* weights, const int* tile_eid,
                                    void* out, float* partial, int t, int d, int f, int e, int bm,
                                    int s_max, void* stream) {
  if (t <= 0 || d <= 0 || f <= 0 || e <= 0 || bm <= 0 || bm % 16 != 0 || bm >= 64 ||
      d % 8 != 0 || f % 8 != 0 || tokens == nullptr || weights == nullptr ||
      tile_eid == nullptr || out == nullptr || !aligned(tokens) || !aligned(weights) ||
      !aligned(out) || s_max < 1 || s_max > st::kMaxSplits ||
      (s_max > 1 && (partial == nullptr || !aligned(partial))) ||
      (t + bm - 1) / bm > st::kMaxTiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const st::Args a{tile_eid, static_cast<__nv_bfloat16*>(out), partial, t, d, f, e, bm, s_max};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bm / 16) {
    case 1: return st::launch<1>(tokens, weights, a, s);
    case 2: return st::launch<2>(tokens, weights, a, s);
    default: return st::launch<3>(tokens, weights, a, s);
  }
}
