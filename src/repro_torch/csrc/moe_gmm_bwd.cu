// K9' on Hopper: the backward of K9, the grouped matmul of the MoE layer.
//
// Replaces no Pallas kernel: the reference's K9 (repro/kernels/moe_gmm.py:
// moe_gmm) has no custom_vjp, and its training step differentiates the
// einsum dispatch (repro/kernels/ref.py:moe_gmm) with XLA's autodiff.  This
// computes that gradient.  K9 is out[r] = tokens[r] @ weights[e(r)] for the
// rows r of each tile of bm rows, e(r) the tile's id in tile_eid, a tile of
// an id outside [0, E) giving zero rows.  Given dout (T,F):
//   dtokens[r]  = dout[r] @ weights[e(r)]^T                 (T,D)
//   dweights[e] = sum over the tiles of id e of tokens_tile^T @ dout_tile
//                                                            (E,D,F)
// rows of a tile outside [0, E) get a zero dtokens and add to no dweights;
// an expert with no tile gets a zero dweights.  f32 sums, each output
// rounded once to its operand's dtype (f32 or bf16).  Built with nvcc for
// sm_90a and bound through the plain C function at the bottom (ctypes; see
// repro_torch/kernels/_build.py).
//
// What bounds it: the products, 4 * rows * D * F operations for the two
// (rows: the rows of tiles in [0, E)); at Jamba's widths far above the
// ridge, so the bf16 tensor cores.
//
// Two kernels, one per gradient, each a tiled GEMM on K9's "mma" route
// skeleton (csrc/mma_bf16.cuh: a ring of STAGES shared-memory buffers
// filled by 16-byte cp.async copies, zero-filled past every tail;
// mma.sync m16n8k16 bf16 -> f32; f32 operands on the SIMT cores in true
// f32).  No atomics and a fixed order of every sum, so two calls give the
// same bits.
//   * moe_gmm_bwd_dx_kernel: a block owns a BM x BN tile of dtokens inside
//     one tile of the id stream and reduces over F.  F is contiguous in the
//     weights, so a (BN rows of D) x (BK of F) slice of weights[e] is
//     staged as it lies and read by plain ldmatrix as the col-major B
//     operand (the forward reads (D,F) row-major with ldmatrix.trans): no
//     transposed copy of the weights.  A tile outside [0, E) stores zeros.
//   * moe_gmm_bwd_dw_kernel: a block owns a BM x BN tile (rows of D,
//     columns of F) of one expert's dweights and walks the id stream in
//     order, taking the BK-row steps of each tile of its expert (rows past
//     a tile's end or T read as zero).  The tokens slice (BK rows x BM of
//     D) is staged as it lies and read by ldmatrix.trans as the row-major
//     A operand tokens^T; the dout slice is the forward's B layout.  The
//     kernel reads tile_eid on the card; an expert with no tile stores
//     zeros (the output is torch.empty).
// Offsets are 64-bit.
//
// The "wgmma" route (bf16, bm a multiple of 64, D and F multiples of 8,
// every operand 16-byte aligned: kernels/moe_gmm.route_bwd, the forward's
// prefill rule): two Hopper kernels on K9's prefill skeleton (csrc/
// moe_gmm.cu, namespace wg) whose design follows what bounds each at the
// cut's shapes (1152 rows in tiles of 128, 4 held experts, D 8192, F
// 24576): the used experts' weights read once (1.2 GB) for dtokens, every
// expert's dweights written once (1.6 GB) for dweights.
//   * moe_gmm_bwd_dx_kernel_wgmma: a block owns a 128 x 256 tile of dtokens
//     (64 x 256 at bm 64) inside one tile of the id stream and reduces over
//     F in steps of 64.  One producer thread keeps TMA loads of the dout
//     tile (K-major) and of a 256-row x 64 box of W[e] in a 4-stage ring
//     (2 at bm 64); W[e] is (D, F) with F contiguous, so as B it is K-major
//     as it lies: read through a 3-D (F, D, E) tensor map with the tile's
//     expert as the third coordinate and the transpose bit off (wgmma
//     m64n256k16, hopper.cuh wgmma_bf16_kk).  Blocks are numbered down
//     groups of 8 row tiles, so an expert's row tiles read each weight box
//     at about the same time and it comes from HBM about once.  A tile of
//     an id outside [0, E) issues no load and stores a zero tile (no
//     product; 5 of the cut's 9 row tiles, 10 MB of zeros).  The results
//     leave through the free ring by TMA stores.
//   * moe_gmm_bwd_dw_kernel_wgmma: one persistent block an SM walks a work
//     list of (expert, 128 rows of D, 256 columns of F) items, expert-major
//     and F fastest, which every block derives on the card from tile_eid
//     (each expert's tiles in id-stream order, build_lists), so the 132
//     items in flight share one expert's tokens and dout slices in L2.  An
//     item's K steps are the 64-row slices of its expert's tiles: the
//     tokens slice (64 rows x 128 of D, two boxes) is A = tokens^T read
//     M-major through the transpose bit, the dout slice (64 rows x 256 of
//     F, four boxes) is B, MN-major (hopper.cuh wgmma_bf16_tt), both as
//     they lie.  The producer runs ahead across items in a 3-stage ring.
//     Each consumer warpgroup rounds its 64 x 256 sums to bf16 into its
//     half of a 64 KB staged tile and one thread stores it by TMA through a
//     3-D (F, D, E) map, then the warpgroup goes on to the next item's
//     products while the store drains: it waits for the store to have read
//     the staged tile (cp.async.bulk.wait_group.read) only when it is about
//     to write it again.  (Storing box by box, each box a bulk group of its
//     own waited for alone, measured the same.)  An expert with no tile has
//     items that load nothing and store zeros.
//     The item's box, reckoned: 128 x 256 is what two warpgroups' registers
//     hold (128 f32 a thread).  Each item writes 64 KB and reads its
//     expert's rows x (128 + 256) x 2 bytes from L2: at the cut's 128-256
//     rows an expert, tokens are read F / 256 = 96 times and dout D / 128 =
//     64 times, 2.4 GB from L2 against 1.6 GB written to HBM (0.48 ms at
//     3.35 TB/s), which L2's several TB/s carry under the writes.  A
//     256 x 256 box would halve the dout reads but needs four warpgroups'
//     registers and leaves no room for the staged tile.
// Both kernels sum in f32 in a fixed order (wgmma's k steps, then the F
// steps or the tiles' 64-row slices in order), round each output once and
// use no atomics, so two calls give the same bits.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"    // TMA, mbarriers, wgmma, the tensor-map encoder
#include "mma_bf16.cuh"  // cp.async, ldmatrix, mma.sync, the warp tiles

namespace {

struct BwdArgs {
  const void* tokens;   // (T, D)
  const void* weights;  // (E, D, F)
  const int* tile_eid;  // (ceil(T / bm),)
  const void* dout;     // (T, F)
  void* dtok;           // (T, D)
  void* dw;             // (E, D, F)
  int t, d, f, e, bm;
  bool vec;  // D, F multiples of the 16-byte vector and pointers aligned
};

// dtokens: grid (ceil(D / BN), ceil(T / BM)), BM dividing bm; dynamic
// shared memory Smem<T, BM, BK, BN, BK, STAGES>::kBytes.  A = dout rows x
// BK of F, B = weights[e] BN rows of D x BK of F.
template <typename P, int BM, int BN, int BK, int STAGES>
__global__ void __launch_bounds__(kThreads)
moe_gmm_bwd_dx_kernel(const BwdArgs a) {
  using T = typename P::T;
  using L = Smem<T, BM, BK, BN, BK, STAGES>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sa = reinterpret_cast<T*>(smem);
  T* sb = sa + STAGES * L::kAElems;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int n0 = blockIdx.x * BN;
  const int eid = __ldg(a.tile_eid + m0 / a.bm);

  P p;
  p.init();
  if (eid >= 0 && eid < a.e) {
    const T* dout = static_cast<const T*>(a.dout);
    const T* w = static_cast<const T*>(a.weights) + static_cast<int64_t>(eid) * a.d * a.f;
    const int rows = a.t - m0 < BM ? static_cast<int>(a.t - m0) : BM;
    const int cols = min(BN, a.d - n0);
    auto stage = [&](int buf, int k0) {
      load_tile<T, BM, BK, L::kAStride>(sa + buf * L::kAElems, dout + m0 * a.f + k0, dout, a.f,
                                        rows, a.f - k0, a.vec);
      load_tile<T, BN, BK, L::kBStride>(sb + buf * L::kBElems,
                                        w + static_cast<int64_t>(n0) * a.f + k0, w, a.f, cols,
                                        a.f - k0, a.vec);
    };
    const int nk = (a.f + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk) stage(s, s * BK);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<STAGES - 2>();  // step kt has landed
      __syncthreads();              // and every warp is done with step kt - 1
      const int nxt = kt + STAGES - 1;
      if (nxt < nk) stage(nxt % STAGES, nxt * BK);
      cp_async_commit();
      const int buf = kt % STAGES;
      p.template compute<L::kAStride, L::kBStride>(sa + buf * L::kAElems, sb + buf * L::kBElems);
    }
    cp_async_wait<0>();
  }
  p.store(static_cast<T*>(a.dtok), m0, n0, a.t, a.d);
}

// The first tile at or after `from` whose id is e, or `tiles`.
__device__ __forceinline__ int next_tile(const int* tile_eid, int from, int tiles, int e) {
  for (int i = from; i < tiles; ++i)
    if (__ldg(tile_eid + i) == e) return i;
  return tiles;
}

// dweights: grid (ceil(F / BN), ceil(D / BM), E); dynamic shared memory
// Smem<T, BK, BM, BK, BN, STAGES>::kBytes.  A = tokens BK rows x BM of D
// (tokens^T read as stored), B = dout BK rows x BN of F; the steps are the
// BK-row slices of the expert's tiles in id-stream order.
template <typename P, int BM, int BN, int BK, int STAGES>
__global__ void __launch_bounds__(kThreads)
moe_gmm_bwd_dw_kernel(const BwdArgs a) {
  using T = typename P::T;
  using L = Smem<T, BK, BM, BK, BN, STAGES>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sa = reinterpret_cast<T*>(smem);
  T* sb = sa + STAGES * L::kAElems;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int e = blockIdx.z;
  const int tiles = (a.t + a.bm - 1) / a.bm;
  const int subs = (a.bm + BK - 1) / BK;  // steps a tile
  const T* tok = static_cast<const T*>(a.tokens);
  const T* dout = static_cast<const T*>(a.dout);
  const int cols_m = min(BM, a.d - m0), cols_n = min(BN, a.f - n0);

  P p;
  p.init();
  // the next step to stage: tile lt (tiles when none is left), its slice ls
  int lt = next_tile(a.tile_eid, 0, tiles, e), ls = 0, issued = 0;
  auto issue = [&]() {
    if (lt < tiles) {
      const int64_t r0 = static_cast<int64_t>(lt) * a.bm + ls * BK;
      // the rows of this slice inside its tile and inside T (none or BK)
      const int64_t left = (lt + 1 < tiles ? static_cast<int64_t>(lt + 1) * a.bm : a.t) - r0;
      const int rows = left <= 0 ? 0 : left < BK ? static_cast<int>(left) : BK;
      const int buf = issued % STAGES;
      load_tile<T, BK, BM, L::kAStride>(sa + buf * L::kAElems, tok + r0 * a.d + m0, tok, a.d,
                                        rows, cols_m, a.vec);
      load_tile<T, BK, BN, L::kBStride>(sb + buf * L::kBElems, dout + r0 * a.f + n0, dout, a.f,
                                        rows, cols_n, a.vec);
      ++issued;
      if (++ls == subs) {
        ls = 0;
        lt = next_tile(a.tile_eid, lt + 1, tiles, e);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue();
  for (int kt = 0; kt < issued; ++kt) {
    cp_async_wait<STAGES - 2>();  // step kt has landed
    __syncthreads();              // and every warp is done with step kt - 1
    issue();                      // into the buffer of step kt - 1
    const int buf = kt % STAGES;
    p.template compute<L::kAStride, L::kBStride>(sa + buf * L::kAElems, sb + buf * L::kBElems);
  }
  cp_async_wait<0>();
  p.store(static_cast<T*>(a.dw) + static_cast<int64_t>(e) * a.d * a.f, m0, n0, a.d, a.f);
}

template <typename K>
int set_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <typename P, int BM, int BN, int BK, int STAGES>
int launch_dx(const BwdArgs& a, cudaStream_t s) {
  using L = Smem<typename P::T, BM, BK, BN, BK, STAGES>;
  auto kernel = moe_gmm_bwd_dx_kernel<P, BM, BN, BK, STAGES>;
  const int err = set_smem(kernel, L::kBytes);
  if (err != 0) return err;
  const int64_t m_blocks = (static_cast<int64_t>(a.t) + BM - 1) / BM;
  if (m_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((a.d + BN - 1) / BN), static_cast<unsigned>(m_blocks));
  kernel<<<grid, kThreads, L::kBytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename P, int BM, int BN, int BK, int STAGES>
int launch_dw(const BwdArgs& a, cudaStream_t s) {
  using L = Smem<typename P::T, BK, BM, BK, BN, STAGES>;
  auto kernel = moe_gmm_bwd_dw_kernel<P, BM, BN, BK, STAGES>;
  const int err = set_smem(kernel, L::kBytes);
  if (err != 0) return err;
  const int64_t m_blocks = (static_cast<int64_t>(a.d) + BM - 1) / BM;
  if (m_blocks > 65535 || a.e > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((a.f + BN - 1) / BN), static_cast<unsigned>(m_blocks),
                  static_cast<unsigned>(a.e));
  kernel<<<grid, kThreads, L::kBytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---- the bf16 route: TMA + wgmma ------------------------------------------

namespace wg {

using namespace hopper;

constexpr int kBK = 64;                          // k of a stage: 128 bytes of bf16
constexpr int kConsumers = 2;                    // warpgroups
constexpr int kThreads = 128 * kConsumers + 32;  // + one producer warp
constexpr int kBox = 64 * 64 * 2;                // one 64 x 64 bf16 box, 8 KB
constexpr int kGroupM = 8;                       // row tiles of a raster group
constexpr int kMaxTiles = 1024;                  // the id stream a dweights block lists
constexpr int kMaxExperts = 64;

struct Args {
  const int* tile_eid;
  int t, d, f, e, bm;
};

// dtokens.  kMW: consumer warpgroups along M.  2: a 128 x 256 block (bm a
// multiple of 128), each warpgroup 64 rows x 256 columns of D, a 4-stage
// ring, one block an SM; 1: a 64 x 256 block (bm 64), each warpgroup 64 x
// 128, a 2-stage ring, two blocks an SM.
template <int kMW>
struct DxTile {
  static constexpr int kBM = 64 * kMW;
  static constexpr int kBN = 256;
  static constexpr int kNC = kBN * kMW / kConsumers;  // columns of a warpgroup
  static constexpr int kStages = kMW == 2 ? 4 : 2;
  static constexpr int kPerSm = kMW == 2 ? 1 : 2;
  static constexpr int kABytes = kBM * kBK * 2;       // dout, K-major
  static constexpr int kBBytes = kBN * kBK * 2;       // W[e]: 256 rows of D, K-major
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSmem = kStages * kStageBytes + 1024;  // + 1 KB alignment
};

template <int kMW>
__global__ void __launch_bounds__(kThreads, DxTile<kMW>::kPerSm)
moe_gmm_bwd_dx_kernel_wgmma(const __grid_constant__ CUtensorMap map_dout,
                            const __grid_constant__ CUtensorMap map_w,
                            const __grid_constant__ CUtensorMap map_dtok, const Args p) {
  using G = DxTile<kMW>;
  constexpr int kStages = G::kStages;
  constexpr int kNC = G::kNC;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];   // the stage's loads landed
  __shared__ __align__(8) uint64_t empty[kStages];  // both consumers are done with it
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int w = threadIdx.x / 128;  // consumer warpgroup, or kConsumers: the producer
  const int tiles_m = (p.t + G::kBM - 1) / G::kBM;
  const int tiles_n = (p.d + G::kBN - 1) / G::kBN;
  const int per_group = kGroupM * tiles_n;
  const int first_m = static_cast<int>(blockIdx.x) / per_group * kGroupM;
  const int rows = min(tiles_m - first_m, kGroupM);
  const int in_group = static_cast<int>(blockIdx.x) % per_group;
  const int m0 = (first_m + in_group % rows) * G::kBM;
  const int n0 = in_group / rows * G::kBN;
  const int eid = __ldg(p.tile_eid + m0 / p.bm);
  const int k_tiles = eid >= 0 && eid < p.e ? (p.f + kBK - 1) / kBK : 0;

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
        mbar_expect_tx(&full[s], G::kStageBytes);
        tma_load(sa, &map_dout, &full[s], kt * kBK, m0);
        tma_load_3d(sa + G::kABytes, &map_w, &full[s], kt * kBK, n0, eid);
      }
    }
    return;
  }

  // a consumer: rows mw*64 .. + 63, columns nw*kNC .. + kNC - 1 of the block
  const int mw = w % kMW, nw = w / kMW;
  float acc[kNC / 2];
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % kStages;
    mbar_wait(&full[s], (kt / kStages) & 1);
    const uint32_t sa = smem_u32(ring + s * G::kStageBytes) + mw * 64 * 128;
    const uint32_t sb = smem_u32(ring + s * G::kStageBytes + G::kABytes) + nw * kNC * 128;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_bf16_kk(acc, desc_sw128(sa + kk * 32, 16, 1024), desc_sw128(sb + kk * 32, 16, 1024),
                    kt > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // the products of stage kt-1 are done: free it
    if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(kt - 1) % kStages]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (k_tiles == 0) {  // a tile outside [0, E): zeros
#pragma unroll
    for (int i = 0; i < kNC / 2; ++i) acc[i] = 0.f;
  }

  // both consumers are past their last wgmma: the ring is free for the
  // results, 64 x 64 boxes in the 128-byte swizzle, stored by TMA (which
  // drops what lies past T or D)
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
      tma_store(&map_dtok, tile + box * kBox, n0 + nw * kNC + box * 64, m0 + mw * 64);
    tma_store_wait();
  }
}

// dweights: an item is kDwBM rows of D by kDwBN columns of F of one expert.
constexpr int kDwBM = 128;                             // two warpgroups of 64 rows
constexpr int kDwBN = 256;
constexpr int kDwStages = 3;
constexpr int kDwABytes = kBK * kDwBM * 2;             // tokens: 2 boxes
constexpr int kDwBBytes = kBK * kDwBN * 2;             // dout: 4 boxes
constexpr int kDwStageBytes = kDwABytes + kDwBBytes;   // 48 KB
constexpr int kDwOutBytes = kDwBM * kDwBN * 2;         // the staged item, 64 KB
constexpr int kDwSmem = kDwStages * kDwStageBytes + kDwOutBytes + 1024;

// Each expert's tiles in id-stream order: order[start[x] .. start[x + 1])
// are the tiles of expert x; ids outside [0, E) are in no list.  By the
// whole block, which it leaves synchronised.
__device__ void build_lists(const int* tile_eid, int tiles, int e, int* order, int* start) {
  for (int i = threadIdx.x; i < tiles; i += blockDim.x) {
    const int id = __ldg(tile_eid + i);
    if (id < 0 || id >= e) continue;
    int pos = 0;
    for (int j = 0; j < tiles; ++j) {
      const int other = __ldg(tile_eid + j);
      pos += (other >= 0 && other < id) || (other == id && j < i);
    }
    order[pos] = i;
  }
  for (int x = threadIdx.x; x <= e; x += blockDim.x) {
    int before = 0;
    for (int j = 0; j < tiles; ++j) {
      const int other = __ldg(tile_eid + j);
      before += other >= 0 && other < x;
    }
    start[x] = before;
  }
  __syncthreads();
}

// Item w of E x n_d x n_f, expert-major, F fastest: (expert, d0, f0).
struct Item {
  int e, d0, f0;
};

__device__ __forceinline__ Item item_at(int64_t w, int n_d, int n_f) {
  const int64_t per_e = static_cast<int64_t>(n_d) * n_f;
  const int rem = static_cast<int>(w % per_e);
  return Item{static_cast<int>(w / per_e), rem / n_f * kDwBM, rem % n_f * kDwBN};
}

__global__ void __launch_bounds__(kThreads, 1)
moe_gmm_bwd_dw_kernel_wgmma(const __grid_constant__ CUtensorMap map_tok,
                            const __grid_constant__ CUtensorMap map_dout,
                            const __grid_constant__ CUtensorMap map_dw, const Args p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kDwStages];   // the stage's loads landed
  __shared__ __align__(8) uint64_t empty[kDwStages];  // both consumers are done with it
  __shared__ int order[kMaxTiles], start[kMaxExperts + 1];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* staged = ring + kDwStages * kDwStageBytes;
  const int tiles = (p.t + p.bm - 1) / p.bm;
  build_lists(p.tile_eid, tiles, p.e, order, start);
  const int n_d = (p.d + kDwBM - 1) / kDwBM;
  const int n_f = (p.f + kDwBN - 1) / kDwBN;
  const int64_t items = static_cast<int64_t>(p.e) * n_d * n_f;
  const int subs = p.bm / kBK;  // K steps a tile
  const int w = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kDwStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (w == kConsumers) {  // the producer warp: one thread, across items
    if (threadIdx.x == 128 * kConsumers) {
      int it = 0;
      for (int64_t wi = blockIdx.x; wi < items; wi += gridDim.x) {
        const Item item = item_at(wi, n_d, n_f);
        for (int i = start[item.e]; i < start[item.e + 1]; ++i)
          for (int sub = 0; sub < subs; ++sub, ++it) {
            const int s = it % kDwStages;
            const int row0 = order[i] * p.bm + sub * kBK;
            mbar_wait(&empty[s], ((it / kDwStages) & 1) ^ 1);  // the first round passes
            uint8_t* sa = ring + s * kDwStageBytes;
            uint8_t* sb = sa + kDwABytes;
            mbar_expect_tx(&full[s], kDwStageBytes);
#pragma unroll
            for (int box = 0; box < kDwBM / 64; ++box)
              tma_load(sa + box * kBox, &map_tok, &full[s], item.d0 + box * 64, row0);
#pragma unroll
            for (int box = 0; box < kDwBN / 64; ++box)
              tma_load(sb + box * kBox, &map_dout, &full[s], item.f0 + box * 64, row0);
          }
      }
    }
    return;
  }

  // a consumer: rows d0 + w*64 .. + 63 of each item, all its 256 columns
  const int t = threadIdx.x % 128;
  const int r0 = (t / 32) * 16 + (t % 32) / 4;
  uint8_t* mine = staged + w * (kDwBN / 64) * kBox;
  int it = 0;
  for (int64_t wi = blockIdx.x; wi < items; wi += gridDim.x) {
    const Item item = item_at(wi, n_d, n_f);
    const int k_steps = (start[item.e + 1] - start[item.e]) * subs;
    float acc[kDwBN / 2];
    for (int kt = 0; kt < k_steps; ++kt, ++it) {
      const int s = it % kDwStages;
      mbar_wait(&full[s], (it / kDwStages) & 1);
      const uint32_t sa = smem_u32(ring + s * kDwStageBytes) + w * kBox;
      const uint32_t sb = smem_u32(ring + s * kDwStageBytes + kDwABytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_bf16_tt(acc, desc_sw128(sa + kk * 16 * 128, kBox, 1024),
                      desc_sw128(sb + kk * 16 * 128, kBox, 1024), kt > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the products of the step before are done: free it
      if (kt > 0 && t == 0) mbar_arrive(&empty[(it - 1) % kDwStages]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (k_steps > 0 && t == 0) mbar_arrive(&empty[(it - 1) % kDwStages]);
    if (k_steps == 0) {  // an expert with no tile: zeros
#pragma unroll
      for (int i = 0; i < kDwBN / 2; ++i) acc[i] = 0.f;
    }
    // the staged half is free once this warpgroup's last store has read it
    if (t == 0) tma_store_wait_read();
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + w) : "memory");
#pragma unroll
    for (int j = 0; j < kDwBN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(mine + sw128_at(r0 + 8 * h, j * 8 + (t % 4) * 2,
                                                           kBox)) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    fence_async_smem();
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + w) : "memory");
    if (t == 0) {
#pragma unroll
      for (int box = 0; box < kDwBN / 64; ++box)
        tma_store_3d(&map_dw, mine + box * kBox, item.f0 + box * 64, item.d0 + w * 64, item.e);
      tma_store_commit();  // drains while the next item's products run
    }
  }
  if (t == 0) tma_store_wait_read();
}

template <int kMW>
int launch_dx(const EncodeTiled fn, const void* weights, const void* dout, void* dtok,
              const Args& a, cudaStream_t stream) {
  using G = DxTile<kMW>;
  CUtensorMap map_dout, map_w, map_dtok;
  if (!encode(fn, &map_dout, dout, a.t, a.f, G::kBM, kBK) ||
      !encode_3d(fn, &map_w, weights, a.e, a.d, a.f, G::kBN, kBK) ||
      !encode(fn, &map_dtok, dtok, a.t, a.d, 64, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  // per call: the attribute and the SM count belong to the current device
  const int err = set_smem(moe_gmm_bwd_dx_kernel_wgmma<kMW>, G::kSmem);
  if (err != 0) return err;
  const int64_t blocks = static_cast<int64_t>((a.t + G::kBM - 1) / G::kBM) *
                         ((a.d + G::kBN - 1) / G::kBN);
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  moe_gmm_bwd_dx_kernel_wgmma<kMW><<<static_cast<unsigned>(blocks), kThreads, G::kSmem, stream>>>(
      map_dout, map_w, map_dtok, a);
  return static_cast<int>(cudaGetLastError());
}

int launch_dw(const EncodeTiled fn, const void* tokens, const void* dout, void* dw, const Args& a,
              cudaStream_t stream) {
  CUtensorMap map_tok, map_dout, map_dw;
  if (!encode(fn, &map_tok, tokens, a.t, a.d, kBK, 64) ||
      !encode(fn, &map_dout, dout, a.t, a.f, kBK, 64) ||
      !encode_3d(fn, &map_dw, dw, a.e, a.d, a.f, 64, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = set_smem(moe_gmm_bwd_dw_kernel_wgmma, kDwSmem);
  if (err != 0) return err;
  int dev = 0, sms = 0;
  err = static_cast<int>(cudaGetDevice(&dev));
  if (err == 0)
    err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (err != 0) return err;
  const int64_t items = static_cast<int64_t>(a.e) * ((a.d + kDwBM - 1) / kDwBM) *
                        ((a.f + kDwBN - 1) / kDwBN);
  const int grid = static_cast<int>(items < sms ? items : sms);
  moe_gmm_bwd_dw_kernel_wgmma<<<grid, kThreads, kDwSmem, stream>>>(map_tok, map_dout, map_dw, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// tokens (T,D), weights (E,D,F), dout (T,F), dtok (T,D), dw (E,D,F), all
// contiguous and of one dtype (0 = f32, 1 = bf16); tile_eid (ceil(T/bm),)
// int32 on the device; bm a multiple of 16.  dtokens' block height is the
// largest of 128, 64, 16 that divides bm.  Launches the dtokens kernel, then
// the dweights kernel, on `stream` without synchronising; returns a
// cudaError_t (0 on success).
extern "C" int repro_moe_gmm_bwd(const void* tokens, const void* weights, const int* tile_eid,
                                 const void* dout, void* dtok, void* dw, int t, int d, int f,
                                 int e, int bm, int dtype, void* stream) {
  if (t <= 0 || d <= 0 || f <= 0 || e <= 0 || bm <= 0 || bm % 16 != 0 || tokens == nullptr ||
      weights == nullptr || tile_eid == nullptr || dout == nullptr || dtok == nullptr ||
      dw == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{tokens, weights, tile_eid, dout, dtok, dw, t, d, f, e, bm, false};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 1) {
    a.vec = d % 8 == 0 && f % 8 == 0 && aligned(tokens) && aligned(weights) && aligned(dout);
    if (bm % 128 == 0)
      err = launch_dx<MmaBf16<128, 128, 32, 2, 2, false, true>, 128, 128, 32, 3>(a, s);
    else if (bm % 64 == 0)
      err = launch_dx<MmaBf16<64, 128, 32, 2, 2, false, true>, 64, 128, 32, 3>(a, s);
    else
      err = launch_dx<MmaBf16<16, 64, 64, 1, 4, false, true>, 16, 64, 64, 4>(a, s);
    if (err != 0) return err;
    return launch_dw<MmaBf16<128, 128, 32, 2, 2, true, false>, 128, 128, 32, 3>(a, s);
  }
  if (dtype == 0) {
    a.vec = d % 4 == 0 && f % 4 == 0 && aligned(tokens) && aligned(weights) && aligned(dout);
    if (bm % 128 == 0)
      err = launch_dx<SimtF32<128, 64, 32, false, true>, 128, 64, 32, 3>(a, s);
    else if (bm % 64 == 0)
      err = launch_dx<SimtF32<64, 64, 32, false, true>, 64, 64, 32, 3>(a, s);
    else
      err = launch_dx<SimtF32<16, 64, 32, false, true>, 16, 64, 32, 3>(a, s);
    if (err != 0) return err;
    return launch_dw<SimtF32<64, 64, 32, true, false>, 64, 64, 32, 3>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 "wgmma" route: tokens (T,D), weights (E,D,F), dout (T,F), dtok
// (T,D), dw (E,D,F), all bf16 and contiguous, with D and F positive
// multiples of 8, every pointer 16-byte aligned, bm a multiple of 64, at
// most 1,024 tiles and 64 experts (kernels/moe_gmm.route_bwd); tile_eid
// (ceil(T/bm),) int32 on the device.  Launches the dtokens kernel, then the
// persistent dweights kernel (one block an SM), on `stream` without
// synchronising.  Returns a cudaError_t: cudaErrorInvalidValue for
// arguments off that rule or a tensor map cuTensorMapEncodeTiled refuses,
// cudaErrorNotSupported when libcuda has no cuTensorMapEncodeTiled.
extern "C" int repro_moe_gmm_bwd_wgmma(const void* tokens, const void* weights,
                                       const int* tile_eid, const void* dout, void* dtok,
                                       void* dw, int t, int d, int f, int e, int bm,
                                       void* stream) {
  if (t <= 0 || d <= 0 || f <= 0 || e <= 0 || e > wg::kMaxExperts || bm <= 0 || bm % 64 != 0 ||
      d % 8 != 0 || f % 8 != 0 || (t + bm - 1) / bm > wg::kMaxTiles || tile_eid == nullptr ||
      !aligned(tokens) || !aligned(weights) || !aligned(dout) || !aligned(dtok) ||
      !aligned(dw) || tokens == nullptr || weights == nullptr || dout == nullptr ||
      dtok == nullptr || dw == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const hopper::EncodeTiled fn = hopper::encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const wg::Args a{tile_eid, t, d, f, e, bm};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = bm % 128 ? wg::launch_dx<1>(fn, weights, dout, dtok, a, s)
                           : wg::launch_dx<2>(fn, weights, dout, dtok, a, s);
  if (err != 0) return err;
  return wg::launch_dw(fn, tokens, dout, dw, a, s);
}
