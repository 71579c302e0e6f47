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
// through the plain C function at the bottom (ctypes; see
// repro_torch/kernels/_build.py).
//
// What bounds it: in decode a tile holds a few routed rows, so the weights
// of the experts that have rows, each read once, bound it (bytes: a Jamba
// expert is 3 x 8192 x 24576 bf16 = 1.2 GB); in prefill each expert has
// hundreds of rows and the bf16 products bound it (tensor cores).
//
// Design: a tiled GEMM whose B operand is picked per block by the id
// stream, the way K4 reads its streams from device memory.
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

namespace {

constexpr int kThreads = 128;  // four warps

struct GmmArgs {
  const void* tokens;   // (T, D)
  const void* weights;  // (E, D, F)
  const int* tile_eid;  // (ceil(T / bm),)
  void* out;            // (T, F)
  int t, d, f, e, bm;
  bool vec;  // D, F multiples of the 16-byte vector and pointers aligned
};

template <typename T, int BM, int BN, int BK, int STAGES>
struct Layout {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kAStride = BK + kVec;  // padded shared rows
  static constexpr int kBStride = BN + kVec;
  static constexpr int kAElems = BM * kAStride;
  static constexpr int kBElems = BK * kBStride;
  static constexpr int kSmemBytes = STAGES * (kAElems + kBElems) * static_cast<int>(sizeof(T));
  static_assert(BK % kVec == 0 && BN % kVec == 0, "whole 16-byte chunks");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; bytes past src_bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float zero_of(float) { return 0.f; }
__device__ __forceinline__ __nv_bfloat16 zero_of(__nv_bfloat16) { return __float2bfloat16(0.f); }
__device__ __forceinline__ void store_bf16(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// One 16-byte chunk of a row: `valid` of its elements lie in bounds (the
// rest read as zero).  `src` must be a readable address even when valid is 0.
template <typename T>
__device__ __forceinline__ void load_chunk(T* dst, const T* src, int valid, bool vec) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  if (vec) {
    cp_async16(dst, src, valid * static_cast<int>(sizeof(T)));
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) dst[j] = j < valid ? src[j] : zero_of(T());
  }
}

// Stage the (BM x BK) token slice at (m0, k0) and the (BK x BN) weight slice
// at (k0, n0) of expert weight `w`.
template <typename T, int BM, int BN, int BK, int STAGES>
__device__ __forceinline__ void load_stage(const GmmArgs& a, const T* w, T* sa, T* sb,
                                           int64_t m0, int n0, int k0) {
  using L = Layout<T, BM, BN, BK, STAGES>;
  constexpr int kVec = L::kVec;
  const T* x = static_cast<const T*>(a.tokens);
  constexpr int kAChunks = BM * BK / kVec;
  for (int c = threadIdx.x; c < kAChunks; c += kThreads) {
    const int r = c / (BK / kVec), kc = (c % (BK / kVec)) * kVec;
    const int64_t row = m0 + r;
    const int col = k0 + kc;
    const int valid = row < a.t ? max(0, min(kVec, a.d - col)) : 0;
    load_chunk<T>(sa + r * L::kAStride + kc, valid > 0 ? x + row * a.d + col : x, valid, a.vec);
  }
  constexpr int kBChunks = BK * BN / kVec;
  for (int c = threadIdx.x; c < kBChunks; c += kThreads) {
    const int r = c / (BN / kVec), nc = (c % (BN / kVec)) * kVec;
    const int krow = k0 + r;
    const int col = n0 + nc;
    const int valid = krow < a.d ? max(0, min(kVec, a.f - col)) : 0;
    load_chunk<T>(sb + r * L::kBStride + nc,
                  valid > 0 ? w + static_cast<int64_t>(krow) * a.f + col : w, valid, a.vec);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16 on the tensor cores: WM x WN warps, each a (BM/WM) x (BN/WN) tile of
// m16n8 f32 accumulators.
template <int BM, int BN, int BK, int WM, int WN>
struct MmaBf16 {
  using T = __nv_bfloat16;
  static constexpr int kWarpM = BM / WM, kWarpN = BN / WN;
  static constexpr int MT = kWarpM / 16, NT = kWarpN / 8;
  static_assert(WM * WN * 32 == kThreads, "one warp per sub-tile");
  static_assert(kWarpM % 16 == 0 && NT % 2 == 0 && BK % 16 == 0, "mma shapes");
  float acc[MT][NT][4];
  int wm0, wn0, lane;

  __device__ __forceinline__ void init() {
    const int warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
    wm0 = (warp / WN) * kWarpM;
    wn0 = (warp % WN) * kWarpN;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  }

  template <int AS, int BS>
  __device__ __forceinline__ void compute(const T* sa, const T* sb) {
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(af[i], sa + (wm0 + i * 16 + (lane & 15)) * AS + kk + (lane >> 4) * 8);
      uint32_t bf[NT][2];
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, sb + (kk + (lane & 15)) * BS + wn0 + jp * 16 + (lane >> 4) * 8);
        bf[2 * jp][0] = r[0];
        bf[2 * jp][1] = r[1];
        bf[2 * jp + 1][0] = r[2];
        bf[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }

  __device__ __forceinline__ void store(T* out, int64_t m0, int n0, int t, int f) const {
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + wn0 + j * 8 + tq * 2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t row = m0 + wm0 + i * 16 + g + h * 8;
          if (row >= t) continue;
          if (col < f) store_bf16(out + row * f + col, acc[i][j][2 * h]);
          if (col + 1 < f) store_bf16(out + row * f + col + 1, acc[i][j][2 * h + 1]);
        }
      }
  }
};

// f32 on the SIMT cores: 16 x 8 threads, each BM/8 rows (8 apart) x 4
// neighbouring columns of a BM x 64 tile.
template <int BM, int BN, int BK>
struct SimtF32 {
  using T = float;
  static constexpr int TM = BM / 8;
  static_assert(BN == 64 && BM % 8 == 0, "16 x 8 threads over a BM x 64 tile");
  float acc[TM][4];
  int tx, ty;

  __device__ __forceinline__ void init() {
    tx = threadIdx.x % 16;
    ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  template <int AS, int BS>
  __device__ __forceinline__ void compute(const T* sa, const T* sb) {
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float4 b = *reinterpret_cast<const float4*>(sb + k * BS + tx * 4);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float av = sa[(ty + 8 * i) * AS + k];
        acc[i][0] = fmaf(av, b.x, acc[i][0]);
        acc[i][1] = fmaf(av, b.y, acc[i][1]);
        acc[i][2] = fmaf(av, b.z, acc[i][2]);
        acc[i][3] = fmaf(av, b.w, acc[i][3]);
      }
    }
  }

  __device__ __forceinline__ void store(T* out, int64_t m0, int n0, int t, int f) const {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t row = m0 + ty + 8 * i;
      if (row >= t) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx * 4 + j;
        if (col < f) out[row * f + col] = acc[i][j];
      }
    }
  }
};

// grid (ceil(F / BN), ceil(T / BM)); dynamic shared memory Layout::kSmemBytes.
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
  if (L::kSmemBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t m_blocks = (static_cast<int64_t>(a.t) + BM - 1) / BM;
  if (m_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((a.f + BN - 1) / BN), static_cast<unsigned>(m_blocks));
  kernel<<<grid, kThreads, L::kSmemBytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

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
