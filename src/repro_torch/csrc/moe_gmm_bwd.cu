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
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
