// K6 on Hopper: matmul with the fused bias / residual / activation epilogue.
//
// Replaces the Pallas kernel repro/kernels/matmul_fused.py:matmul_fused
// (_kernel).  Same function: out = act(a @ b + bias [+ residual]) with
// a (M,K), b (K,N), bias (N,), residual (M,N), all row-major and of one
// dtype (f32 or bf16), f32 accumulation, act in {none, relu, gelu (tanh
// form), silu}, out in a's dtype.  Built with nvcc for sm_90a and bound
// through the plain C functions at the bottom (ctypes; see
// repro_torch/kernels/_build.py).
//
// What bounds it on an H100: at the LM's projection shapes (M = 4096
// tokens, K and N of 256 to 8960) a matmul does hundreds of FLOP per byte
// it must move, so the bound is the arithmetic rate: 989 TFLOP/s on the
// bf16 tensor cores, 67 TFLOP/s f32 on the SIMT cores.  Two kernels, one
// route each, chosen by shape in the wrapper (kernels/matmul_fused.route):
//
// matmul_fused_kernel_wgmma, bf16 with K and N multiples of 8 and a, b, out
// 16-byte aligned (TMA needs 16-byte row strides and bases):
//   * a block owns a 128 x BN output tile (BN 128 by default, or 256 by a
//     tuned plan); one thread of its producer warp starts TMA loads
//     (cp.async.bulk.tensor) of the a tile (128 x 64, K-major) and of the
//     b tile (64 x BN, as BN / 64 boxes of 64 columns: b stays row-major
//     (K, N) and is read MN-major through the transpose bit of wgmma) into
//     a ring of shared-memory stages (3 by default; 2 or 4 by a plan) with
//     128-byte swizzle, each stage completing on an mbarrier;
//   * two consumer warpgroups each run wgmma.mma_async m64nBNk16 bf16 ->
//     f32 on 64 rows of the tile, keep one group of products in flight, and
//     free a stage (a second mbarrier) once the products that read it are
//     done;
//   * at the default plan two blocks share an SM (97 KB of shared memory
//     and 94 registers a thread each), so one block's epilogue and the fill
//     of its ring overlap the other's products; blocks are numbered down groups of 8 row tiles,
//     so the blocks in flight share their a and b tiles in L2;
//   * TMA zero-fills the M, N and K tails of every box, so the mainloop
//     has no bounds tests;
//   * the epilogue runs on the register tile in the reference's order
//     (matmul_fused.py:48-56): + bias, + residual, act, for every act (exp
//     and tanh approximate: their error lies below bf16's rounding); the
//     bf16 results go into the then free ring in the 128-byte swizzle and
//     leave by TMA stores, which drop what lies past M or N.
//   The tensor maps are encoded on the host in the C entry point, through
//   cuTensorMapEncodeTiled got from cudaGetDriverEntryPoint (no -lcuda), and
//   passed as __grid_constant__ kernel parameters.  These helpers, shared
//   with K7's and K9's wgmma routes, live in hopper.cuh.
//
// matmul_fused_kernel, f32 (held to 1e-5, which TF32 would not keep) and
// bf16 off that rule: a register-tiled GEMM on the SIMT cores, the tiling
// of csrc/conv2d_direct.cu without the im2col gather.
//   * A block of 256 threads owns a BM x BN output tile and walks K in
//     steps of 8: the a slice (BM x 8, stored transposed) and the b slice
//     (8 x BN) are staged in shared memory as f32, double buffered through
//     registers so the next step's loads overlap this step's FMAs.
//   * Each thread keeps a TM x TN tile of outputs in registers (8x8 on the
//     128x128 tile, 4x4 on the 64x64 tile chosen when 128x128 tiles would
//     not give every SM a block), in float4 groups 64 rows / columns apart.
//   * The epilogue runs on the register tile before the single store, in
//     the same order.
//   * Every M, N, K tail is masked on load and store; float4 / 8-byte loads
//     are used where the row length and the base pointers allow.
// Offsets are 64-bit.
#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums only: no libcuda call is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"  // TMA, mbarriers, wgmma, the tensor-map encoder

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 8;  // k-steps per staged slice

enum Act { kNone = 0, kRelu = 1, kGelu = 2, kSilu = 3 };

struct MmArgs {
  const void* a;
  const void* b;
  const void* bias;      // may be null
  const void* residual;  // may be null
  void* out;
  int m, n, k, act;
  bool vec_a;  // K % 4 == 0 and a aligned: whole quads of a row load at once
  bool vec_n;  // N % 4 == 0 and b, bias, residual, out aligned
};

// Elements of a quad at `at` that lie before `total` (may be <= 0).
__device__ __forceinline__ int in_bounds(int64_t total, int64_t at) {
  const int64_t r = total - at;
  return r < 4 ? static_cast<int>(r) : 4;
}


// p[0..3], of which the first n are in bounds (the rest read as 0).
__device__ __forceinline__ void load4(const float* p, int n, bool vec, float v[4]) {
  if (vec && n >= 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = c < n ? p[c] : 0.f;
  }
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, int n, bool vec, float v[4]) {
  if (vec && n >= 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = c < n ? __bfloat162float(p[c]) : 0.f;
  }
}

__device__ __forceinline__ void store4(float* p, int n, bool vec, const float v[4]) {
  if (vec && n >= 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < n) p[c] = v[c];
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, int n, bool vec, const float v[4]) {
  if (vec && n >= 4) {
    uint2 u;
    *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(v[0], v[1]);
    *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < n) p[c] = __float2bfloat16_rn(v[c]);
  }
}

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case kRelu:
      return fmaxf(x, 0.f);
    case kGelu:  // jax.nn.gelu(approximate=True)
      return 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
    case kSilu:
      return x / (1.f + expf(-x));
    default:
      return x;
  }
}

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
matmul_fused_kernel(const MmArgs p) {
  constexpr int TM = BM / 16, TN = BN / 16;  // 16 x 16 threads
  static_assert(TM % 4 == 0 && TN % 4 == 0, "register tiles are float4 groups");
  constexpr int kAQuads = BM * kBK / 4;  // quads of a staged per step
  constexpr int kBQuads = BN * kBK / 4;
  static_assert(kAQuads <= kThreads && kBQuads <= kThreads, "one quad per thread");
  __shared__ __align__(16) float as[2][kBK][BM + 4];  // a slice, transposed
  __shared__ __align__(16) float bs[2][kBK][BN];

  const T* a = static_cast<const T*>(p.a);
  const T* b = static_cast<const T*>(p.b);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BN;

  // the quad this thread stages: a row am, k-offset akq; b row bk, column bnq
  const int am = tid / 2, akq = (tid % 2) * 4;
  const int bkr = tid / (BN / 4), bnq = (tid % (BN / 4)) * 4;
  float ra[4], rb[4];
  auto gload = [&](int k0) {
    if (tid < kAQuads) {
      const int64_t row = m0 + am;
      const int kk = k0 + akq;
      const int n = row < p.m ? in_bounds(p.k, kk) : 0;
      load4(a + row * p.k + kk, n, p.vec_a, ra);
    }
    if (tid < kBQuads) {
      const int kk = k0 + bkr;
      const int64_t col = n0 + bnq;
      const int n = kk < p.k ? in_bounds(p.n, col) : 0;
      load4(b + static_cast<int64_t>(kk) * p.n + col, n, p.vec_n, rb);
    }
  };
  auto sstore = [&](int buf) {
    if (tid < kAQuads) {
#pragma unroll
      for (int c = 0; c < 4; ++c) as[buf][akq + c][am] = ra[c];
    }
    if (tid < kBQuads)
      *reinterpret_cast<float4*>(&bs[buf][bkr][bnq]) = make_float4(rb[0], rb[1], rb[2], rb[3]);
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int nk = (p.k + kBK - 1) / kBK;
  if (nk > 0) {
    gload(0);
    sstore(0);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) gload((kt + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float va[TM], vb[TN];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 f = *reinterpret_cast<const float4*>(&as[buf][kk][g * 64 + ty * 4]);
        va[g * 4] = f.x; va[g * 4 + 1] = f.y; va[g * 4 + 2] = f.z; va[g * 4 + 3] = f.w;
      }
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 f = *reinterpret_cast<const float4*>(&bs[buf][kk][g * 64 + tx * 4]);
        vb[g * 4] = f.x; vb[g * 4 + 1] = f.y; vb[g * 4 + 2] = f.z; vb[g * 4 + 3] = f.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(va[i], vb[j], acc[i][j]);
    }
    if (kt + 1 < nk) sstore(buf ^ 1);
    __syncthreads();
  }

  const T* bias = static_cast<const T*>(p.bias);
  const T* res = static_cast<const T*>(p.residual);
  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t row = m0 + (i / 4) * 64 + ty * 4 + (i % 4);
    if (row >= p.m) continue;
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const int64_t col = n0 + g * 64 + tx * 4;
      const int n = in_bounds(p.n, col);
      if (n <= 0) continue;
      float v[4], e[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = acc[i][g * 4 + c];
      if (bias != nullptr) {
        load4(bias + col, n, p.vec_n, e);
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = __fadd_rn(v[c], e[c]);
      }
      if (res != nullptr) {
        load4(res + row * p.n + col, n, p.vec_n, e);
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = __fadd_rn(v[c], e[c]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = activate(v[c], p.act);
      store4(out + row * p.n + col, n, p.vec_n, v);
    }
  }
}

template <typename T, int BM, int BN>
int launch_tile(const MmArgs& p, cudaStream_t stream) {
  const dim3 grid((p.n + BN - 1) / BN, (p.m + BM - 1) / BM);
  matmul_fused_kernel<T, BM, BN><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// bm x bn: a plan's tile (64 or 128 each), or 0 x 0 for the default rule:
// 128 x 128 where those tiles give every SM a block, else 64 x 64.
template <typename T>
int launch(const MmArgs& p, int bm, int bn, cudaStream_t stream) {
  if (bm == 0 && bn == 0) {
    static int sms = 0;
    if (sms == 0) {
      int dev = 0;
      if (cudaGetDevice(&dev) != cudaSuccess ||
          cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        sms = 132;
    }
    const int64_t big = ((p.m + 127) / 128) * static_cast<int64_t>((p.n + 127) / 128);
    bm = bn = big >= sms ? 128 : 64;
  }
  if (bm == 128 && bn == 128) return launch_tile<T, 128, 128>(p, stream);
  if (bm == 128 && bn == 64) return launch_tile<T, 128, 64>(p, stream);
  if (bm == 64 && bn == 128) return launch_tile<T, 64, 128>(p, stream);
  if (bm == 64 && bn == 64) return launch_tile<T, 64, 64>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---- the bf16 route: TMA + wgmma ----------------------------------------

namespace wg {

constexpr int kBM = 128;                      // output rows of a block
constexpr int kBK = 64;                       // k of a stage: 128 bytes of bf16
constexpr int kConsumers = 2;                 // warpgroups of 64 rows each
constexpr int kThreads = 128 * kConsumers + 32;  // + one producer warp
constexpr int kABytes = kBM * kBK * 2;        // a tile, K-major, 128 B rows
constexpr int kBBox = kBK * 64 * 2;           // one 64-column box of b
constexpr int kGroupM = 8;                    // row tiles of a raster group

// The plan's coordinates: kBN output columns of a block (128: m64n128k16
// products, two blocks an SM, one's epilogue overlapping the other's loop;
// 256: m64n256k16, one block an SM) and a ring of kStages stages.
template <int kBN, int kStages>
struct Tile {
  static constexpr int kBBytes = kBK * kBN * 2;  // b tile: kBN / 64 boxes
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSmem = kStages * kStageBytes + 1024;  // + slack to align to 1 KB
  static constexpr int kBlocksPerSm = kBN == 128 ? 2 : 1;
};

struct Args {
  const void* bias;      // may be null
  const void* residual;  // may be null
  int m, n, k, act;
  bool vec;  // bias and residual 4-byte aligned: pairs load at once
};

using namespace hopper;

// The epilogue's activation on the bf16 route, with the hardware's
// approximate exp and tanh: their errors (about 1e-7 and 5e-4 relative)
// lie below bf16's rounding of the result (2e-3).
__device__ __forceinline__ float activate_bf16(float x, int act) {
  switch (act) {
    case kRelu:
      return fmaxf(x, 0.f);
    case kGelu: {  // jax.nn.gelu(approximate=True)
      float th;
      const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
      asm("tanh.approx.f32 %0, %1;" : "=f"(th) : "f"(u));
      return 0.5f * x * (1.f + th);
    }
    case kSilu:
      return __fdividef(x, 1.f + __expf(-x));
    default:
      return x;
  }
}

// One block: a 128 x kBN output tile.  Blocks are numbered down groups of
// kGroupM row tiles, column by column, so the blocks in flight share a few
// row and column tiles of a and b in L2.
template <int kBN, int kStages>
__global__ void __launch_bounds__(kThreads, (Tile<kBN, kStages>::kBlocksPerSm))
matmul_fused_kernel_wgmma(const __grid_constant__ CUtensorMap map_a,
                          const __grid_constant__ CUtensorMap map_b,
                          const __grid_constant__ CUtensorMap map_out, const Args p) {
  constexpr int kStageBytes = Tile<kBN, kStages>::kStageBytes;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];   // the stage's loads landed
  __shared__ __align__(8) uint64_t empty[kStages];  // both consumers are done with it
  // 128-byte swizzle repeats every 1 KB: the ring starts on a 1 KB boundary
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int w = threadIdx.x / 128;  // consumer warpgroup, or kConsumers: the producer
  const int tiles_m = (p.m + kBM - 1) / kBM;
  const int tiles_n = (p.n + kBN - 1) / kBN;
  const int per_group = kGroupM * tiles_n;
  const int first_m = static_cast<int>(blockIdx.x) / per_group * kGroupM;
  const int rows = min(tiles_m - first_m, kGroupM);
  const int in_group = static_cast<int>(blockIdx.x) % per_group;
  const int m0 = (first_m + in_group % rows) * kBM;
  const int n0 = in_group / rows * kBN;
  const int k_tiles = (p.k + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (w == kConsumers) {  // the producer warp: one thread keeps the ring full
    if (threadIdx.x == 128 * kConsumers) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % kStages;
        mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);  // the first round passes
        uint8_t* sa = ring + s * kStageBytes;
        uint8_t* sb = sa + kABytes;
        mbar_expect_tx(&full[s], kStageBytes);
        tma_load(sa, &map_a, &full[s], kt * kBK, m0);
#pragma unroll
        for (int box = 0; box < kBN / 64; ++box)
          tma_load(sb + box * kBBox, &map_b, &full[s], n0 + box * 64, kt * kBK);
      }
    }
    return;
  }

  // a consumer: rows m0 + w*64 .. + 63 of the tile
  float acc[kBN / 2];  // the warpgroup's 64 x kBN
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % kStages;
    mbar_wait(&full[s], (kt / kStages) & 1);
    const uint32_t sa = smem_u32(ring + s * kStageBytes) + w * 64 * 128;
    const uint32_t sb = smem_u32(ring + s * kStageBytes + kABytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // a: 16 k = 32 bytes along the swizzled 128-byte rows, 8-row groups
      // 1 KB apart; b: 16 k rows = 2 KB on, 8-row groups 1 KB apart
      // (stride), 64-column boxes kBBox apart (leading); m64n128k16 or
      // m64n256k16 by the size of acc
      wgmma_bf16(acc, desc_sw128(sa + kk * 32, 16, 1024),
                 desc_sw128(sb + kk * 16 * 128, kBBox, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the products of stage kt-1 are done: free it
    if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(kt - 1) % kStages]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");

  // Both consumers are past their last wgmma: the ring is free.  Each
  // warpgroup writes its 64 x kBN bf16 results into kBN / 8 KB of it, as
  // kBN / 64 boxes of 64 x 64 in the 128-byte swizzle (a warp's 8 rows of 16 bytes fall
  // on 8 different bank groups), and one thread stores them with TMA,
  // which drops what lies past M or N.
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
  uint8_t* tile = ring + w * (kBN / 64) * kBBox;
  // the fragment: thread t holds rows 16*(t/32) + (t%32)/4 (+ 8) and column
  // pairs 8*j + 2*(t%4) of the warpgroup's 64 x kBN
  const __nv_bfloat16* bias = static_cast<const __nv_bfloat16*>(p.bias);
  const __nv_bfloat16* res = static_cast<const __nv_bfloat16*>(p.residual);
  const int t = threadIdx.x % 128;
  const int r0 = (t / 32) * 16 + (t % 32) / 4;
  const int64_t row0 = m0 + w * 64 + r0;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int cl = j * 8 + (t % 4) * 2;  // column in the tile
    const int64_t col = n0 + cl;
    const bool col_ok = col < p.n;       // N % 8 == 0: col + 1 lies in bounds too
    float e0 = 0.f, e1 = 0.f;
    if (bias != nullptr && col_ok) {
      if (p.vec) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col));
        e0 = f.x;
        e1 = f.y;
      } else {
        e0 = __bfloat162float(bias[col]);
        e1 = __bfloat162float(bias[col + 1]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + h * 8;  // row in the warpgroup's 64
      const int64_t row = row0 + h * 8;
      float v0 = acc[j * 4 + h * 2], v1 = acc[j * 4 + h * 2 + 1];
      if (bias != nullptr) {
        v0 = __fadd_rn(v0, e0);
        v1 = __fadd_rn(v1, e1);
      }
      if (res != nullptr && col_ok && row < p.m) {
        const __nv_bfloat16* rp = res + row * p.n + col;
        if (p.vec) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(rp));
          v0 = __fadd_rn(v0, f.x);
          v1 = __fadd_rn(v1, f.y);
        } else {
          v0 = __fadd_rn(v0, __bfloat162float(rp[0]));
          v1 = __fadd_rn(v1, __bfloat162float(rp[1]));
        }
      }
      const int cb = cl % 64;  // column in its box
      const int at = (cl / 64) * kBBox + r * 128 + (((cb / 8) ^ (r % 8)) * 16) + (cb % 8) * 2;
      *reinterpret_cast<__nv_bfloat162*>(tile + at) =
          __floats2bfloat162_rn(activate_bf16(v0, p.act), activate_bf16(v1, p.act));
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to TMA
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + w) : "memory");
  if (t == 0) {
#pragma unroll
    for (int box = 0; box < kBN / 64; ++box)
      tma_store(&map_out, tile + box * kBBox, n0 + box * 64, m0 + w * 64);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // before the ring is freed
  }
}

}  // namespace wg

bool aligned(const void* ptr, uintptr_t bytes) {
  return ptr == nullptr || (reinterpret_cast<uintptr_t>(ptr) % bytes) == 0;
}

}  // namespace

// act: 0 none, 1 relu, 2 gelu (tanh), 3 silu.  dtype: 0 = f32, 1 = bf16 for
// a, b, bias, residual and out alike.  bm x bn: the block's output tile, 64
// or 128 each (a plan of kernels/matmul_fused.MatmulPlan), or 0 x 0 for the
// default rule.  Returns a cudaError_t (0 on success).
extern "C" int repro_matmul_fused(const void* a, const void* b, const void* bias,
                                  const void* residual, void* out, int m, int n, int k, int act,
                                  int dtype, int bm, int bn, void* stream) {
  if (m <= 0 || n <= 0 || k < 0 || act < kNone || act > kSilu || (m + 63) / 64 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t quad = dtype == 0 ? 16 : 8;  // bytes of four elements
  MmArgs p{a, b, bias, residual, out, m, n, k, act, false, false};
  p.vec_a = k % 4 == 0 && aligned(a, quad);
  p.vec_n = n % 4 == 0 && aligned(b, quad) && aligned(bias, quad) && aligned(residual, quad) &&
            aligned(out, quad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, bm, bn, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, bm, bn, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

namespace {

template <int kBN, int kStages>
int launch_wgmma(const CUtensorMap& map_a, const CUtensorMap& map_b, const CUtensorMap& map_out,
                 const wg::Args& p, cudaStream_t stream) {
  constexpr int kSmem = wg::Tile<kBN, kStages>::kSmem;
  // per call: the attribute belongs to the current device
  const cudaError_t err = cudaFuncSetAttribute(wg::matmul_fused_kernel_wgmma<kBN, kStages>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks =
      static_cast<int64_t>((p.m + wg::kBM - 1) / wg::kBM) * ((p.n + kBN - 1) / kBN);
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  wg::matmul_fused_kernel_wgmma<kBN, kStages>
      <<<static_cast<unsigned>(blocks), wg::kThreads, kSmem, stream>>>(map_a, map_b, map_out, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bf16 route: a (M,K), b (K,N), bias (N,) or null, residual (M,N) or
// null, out (M,N), all bf16, with K and N positive multiples of 8 and a, b,
// out 16-byte aligned (kernels/matmul_fused.route).  act as above.  bn x
// stages: the block's output columns (128 or 256) and the ring's stages (2,
// 3 or 4), a plan of kernels/matmul_fused.MatmulPlan, or 0 x 0 for the
// default, 128 x 3.  Returns a cudaError_t: cudaErrorInvalidValue for
// arguments off that rule or a tensor map cuTensorMapEncodeTiled refuses,
// cudaErrorNotSupported when libcuda has no cuTensorMapEncodeTiled.
extern "C" int repro_matmul_fused_wgmma(const void* a, const void* b, const void* bias,
                                        const void* residual, void* out, int m, int n, int k,
                                        int act, int bn, int stages, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 8 || n % 8 || act < kNone || act > kSilu ||
      !aligned(a, 16) || !aligned(b, 16) || !aligned(out, 16) || a == nullptr || b == nullptr ||
      out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bn == 0 && stages == 0) {
    bn = 128;
    stages = 3;
  }
  const wg::EncodeTiled fn = wg::encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map_a, map_b, map_out;
  if (!wg::encode(fn, &map_a, a, m, k, wg::kBM, wg::kBK) ||
      !wg::encode(fn, &map_b, b, k, n, wg::kBK, 64) ||
      !wg::encode(fn, &map_out, out, m, n, 64, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  wg::Args p{bias, residual, m, n, k, act, aligned(bias, 4) && aligned(residual, 4)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 128 && stages == 2) return launch_wgmma<128, 2>(map_a, map_b, map_out, p, s);
  if (bn == 128 && stages == 3) return launch_wgmma<128, 3>(map_a, map_b, map_out, p, s);
  if (bn == 128 && stages == 4) return launch_wgmma<128, 4>(map_a, map_b, map_out, p, s);
  if (bn == 256 && stages == 2) return launch_wgmma<256, 2>(map_a, map_b, map_out, p, s);
  if (bn == 256 && stages == 3) return launch_wgmma<256, 3>(map_a, map_b, map_out, p, s);
  if (bn == 256 && stages == 4) return launch_wgmma<256, 4>(map_a, map_b, map_out, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
