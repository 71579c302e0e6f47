// K8' on Hopper: the backward of K8, the depthwise causal conv1d of the
// Mamba mixer.
//
// Replaces no Pallas kernel: the reference's K8 (repro/kernels/
// conv1d_causal.py:conv1d_causal) has no custom_vjp, and its training step
// differentiates repro/kernels/ref.py:conv1d_causal with XLA's autodiff.
// This computes that gradient.  With
//   z[b, t, d] = bias[d] + sum_i w[i, d] * x[b, t - KW + 1 + i, d]
// (x read as zero before t = 0) and y = act(z), given dy:
//   dz[t]   = dy[t] * silu'(z[t])   (dy[t] when act is none)
//   dx[t]   = sum_i w[i] * dz[t + KW - 1 - i]     over t + KW - 1 - i < L
//   dw[i]   = sum_{b,t} x[t - KW + 1 + i] * dz[t]
//   db      = sum_{b,t} dz[t]
// with x (B,L,D) (rows may be strided, channels contiguous), w (KW,D),
// bias (D,) or none, dy and dx (B,L,D) contiguous, dw (KW,D) and db (D,),
// all of one dtype (f32 or bf16); every sum in f32, each output rounded
// once.  Built with nvcc for sm_90a and bound through the plain C function
// at the bottom (ctypes; see repro_torch/kernels/_build.py).
//
// What bounds it: a few multiply-adds per element against one read of x and
// dy and one write of dx, so HBM bandwidth (3 * B*L*D * bytes / 3.35 TB/s;
// dw and db are KW + 1 rows of D).
//
// Design: two kernels, no atomics, so two calls give the same bits.
//   * conv1d_causal_bwd_kernel: a thread owns VEC channels (4: 8 bytes of
//     bf16 or 16 of f32; 1 for rows off that alignment) and walks a run of
//     `run` tokens of one sequence, coalesced along D.  It walks the
//     positions s of the run and the KW - 1 after it, keeping the last KW
//     inputs and the last KW values of dz in registers: at each s it
//     recomputes z[s] from the window (the forward's sum, in its order),
//     forms dz[s], adds x-window * dz[s] into its dw and db sums (s inside
//     the run), and writes dx[s - KW + 1] from the dz window.  So x and dy
//     are read once, plus KW - 1 halo rows on each side of a run.
//   * The run's dw and db sums go to an f32 partial (runs, KW + 1, D);
//     conv1d_causal_bwd_sum_kernel adds each channel's partials in run
//     order and rounds them to w's dtype.
// Offsets are 64-bit.
//
// The "tile" route (conv1d_causal_bwd_kernel_tile), where every row of x,
// w, bias and dy starts on a 16-byte boundary (kernels/conv1d_causal
// .route_bwd, the forward's tile rule).  Same function, same order of each
// sum within a thread.  The kernel above reached 34 % of its bytes bound at
// the cut's shape (B 2, L 512, D 16384, KW 4, bf16): a thread had one 8-byte
// load in flight, and its runs of 32 tokens wrote an f32 partial of 10.5
// MB that the second pass read back (21 MB against the 100 MB the bound
// counts).  So:
//   * A block is 32 threads along D (16 bytes of channels each: a warp
//     reads 512 contiguous bytes of a row) by `warps` warps along L; warp y
//     walks its own sub-run of `sub` tokens of the block's run (warps x
//     sub tokens), so the card holds many short walks while the partial
//     has one row a block and run.  Each thread streams the x rows (with
//     the KW - 1 halo rows on each side) and the dy rows of its walk
//     through a ring of kBwdTileStages stages of kBwdTileRows rows in shared
//     memory by 16-byte cp.async (zero-filled outside [0, L) and for the dy
//     rows before the walk), so up to (kBwdTileStages - 1) x kBwdTileRows
//     rows of each are in flight a thread; a thread reads back only what it
//     copied, so the ring needs no barrier.
//   * z is recomputed from the window in the forward's order; SiLU' takes
//     __expf and rcp.approx (the forward's tile route); dx is written as
//     packed bf16, 16 bytes a thread.
//   * At the end the warps' dw and db sums meet in shared memory and are
//     added in warp order (a fixed order) into the block's partial row;
//     conv1d_causal_bwd_sum_kernel adds the rows in run order as above.
//   Sub-runs and warps come from kernels/conv1d_causal.bwd_tile_plan.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv1d_tile.cuh"  // 16-byte cp.async staging, bf16 packing, rcp.approx

namespace {

constexpr int kThreads = 128;
constexpr int kMaxTaps = 8;
constexpr int kSumThreads = 256;

enum Act { kNone = 0, kSilu = 1 };

struct BwdArgs {
  const void* x;
  const void* w;
  const void* bias;  // may be null
  const void* dy;
  void* dx;
  float* part;  // (b * ceil(l / run), KW + 1, D): dw rows, then db
  int64_t x_batch_stride, x_row_stride;  // elements
  int b, l, d, run, act;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float& out) { out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16& out) { out = __float2bfloat16(v); }

// N values of T at p, widened to f32: one 16- or 8-byte load when N values
// fill it (the caller guarantees the alignment), else N scalar loads.
template <typename T, int N>
__device__ __forceinline__ void load(const T* p, float (&v)[N]) {
  if constexpr (N * sizeof(T) == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = to_f32(e[j]);
  } else if constexpr (N * sizeof(T) == 8) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = to_f32(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = to_f32(p[j]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store(T* p, const float (&v)[N]) {
  if constexpr (N * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) from_f32(v[j], e[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else if constexpr (N * sizeof(T) == 8) {
    uint2 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) from_f32(v[j], e[j]);
    *reinterpret_cast<uint2*>(p) = raw;
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) from_f32(v[j], p[j]);
  }
}

template <int N>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) p[j] = v[j];
  }
}

// grid (ceil(D / (128 * VEC)), ceil(L / run), B); D % VEC == 0.
template <typename T, int VEC, int KW>
__global__ void __launch_bounds__(kThreads)
conv1d_causal_bwd_kernel(const BwdArgs a) {
  const int64_t c0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * VEC;
  if (c0 >= a.d) return;
  const int l0 = blockIdx.y * a.run;
  const int l1 = min(l0 + a.run, a.l);
  const T* x = static_cast<const T*>(a.x) + blockIdx.z * a.x_batch_stride + c0;
  const int64_t plane = static_cast<int64_t>(blockIdx.z) * a.l * a.d + c0;
  const T* dy = static_cast<const T*>(a.dy) + plane;
  T* dx = static_cast<T*>(a.dx) + plane;
  const T* w = static_cast<const T*>(a.w) + c0;

  float wt[KW][VEC];
#pragma unroll
  for (int i = 0; i < KW; ++i) load<T, VEC>(w + static_cast<int64_t>(i) * a.d, wt[i]);
  float bias[VEC];
  if (a.bias != nullptr) {
    load<T, VEC>(static_cast<const T*>(a.bias) + c0, bias);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) bias[j] = 0.f;
  }

  // xw[i] holds x[s - KW + 1 + i], dzw[i] holds dz[s - KW + 1 + i]; entry
  // KW - 1 is filled each step, then both shift by one.
  float xw[KW][VEC], dzw[KW][VEC], dw[KW][VEC], db[VEC];
#pragma unroll
  for (int i = 0; i < KW; ++i)
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      xw[i][j] = 0.f;
      dzw[i][j] = 0.f;
      dw[i][j] = 0.f;
    }
#pragma unroll
  for (int j = 0; j < VEC; ++j) db[j] = 0.f;
#pragma unroll
  for (int i = 0; i < KW - 1; ++i) {
    const int t = l0 - (KW - 1) + i;
    if (t >= 0) load<T, VEC>(x + t * a.x_row_stride, xw[i]);
  }

  const int s_end = l1 + KW - 1;
  for (int s = l0; s < s_end; ++s) {
    float g[VEC];
    if (s < a.l) {
      load<T, VEC>(x + s * a.x_row_stride, xw[KW - 1]);
      load<T, VEC>(dy + static_cast<int64_t>(s) * a.d, g);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        xw[KW - 1][j] = 0.f;
        g[j] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float dz = g[j];
      if (a.act == kSilu) {
        float z = 0.f;
#pragma unroll
        for (int i = 0; i < KW; ++i) z += xw[i][j] * wt[i][j];
        z += bias[j];
        const float sg = 1.f / (1.f + expf(-z));
        dz = g[j] * (sg * (1.f + z * (1.f - sg)));
      }
      dzw[KW - 1][j] = dz;
    }
    if (s < l1) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
#pragma unroll
        for (int i = 0; i < KW; ++i) dw[i][j] += xw[i][j] * dzw[KW - 1][j];
        db[j] += dzw[KW - 1][j];
      }
    }
    const int t = s - (KW - 1);
    if (t >= l0) {
      float out[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < KW; ++i) acc += wt[i][j] * dzw[KW - 1 - i][j];
        out[j] = acc;
      }
      store<T, VEC>(dx + static_cast<int64_t>(t) * a.d, out);
    }
#pragma unroll
    for (int i = 0; i < KW - 1; ++i)
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        xw[i][j] = xw[i + 1][j];
        dzw[i][j] = dzw[i + 1][j];
      }
  }

  // this run's sums: partial row p, KW dw rows then db
  const int64_t p = static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  float* part = a.part + p * (KW + 1) * a.d + c0;
#pragma unroll
  for (int i = 0; i < KW; ++i) store_f32<VEC>(part + static_cast<int64_t>(i) * a.d, dw[i]);
  store_f32<VEC>(part + static_cast<int64_t>(KW) * a.d, db);
}

// One thread per (row, channel) of dw and db ((KW + 1) * D, or KW * D
// without a bias): the sum of the `parts` partials in run order, rounded to
// T.  grid ceil(rows * D / 256).
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
conv1d_causal_bwd_sum_kernel(const float* part, T* dw, T* db, int kw, int d, int parts) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kSumThreads + threadIdx.x;
  const int rows = kw + (db != nullptr ? 1 : 0);
  if (idx >= static_cast<int64_t>(rows) * d) return;
  const int64_t stride = static_cast<int64_t>(kw + 1) * d;
  float sum = 0.f;
  for (int p = 0; p < parts; ++p) sum += part[p * stride + idx];
  T out;
  from_f32(sum, out);
  if (idx < static_cast<int64_t>(kw) * d) {
    dw[idx] = out;
  } else {
    db[idx - static_cast<int64_t>(kw) * d] = out;
  }
}

// ---- the "tile" route --------------------------------------------------------

constexpr int kBwdTileThreads = 32;  // threads along D a block: one warp
constexpr int kBwdTileRows = 4;      // rows of one ring stage
constexpr int kBwdTileStages = 3;    // ring stages

// grid (ceil(D / (32 * VEC)), ceil(L / (warps * sub)), B), block (32,
// warps); VEC = 16 / sizeof(T); dynamic shared memory the larger of the
// ring, kBwdTileStages * kBwdTileRows * 2 * 32 * warps * 16 bytes, and the
// warps' sums, warps * (KW + 1) * 32 * VEC * 4 bytes.
template <typename T, int KW>
__global__ void __launch_bounds__(256)
conv1d_causal_bwd_kernel_tile(const BwdArgs a, int sub) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) uint4 ring[];
  const int tx = threadIdx.x, warp = threadIdx.y, warps = blockDim.y;
  const int nthreads = kBwdTileThreads * warps;
  const int tid = warp * kBwdTileThreads + tx;
  const int64_t c0 = (static_cast<int64_t>(blockIdx.x) * kBwdTileThreads + tx) * VEC;
  const bool live = c0 < a.d;
  const int l0 = (blockIdx.y * warps + warp) * sub;  // this warp's walk
  const int l1 = min(l0 + sub, a.l);
  const T* x = static_cast<const T*>(a.x) + blockIdx.z * a.x_batch_stride + (live ? c0 : 0);
  const int64_t plane = static_cast<int64_t>(blockIdx.z) * a.l * a.d + (live ? c0 : 0);
  const T* dy = static_cast<const T*>(a.dy) + plane;
  T* dx = static_cast<T*>(a.dx) + plane;

  float wt[KW][VEC], bias[VEC];
#pragma unroll
  for (int i = 0; i < KW; ++i) {
    if (live) {
      unpack(__ldg(reinterpret_cast<const uint4*>(static_cast<const T*>(a.w) +
                                                  static_cast<int64_t>(i) * a.d + c0)),
             wt[i]);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) wt[i][v] = 0.f;
    }
  }
  if (live && a.bias != nullptr) {
    unpack(__ldg(reinterpret_cast<const uint4*>(static_cast<const T*>(a.bias) + c0)), bias);
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) bias[v] = 0.f;
  }

  // Row j of the walk is token first + j: KW - 1 halo rows, the sub-run,
  // KW - 1 halo rows; x for every row, dy from row KW - 1 on (token l0).
  const int first = l0 - (KW - 1);
  const int rows = l1 > l0 ? l1 + (KW - 1) - first : 0;
  const int stages = (rows + kBwdTileRows - 1) / kBwdTileRows;
  uint4* mine = ring + tid;
  auto slot = [&](int st, int r, int which) {  // which: 0 x, 1 dy
    return mine + ((st % kBwdTileStages) * kBwdTileRows * 2 + r * 2 + which) * nthreads;
  };
  auto load_stage = [&](int st) {
#pragma unroll
    for (int r = 0; r < kBwdTileRows; ++r) {
      const int j = st * kBwdTileRows + r;
      const int t = first + j;
      const bool in = live && j < rows && t >= 0 && t < a.l;
      cp_async16(slot(st, r, 0), in ? x + static_cast<int64_t>(t) * a.x_row_stride : x,
                 in ? 16 : 0);
      const bool in_dy = in && j >= KW - 1;
      cp_async16(slot(st, r, 1), in_dy ? dy + static_cast<int64_t>(t) * a.d : dy,
                 in_dy ? 16 : 0);
    }
  };
#pragma unroll
  for (int st = 0; st < kBwdTileStages - 1; ++st) {
    if (st < stages) load_stage(st);
    cp_async_commit();
  }

  // xw[i] holds x[s - KW + 1 + i], dzw[i] holds dz[s - KW + 1 + i]; entry
  // KW - 1 is filled each step, then both shift by one.
  float xw[KW][VEC], dzw[KW][VEC], dw[KW][VEC], db[VEC];
#pragma unroll
  for (int i = 0; i < KW; ++i)
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      xw[i][v] = 0.f;
      dzw[i][v] = 0.f;
      dw[i][v] = 0.f;
    }
#pragma unroll
  for (int v = 0; v < VEC; ++v) db[v] = 0.f;
  for (int st = 0; st < stages; ++st) {
    cp_async_wait<kBwdTileStages - 2>();  // stage st has landed
    if (st + kBwdTileStages - 1 < stages) load_stage(st + kBwdTileStages - 1);
    cp_async_commit();
#pragma unroll
    for (int r = 0; r < kBwdTileRows; ++r) {
      const int j = st * kBwdTileRows + r;
      if (j >= rows) break;
#pragma unroll
      for (int i = 0; i < KW - 1; ++i)
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          xw[i][v] = xw[i + 1][v];
          dzw[i][v] = dzw[i + 1][v];
        }
      unpack(*slot(st, r, 0), xw[KW - 1]);
      if (j < KW - 1) continue;  // a halo row before the walk
      const int s = first + j;
      float g[VEC];
      unpack(*slot(st, r, 1), g);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float dz = g[v];
        if (a.act == kSilu) {
          float z = 0.f;
#pragma unroll
          for (int i = 0; i < KW; ++i) z += xw[i][v] * wt[i][v];
          z += bias[v];
          const float sg = rcp_approx(1.f + __expf(-z));
          dz = g[v] * (sg * (1.f + z * (1.f - sg)));
        }
        dzw[KW - 1][v] = dz;
      }
      if (s < l1) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
#pragma unroll
          for (int i = 0; i < KW; ++i) dw[i][v] += xw[i][v] * dzw[KW - 1][v];
          db[v] += dzw[KW - 1][v];
        }
      }
      const int t = s - (KW - 1);
      if (t >= l0 && live) {
        float out[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          float acc = 0.f;
#pragma unroll
          for (int i = 0; i < KW; ++i) acc += wt[i][v] * dzw[KW - 1 - i][v];
          out[v] = acc;
        }
        *reinterpret_cast<uint4*>(dx + static_cast<int64_t>(t) * a.d) = pack(out);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread is done with the ring

  // the warps' sums in shared memory: (warp, row of KW + 1, column of
  // 32 * VEC), then added in warp order into the block's partial row
  constexpr int kCols = kBwdTileThreads * VEC;
  float* sums = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int i = 0; i <= KW; ++i)
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      sums[(warp * (KW + 1) + i) * kCols + tx * VEC + v] = i < KW ? dw[i][v] : db[v];
  __syncthreads();
  const int64_t p = static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kCols;
  for (int k = tid; k < (KW + 1) * kCols; k += nthreads) {
    const int i = k / kCols, col = k % kCols;
    if (col0 + col >= a.d) continue;
    float sum = 0.f;
    for (int y = 0; y < warps; ++y) sum += sums[(y * (KW + 1) + i) * kCols + col];
    a.part[(p * (KW + 1) + i) * a.d + col0 + col] = sum;
  }
}

template <typename T, int KW>
int launch_tile_taps(const BwdArgs& a, int sub, int warps, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t threads_d = (a.d + kVec - 1) / kVec;
  const dim3 grid(static_cast<unsigned>((threads_d + kBwdTileThreads - 1) / kBwdTileThreads),
                  static_cast<unsigned>((a.l + sub * warps - 1) / (sub * warps)),
                  static_cast<unsigned>(a.b));
  const int ring = kBwdTileStages * kBwdTileRows * 2 * kBwdTileThreads * warps * 16;
  const int sums = warps * (KW + 1) * kBwdTileThreads * kVec * 4;
  const int smem = ring > sums ? ring : sums;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv1d_causal_bwd_kernel_tile<T, KW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  conv1d_causal_bwd_kernel_tile<T, KW><<<grid, dim3(kBwdTileThreads, warps), smem, s>>>(a, sub);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tile(const BwdArgs& a, int kw, int sub, int warps, cudaStream_t s) {
  switch (kw) {
    case 1: return launch_tile_taps<T, 1>(a, sub, warps, s);
    case 2: return launch_tile_taps<T, 2>(a, sub, warps, s);
    case 3: return launch_tile_taps<T, 3>(a, sub, warps, s);
    case 4: return launch_tile_taps<T, 4>(a, sub, warps, s);
    case 5: return launch_tile_taps<T, 5>(a, sub, warps, s);
    case 6: return launch_tile_taps<T, 6>(a, sub, warps, s);
    case 7: return launch_tile_taps<T, 7>(a, sub, warps, s);
    case 8: return launch_tile_taps<T, 8>(a, sub, warps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_sum(const BwdArgs& a, int kw, int parts, void* dw, void* db, cudaStream_t s) {
  const int64_t outs = static_cast<int64_t>(kw + (a.bias != nullptr ? 1 : 0)) * a.d;
  conv1d_causal_bwd_sum_kernel<T><<<static_cast<unsigned>((outs + kSumThreads - 1) / kSumThreads),
                                    kSumThreads, 0, s>>>(
      a.part, static_cast<T*>(dw), a.bias != nullptr ? static_cast<T*>(db) : nullptr, kw, a.d,
      parts);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC, int KW>
int launch_taps(const BwdArgs& a, cudaStream_t s) {
  const int64_t threads_d = (a.d + VEC - 1) / VEC;
  const dim3 grid(static_cast<unsigned>((threads_d + kThreads - 1) / kThreads),
                  static_cast<unsigned>((a.l + a.run - 1) / a.run), static_cast<unsigned>(a.b));
  conv1d_causal_bwd_kernel<T, VEC, KW><<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_vec(const BwdArgs& a, int kw, cudaStream_t s) {
  switch (kw) {
    case 1: return launch_taps<T, VEC, 1>(a, s);
    case 2: return launch_taps<T, VEC, 2>(a, s);
    case 3: return launch_taps<T, VEC, 3>(a, s);
    case 4: return launch_taps<T, VEC, 4>(a, s);
    case 5: return launch_taps<T, VEC, 5>(a, s);
    case 6: return launch_taps<T, VEC, 6>(a, s);
    case 7: return launch_taps<T, VEC, 7>(a, s);
    case 8: return launch_taps<T, VEC, 8>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T>
int launch(const BwdArgs& a, int kw, bool vec, void* dw, void* db, cudaStream_t s) {
  constexpr int kVec = 4;
  constexpr int kBytes = kVec * static_cast<int>(sizeof(T));
  if (vec && (a.d % kVec || a.x_row_stride % kVec || a.x_batch_stride % kVec ||
              !aligned(a.x, kBytes) || !aligned(a.w, kBytes) || !aligned(a.bias, kBytes) ||
              !aligned(a.dy, kBytes) || !aligned(a.dx, kBytes) || !aligned(a.part, 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = vec ? launch_vec<T, kVec>(a, kw, s) : launch_vec<T, 1>(a, kw, s);
  if (err != 0) return err;
  return launch_sum<T>(a, kw, a.b * ((a.l + a.run - 1) / a.run), dw, db, s);
}

}  // namespace

// x: (B,L,D) with channel stride 1, batch and row strides in elements; w
// (KW,D), bias (D,) or null; dy, dx (B,L,D) contiguous; dw (KW,D) and db
// (D,) (null without a bias); part: an f32 scratch (B * ceil(L / run),
// KW + 1, D), 16-byte aligned.  run: tokens per thread; act: 0 none, 1
// silu; vec: 1 for the route of 4 channels a thread (D and both strides
// multiples of 4, x, w, bias, dy and dx aligned to 4 elements), 0 for one
// channel a thread; dtype: 0 = f32, 1 = bf16 for every tensor but part.
// Launches both kernels on `stream` without synchronising; returns a
// cudaError_t (0 on success).
extern "C" int repro_conv1d_causal_bwd(const void* x, const void* w, const void* bias,
                                       const void* dy, void* dx, void* dw, void* db, float* part,
                                       long long x_batch_stride, long long x_row_stride, int b,
                                       int l, int d, int kw, int run, int act, int vec, int dtype,
                                       void* stream) {
  if (b <= 0 || l <= 0 || d <= 0 || run <= 0 || kw < 1 || kw > kMaxTaps || act < kNone ||
      act > kSilu || b > 65535 || (l + run - 1) / run > 65535 || x == nullptr || w == nullptr ||
      dy == nullptr || dx == nullptr || dw == nullptr || part == nullptr ||
      (bias != nullptr && db == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{x, w, bias, dy, dx, part, x_batch_stride, x_row_stride, b, l, d, run, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, kw, vec != 0, dw, db, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, kw, vec != 0, dw, db, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The "tile" route: as repro_conv1d_causal_bwd, for rows that start on
// 16-byte boundaries (x, w, bias and dy 16-byte aligned, D and both of x's
// strides multiples of 16 bytes; dx and part 16-byte aligned); part is
// (B * ceil(L / (warps * sub)), KW + 1, D).  sub: tokens a warp walks;
// warps: warps a block along L (1 to 8), from kernels/conv1d_causal
// .bwd_tile_plan.  Launches the tile kernel and the sum kernel on `stream`
// without synchronising; returns a cudaError_t (0 on success).
extern "C" int repro_conv1d_causal_bwd_tile(const void* x, const void* w, const void* bias,
                                            const void* dy, void* dx, void* dw, void* db,
                                            float* part, long long x_batch_stride,
                                            long long x_row_stride, int b, int l, int d, int kw,
                                            int sub, int warps, int act, int dtype,
                                            void* stream) {
  const int vec = dtype == 0 ? 4 : 8;
  if (b <= 0 || l <= 0 || d <= 0 || sub <= 0 || warps < 1 || warps > 8 || kw < 1 ||
      kw > kMaxTaps || act < kNone || act > kSilu || b > 65535 ||
      (l + sub * warps - 1) / (sub * warps) > 65535 || x == nullptr || w == nullptr ||
      dy == nullptr || dx == nullptr || dw == nullptr || part == nullptr ||
      (bias != nullptr && db == nullptr) || d % vec || x_batch_stride % vec ||
      x_row_stride % vec || !aligned(x, 16) || !aligned(w, 16) || !aligned(bias, 16) ||
      !aligned(dy, 16) || !aligned(dx, 16) || !aligned(part, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{x, w, bias, dy, dx, part, x_batch_stride, x_row_stride, b, l, d, sub, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int parts = b * ((l + sub * warps - 1) / (sub * warps));
  int err;
  if (dtype == 0) {
    err = launch_tile<float>(a, kw, sub, warps, s);
    return err != 0 ? err : launch_sum<float>(a, kw, parts, dw, db, s);
  }
  if (dtype == 1) {
    err = launch_tile<__nv_bfloat16>(a, kw, sub, warps, s);
    return err != 0 ? err : launch_sum<__nv_bfloat16>(a, kw, parts, dw, db, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
