// K8 on Hopper: depthwise causal conv1d, the Mamba mixer's short convolution.
//
// Replaces the Pallas kernel repro/kernels/conv1d_causal.py:conv1d_causal
// (_kernel).  Same function:
//   y[b, l, d] = act(bias[d] + sum_i x[b, l - KW + 1 + i, d] * w[i, d])
// with x (B,L,D) (rows may be strided, channels contiguous), w (KW,D),
// bias (D,) or none, y (B,L,D) contiguous, all of one dtype (f32 or bf16),
// f32 accumulation, x read as zero before l = 0, act in {none, silu}, y in
// x's dtype.  Built with nvcc for sm_90a and bound through the plain C
// function at the bottom (ctypes; see repro_torch/kernels/_build.py).
//
// What bounds it: KW multiply-adds per output against one read of x and one
// write of y, so HBM bandwidth (2 * B*L*D * bytes / 3.35 TB/s).
//
// Design: one pass over x, coalesced along D.
//   * A thread owns VEC channels (16 bytes: 8 bf16 or 4 f32) and walks a
//     run of `run` tokens of one sequence; the 128 threads of a block cover
//     128 * VEC neighbouring channels, so each row load is a whole line.
//   * The last KW - 1 inputs stay in registers (a window shifted one token
//     per step), so every input row is read from HBM once; only the KW - 1
//     rows before a run are read again, from L2, by the next run's threads.
//   * The KW taps and the VEC lanes are unrolled (KW up to 8, a template
//     parameter); the weights and bias sit in registers as f32.
//   * The causal left edge is masked in the kernel (no padded copy of x, the
//     reference's jnp.pad); D and L tails are masked, so any D and L >= 1
//     work.  Where D, the strides or a pointer do not allow 16-byte access,
//     the wrapper asks for the one-channel instance (VEC = 1).
// Offsets are 64-bit.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv1d_tile.cuh"  // 16-byte cp.async staging, bf16 packing, rcp.approx

namespace {

constexpr int kThreads = 128;
constexpr int kMaxTaps = 8;

enum Act { kNone = 0, kSilu = 1 };

struct Conv1dArgs {
  const void* x;
  const void* w;
  const void* bias;  // may be null
  void* y;
  int64_t x_batch_stride, x_row_stride;  // elements
  int b, l, d, run, act;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float& out) { out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16& out) { out = __float2bfloat16(v); }

// N values of T at p, widened to f32; one 16-byte load when N values fill it.
template <typename T, int N>
__device__ __forceinline__ void load(const T* p, float (&v)[N]) {
  if constexpr (N * sizeof(T) == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
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
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) from_f32(v[j], p[j]);
  }
}

// grid (ceil(D / (128 * VEC)), ceil(L / run), B); D % VEC == 0.
template <typename T, int VEC, int KW>
__global__ void __launch_bounds__(kThreads)
conv1d_causal_kernel(const Conv1dArgs a) {
  const int64_t c0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * VEC;
  if (c0 >= a.d) return;
  const int l0 = blockIdx.y * a.run;
  const int l1 = min(l0 + a.run, a.l);
  const T* x = static_cast<const T*>(a.x) + blockIdx.z * a.x_batch_stride + c0;
  T* y = static_cast<T*>(a.y) + static_cast<int64_t>(blockIdx.z) * a.l * a.d + c0;
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

  // win[i] holds token l - KW + 1 + i; win[KW - 1] is loaded each step.
  float win[KW][VEC];
#pragma unroll
  for (int i = 0; i < KW - 1; ++i) {
    const int t = l0 - (KW - 1) + i;
    if (t >= 0) {
      load<T, VEC>(x + t * a.x_row_stride, win[i]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) win[i][j] = 0.f;
    }
  }
#pragma unroll 2
  for (int t = l0; t < l1; ++t) {
    load<T, VEC>(x + t * a.x_row_stride, win[KW - 1]);
    float out[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < KW; ++i) acc += win[i][j] * wt[i][j];
      acc += bias[j];
      if (a.act == kSilu) acc = acc / (1.f + expf(-acc));
      out[j] = acc;
    }
    store<T, VEC>(y + static_cast<int64_t>(t) * a.d, out);
#pragma unroll
    for (int i = 0; i < KW - 1; ++i) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) win[i][j] = win[i + 1][j];
    }
  }
}

template <typename T, int VEC, int KW>
int launch_taps(const Conv1dArgs& a, cudaStream_t s) {
  const int64_t threads_d = (a.d + VEC - 1) / VEC;
  const dim3 grid(static_cast<unsigned>((threads_d + kThreads - 1) / kThreads),
                  static_cast<unsigned>((a.l + a.run - 1) / a.run), static_cast<unsigned>(a.b));
  conv1d_causal_kernel<T, VEC, KW><<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_vec(const Conv1dArgs& a, int kw, cudaStream_t s) {
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

bool aligned(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch(const Conv1dArgs& a, int kw, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = a.d % kVec == 0 && a.x_row_stride % kVec == 0 &&
                   a.x_batch_stride % kVec == 0 && aligned(a.x) && aligned(a.w) &&
                   aligned(a.bias) && aligned(a.y);
  return vec ? launch_vec<T, kVec>(a, kw, s) : launch_vec<T, 1>(a, kw, s);
}

// ---------------------------------------------------------------------------
// The "tile" route: conv1d_causal_kernel_tile.
//
// Replaces the same Pallas kernel (repro/kernels/conv1d_causal.py:_kernel)
// where every row of x starts on a 16-byte boundary (D, both strides and
// every pointer multiples of 16 bytes; the wrapper's route() picks it).
// Same function and f32 accumulation as the kernel above.
//
// What bounds it: the same bytes, 2 * B*L*D * bytes / 3.35 TB/s.  The kernel
// above reached 74-80 % of that bound in f32 but 43-48 % in bf16, where each
// output carries twice the arithmetic per byte (a full expf and an IEEE
// division for SiLU, the bf16 unpacking, the window shifts).  So:
//   * A block's tile is (run + KW - 1) rows by blockDim.x x 16 bytes of
//     channels, with run >= 15 (KW - 1) (kernels/conv1d_causal.py
//     tile_plan), so halo rows are at most 1/16 of the rows read.  Each
//     thread streams its own 16-byte column of the tile through a ring of
//     kTileStages stages of kTileRows rows in shared memory, filled by
//     cp.async (zero-filled before l = 0), so up to (kTileStages - 1) x
//     kTileRows rows a thread are in flight without holding registers.  A
//     thread reads back only what it copied itself, so no barrier is
//     needed.  x's rows may lie any multiple of 16 bytes apart (the
//     mixer's half of its input projection: 32,768 elements).
//   * The window of KW inputs stays in registers as f32, unpacked from
//     bf16 pairs (__bfloat1622float2) and packed back two outputs at a time
//     (__floats2bfloat162_rn); sums in f32 in the order above.
//   * SiLU is x * sigmoid(x) with __expf and rcp.approx: about 5
//     instructions where expf and the IEEE division took over 20.
//   * blockDim.x is 128, 64 or 32: the plan takes the widest block whose
//     grid still reaches two blocks per SM (L 333 at batch 1 takes 32).
constexpr int kTileRows = 8;     // rows of one ring stage
constexpr int kTileStages = 3;   // ring stages

// grid (ceil(D / (blockDim.x * VEC)), ceil(L / run), B); VEC = 16 /
// sizeof(T); dynamic shared memory kTileStages * kTileRows * blockDim.x *
// 16 bytes.
template <typename T, int KW>
__global__ void __launch_bounds__(128)
conv1d_causal_kernel_tile(const Conv1dArgs a) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) uint4 ring[];
  const int64_t c0 = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * VEC;
  if (c0 >= a.d) return;
  const int l0 = blockIdx.y * a.run;
  const int l1 = min(l0 + a.run, a.l);
  const T* x = static_cast<const T*>(a.x) + blockIdx.z * a.x_batch_stride + c0;
  T* y = static_cast<T*>(a.y) + static_cast<int64_t>(blockIdx.z) * a.l * a.d + c0;
  const T* w = static_cast<const T*>(a.w) + c0;

  float wt[KW][VEC];
#pragma unroll
  for (int i = 0; i < KW; ++i)
    unpack(__ldg(reinterpret_cast<const uint4*>(w + static_cast<int64_t>(i) * a.d)), wt[i]);
  float bias[VEC];
  if (a.bias != nullptr) {
    unpack(__ldg(reinterpret_cast<const uint4*>(static_cast<const T*>(a.bias) + c0)), bias);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) bias[j] = 0.f;
  }

  // Row j of the tile is token first + j: KW - 1 halo rows, then the run.
  const int first = l0 - (KW - 1);
  const int rows = l1 - first;
  const int stages = (rows + kTileRows - 1) / kTileRows;
  uint4* mine = ring + threadIdx.x;
  auto load_stage = [&](int st) {
    uint4* slot = mine + (st % kTileStages) * kTileRows * blockDim.x;
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      const int j = st * kTileRows + r;
      const int t = first + j;
      const bool ok = j < rows && t >= 0;
      cp_async16(slot + r * blockDim.x, ok ? x + static_cast<int64_t>(t) * a.x_row_stride : x,
                 ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int st = 0; st < kTileStages - 1; ++st) {
    if (st < stages) load_stage(st);
    cp_async_commit();
  }

  float win[KW][VEC];
#pragma unroll
  for (int i = 0; i < KW; ++i)
#pragma unroll
    for (int j = 0; j < VEC; ++j) win[i][j] = 0.f;
  for (int st = 0; st < stages; ++st) {
    cp_async_wait<kTileStages - 2>();
    if (st + kTileStages - 1 < stages) load_stage(st + kTileStages - 1);
    cp_async_commit();
    const uint4* slot = mine + (st % kTileStages) * kTileRows * blockDim.x;
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      const int j = st * kTileRows + r;
      if (j >= rows) break;
#pragma unroll
      for (int i = 0; i < KW - 1; ++i)
#pragma unroll
        for (int v = 0; v < VEC; ++v) win[i][v] = win[i + 1][v];
      unpack(slot[r * blockDim.x], win[KW - 1]);
      if (j < KW - 1) continue;  // a halo row
      float out[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < KW; ++i) acc += win[i][v] * wt[i][v];
        acc += bias[v];
        if (a.act == kSilu) acc *= rcp_approx(1.f + __expf(-acc));
        out[v] = acc;
      }
      *reinterpret_cast<uint4*>(y + static_cast<int64_t>(first + j) * a.d) = pack(out);
    }
  }
}

template <typename T, int KW>
int launch_tile_taps(const Conv1dArgs& a, int threads, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t threads_d = (a.d + kVec - 1) / kVec;
  const dim3 grid(static_cast<unsigned>((threads_d + threads - 1) / threads),
                  static_cast<unsigned>((a.l + a.run - 1) / a.run), static_cast<unsigned>(a.b));
  const int smem = kTileStages * kTileRows * threads * 16;
  conv1d_causal_kernel_tile<T, KW><<<grid, threads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tile(const Conv1dArgs& a, int kw, int threads, cudaStream_t s) {
  switch (kw) {
    case 1: return launch_tile_taps<T, 1>(a, threads, s);
    case 2: return launch_tile_taps<T, 2>(a, threads, s);
    case 3: return launch_tile_taps<T, 3>(a, threads, s);
    case 4: return launch_tile_taps<T, 4>(a, threads, s);
    case 5: return launch_tile_taps<T, 5>(a, threads, s);
    case 6: return launch_tile_taps<T, 6>(a, threads, s);
    case 7: return launch_tile_taps<T, 7>(a, threads, s);
    case 8: return launch_tile_taps<T, 8>(a, threads, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: (B,L,D) with channel stride 1, batch and row strides in elements;
// w (KW,D), bias (D,) or null, y (B,L,D) contiguous; run: tokens per
// thread.  act: 0 none, 1 silu.  dtype: 0 = f32, 1 = bf16 for every
// tensor.  Returns a cudaError_t (0 on success).
extern "C" int repro_conv1d_causal(const void* x, const void* w, const void* bias, void* y,
                                   long long x_batch_stride, long long x_row_stride, int b,
                                   int l, int d, int kw, int run, int act, int dtype,
                                   void* stream) {
  if (b <= 0 || l <= 0 || d <= 0 || run <= 0 || kw < 1 || kw > kMaxTaps || act < kNone ||
      act > kSilu || b > 65535 || (l + run - 1) / run > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Conv1dArgs a{x, w, bias, y, x_batch_stride, x_row_stride, b, l, d, run, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, kw, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, kw, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tile route: as repro_conv1d_causal, for rows that start on 16-byte
// boundaries (x, w, bias and y 16-byte aligned; D and both strides
// multiples of 16 bytes); run and threads (128, 64 or 32) from
// kernels/conv1d_causal.py tile_plan.  Returns a cudaError_t (0 on
// success).
extern "C" int repro_conv1d_causal_tile(const void* x, const void* w, const void* bias,
                                        void* y, long long x_batch_stride,
                                        long long x_row_stride, int b, int l, int d, int kw,
                                        int run, int threads, int act, int dtype,
                                        void* stream) {
  const int vec = dtype == 0 ? 4 : 8;
  if (b <= 0 || l <= 0 || d <= 0 || run <= 0 || kw < 1 || kw > kMaxTaps || act < kNone ||
      act > kSilu || b > 65535 || (l + run - 1) / run > 65535 ||
      (threads != 32 && threads != 64 && threads != 128) || d % vec ||
      x_batch_stride % vec || x_row_stride % vec || !aligned(x) || !aligned(w) ||
      !aligned(bias) || !aligned(y))
    return static_cast<int>(cudaErrorInvalidValue);
  const Conv1dArgs a{x, w, bias, y, x_batch_stride, x_row_stride, b, l, d, run, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_tile<float>(a, kw, threads, s);
  if (dtype == 1) return launch_tile<__nv_bfloat16>(a, kw, threads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
