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
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
  const int parts = a.b * ((a.l + a.run - 1) / a.run);
  const int64_t outs = static_cast<int64_t>(kw + (a.bias != nullptr ? 1 : 0)) * a.d;
  conv1d_causal_bwd_sum_kernel<T><<<static_cast<unsigned>((outs + kSumThreads - 1) / kSumThreads),
                                    kSumThreads, 0, s>>>(
      a.part, static_cast<T*>(dw), a.bias != nullptr ? static_cast<T*>(db) : nullptr, kw, a.d,
      parts);
  return static_cast<int>(cudaGetLastError());
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
